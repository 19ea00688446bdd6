"""The plain forward blend of the port (the CPU side of kernel K1) against
the JAX package's rasterizers on the same features and ranges (CPU). The
JAX side runs as the JAX package's own tests run it: the Pallas kernel in
interpret mode, and the jnp rasterizer."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops.binning import bin_gaussians as jax_bin  # noqa: E402
from gsplat_tpu.ops.binning import gather_features as jax_gather  # noqa: E402
from gsplat_tpu.ops.pallas.raster import rasterize_pallas  # noqa: E402
from gsplat_tpu.ops.projection import project_gaussians as jax_project  # noqa: E402
from gsplat_tpu.ops.raster_jnp import rasterize_dense_oracle as jax_oracle  # noqa: E402
from gsplat_tpu.ops.raster_jnp import rasterize_tiles_jnp  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu_torch import RenderConfig, render  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import raster_torch  # noqa: E402
from gsplat_tpu_torch.ops.blend import (  # noqa: E402
    blend_block,
    init_carry,
    tile_pixel_coords,
)
from gsplat_tpu_torch.ops.cuda import raster  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402

KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32)
JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in
          ("means", "log_scales", "quats", "opacity_logits", "sh")),
        device="cpu",
    )
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in
          ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
           "znear")),
        device="cpu",
    )
    return scene, cam


@pytest.fixture(scope="module")
def stream():
    """JAX-binned features and ranges of a 150-Gaussian scene, as numpy."""
    jcfg = JaxConfig(**KW, **JAX_PALLAS)
    jscene = jax_random_scene(jax.random.key(0), 150, sh_degree=2)
    jproj = jax_project(jscene, JaxCamera.default(64, 64), jcfg)
    jb = jax_bin(jproj, jcfg)
    return np.array(jax_gather(jproj, jb, jcfg)), np.array(jb.ranges)


def test_raster_matches_both_jax_rasterizers(stream):
    feats, ranges = stream
    cfg, jcfg = RenderConfig(**KW), JaxConfig(**KW, **JAX_PALLAS)
    img, trans = raster.rasterize_tiles(torch.from_numpy(feats),
                                        torch.from_numpy(ranges), cfg)
    assert img.shape == (64, 64, 3) and trans.shape == (64, 64)
    assert float(img.max()) > 0.01
    for rasterize in (rasterize_pallas, rasterize_tiles_jnp):
        jimg, jtrans = rasterize(jnp.asarray(feats), jnp.asarray(ranges), jcfg)
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans),
                                   rtol=1e-4, atol=1e-6)


def test_empty_tiles_are_black_with_full_transmittance(stream):
    feats, ranges = stream
    img, trans = raster.rasterize_tiles(
        torch.from_numpy(feats), torch.zeros(len(ranges), dtype=torch.int32),
        RenderConfig(**KW),
    )
    assert float(img.abs().max()) == 0.0
    assert bool((trans == 1.0).all())


@pytest.mark.parametrize("block_size", [1, 4, 32])
def test_walk_is_invariant_to_block_size(stream, block_size):
    """The block size schedules the plain walk; it must not change the
    image beyond the rounding of the block's log-domain cumsum."""
    feats, ranges = stream
    f, r = torch.from_numpy(feats), torch.from_numpy(ranges)
    ref = raster.rasterize_tiles(f, r, RenderConfig(**KW))
    cfg = RenderConfig(**dict(KW, block_size=block_size,
                              max_per_tile=512 * block_size // 8 or 1))
    got = raster.rasterize_tiles(f, r, cfg)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_plain_walk_has_no_per_tile_cap(stream):
    """The JAX jnp walk stops at cfg.max_per_tile; the port's plain walk,
    like the CUDA kernel, walks every tile's whole segment."""
    feats, ranges = stream
    longest = int(np.diff(ranges).max())
    small = dict(KW, max_per_tile=8)
    assert longest > 8
    img, trans = raster.rasterize_tiles(
        torch.from_numpy(feats), torch.from_numpy(ranges),
        RenderConfig(**small),
    )
    jimg, jtrans = rasterize_tiles_jnp(jnp.asarray(feats), jnp.asarray(ranges),
                                       JaxConfig(**KW))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), rtol=1e-4,
                               atol=1e-6)


def _serial_pairs(feats, ranges, cfg):
    """(T, P) (pixel, Gaussian) evaluations of a serial per-pixel walk that
    stops at (and counts) the Gaussian that terminates the pixel: numpy, in
    f64."""
    walk = np.zeros((cfg.num_tiles, cfg.pixels_per_tile), np.int64)
    px, py = (t.numpy()[..., 0].astype(np.float64) for t in
              tile_pixel_coords(torch.arange(cfg.num_tiles), cfg))
    f = feats.astype(np.float64)
    for t in range(cfg.num_tiles):
        trans = np.ones(cfg.pixels_per_tile)
        live = np.ones(cfg.pixels_per_tile, bool)
        for s in range(ranges[t], ranges[t + 1]):
            walk[t] += live
            dx, dy = px[t] - f[0, s], py[t] - f[1, s]
            power = -0.5 * (f[2, s] * dx * dx + f[4, s] * dy * dy) \
                - f[3, s] * dx * dy
            alpha = np.minimum(cfg.alpha_clamp,
                               f[8, s] * np.exp(np.minimum(power, 0.0)))
            ok = live & (power <= 0) & (alpha >= cfg.alpha_min)
            test_t = trans * (1.0 - alpha)
            stop = ok & (test_t < cfg.transmittance_min)
            trans = np.where(ok & ~stop, test_t, trans)
            live &= ~stop
    return walk


@pytest.fixture(scope="module")
def saturated():
    """JAX-binned features and ranges of a scene of opaque Gaussians, where
    many pixels terminate early."""
    jscene = jax_random_scene(jax.random.key(2), 300, sh_degree=0)
    jscene = jscene.replace(
        opacity_logits=jnp.full_like(jscene.opacity_logits, 4.0),
        log_scales=jnp.full_like(jscene.log_scales, -1.5),
    )
    jcfg = JaxConfig(**KW)
    jproj = jax_project(jscene, JaxCamera.default(64, 64), jcfg)
    jb = jax_bin(jproj, jcfg)
    return np.array(jax_gather(jproj, jb, jcfg)), np.array(jb.ranges)


def test_walk_counts_the_pairs_the_data_needs(saturated):
    """Each pixel's walk length (whose sum sizes the blend kernels' bound)
    equals a serial walk's, on a scene where many pixels terminate early."""
    feats, ranges = saturated
    cfg = RenderConfig(**KW)
    _, tr, walk = raster_torch._raster_tiles(
        torch.from_numpy(feats), torch.from_numpy(ranges), 0, cfg)
    assert float(tr.min()) < 1e-3  # pixels did terminate
    np.testing.assert_array_equal(walk.numpy(),
                                  _serial_pairs(feats, ranges, cfg))
    assert int(walk.sum()) < cfg.pixels_per_tile * int(ranges[-1])


def test_walked_pairs_at_warp_and_tile_granularity(saturated):
    """The pairs walked when a warp of 32 pixels, or a whole tile, walks as
    far as its slowest pixel: at least the per-pixel count, ordered, and at
    tile granularity P times each tile's longest walk."""
    feats, ranges = saturated
    cfg = RenderConfig(**KW)
    walk = raster_torch._raster_tiles(
        torch.from_numpy(feats), torch.from_numpy(ranges), 0, cfg)[2]
    p = cfg.pixels_per_tile
    per_pixel, per_warp, per_tile = (raster_torch.walked_pairs(walk, g)
                                     for g in (1, 32, p))
    assert per_pixel == int(walk.sum()) == _serial_pairs(feats, ranges,
                                                         cfg).sum()
    assert per_pixel < per_warp < per_tile
    assert per_tile == p * int(walk.amax(1).sum())
    with pytest.raises(ValueError, match="divide"):
        raster_torch.walked_pairs(walk, 48)


def test_power_floor_holds_every_pair_that_reaches_alpha_min():
    """The kernels' warp-level skip: on a dense pixel grid around seeded
    random Gaussians (opacities up to the 0.99 clamp and past it, tiny and
    very anisotropic conics, centres off the tile), no pair whose power,
    formed as eval_pair forms it in float32, lies below the Gaussian's power
    floor reaches alpha >= alpha_min; and the floor is tight."""
    cfg = RenderConfig(**KW)
    rng = np.random.default_rng(7)
    n = 160
    # Covariance eigenvalues (sigma 0.3 .. 300 px), a random rotation, and
    # the conic as the covariance's inverse; then a few hand-made extremes.
    sig = np.exp(rng.uniform(np.log(0.3), np.log(300.0), size=(n, 2)))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    l1, l2 = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
    conic = np.stack([l1 * c * c + l2 * s * s, (l1 - l2) * c * s,
                      l1 * s * s + l2 * c * c], 1)
    conic[:4] = [[1e-5, 0, 1e-5], [10.0, 9.9999, 10.0], [3.3, -3.2999, 3.3],
                 [1e-4, 0, 3.3]]
    op = rng.uniform(cfg.alpha_min * 0.5, 1.0, n)
    op[:8] = [0.99, 1.0, 0.999, 0.99, cfg.alpha_min, cfg.alpha_min * 0.99,
              1.0, 0.5]
    centre = rng.uniform(-100, 132, size=(n, 2))
    f32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in dict(
        gx=centre[:, 0], gy=centre[:, 1], ca=conic[:, 0], cb=conic[:, 1],
        cc=conic[:, 2], op=op).items()}
    floor = raster_torch.power_floor(f32["op"], cfg)
    grid = torch.arange(-640, 672, dtype=torch.float32)
    xs, ys = grid[None, :], grid[:, None]
    gaps = []
    for i in range(n):
        dx = xs - f32["gx"][i]
        dy = ys - f32["gy"][i]
        power = -0.5 * (f32["ca"][i] * dx * dx + f32["cc"][i] * dy * dy) \
            - f32["cb"][i] * dx * dy
        alpha = torch.clamp_max(
            f32["op"][i] * torch.exp(torch.clamp_max(power, 0.0)),
            cfg.alpha_clamp)
        hit = (power <= 0) & (alpha >= cfg.alpha_min)
        assert not bool((hit & (power < floor[i])).any()), \
            f"Gaussian {i} reaches alpha_min below its power floor"
        if bool(hit.any()):
            gaps.append(float(power[hit].min()) - float(floor[i]))
    # Most Gaussians reach a pixel, and the floor is tight: some pixel comes
    # within 1e-2 of it.
    assert len(gaps) >= 0.9 * n and min(gaps) < 1e-2
    # Below alpha_min nothing reaches: the floor is +inf.
    assert float(floor[5]) == float("inf")


def test_blend_block_batches_like_a_single_tile(stream):
    """A batch of tiles is the same blend as each tile alone."""
    feats, ranges = stream
    cfg = RenderConfig(**KW)
    tiles = torch.tensor([9, 27, 36])
    f = torch.from_numpy(feats)
    idx = torch.from_numpy(ranges)[tiles].long()[:, None] + torch.arange(8)
    in_range = (idx < torch.from_numpy(ranges)[tiles + 1].long()[:, None])
    feat = f[:, idx].permute(1, 0, 2)  # (3, F, G)
    px, py = tile_pixel_coords(tiles, cfg)
    batched, _ = blend_block(init_carry(64, (3,)), feat, px, py,
                             in_range[:, None, :], cfg)
    for i in range(3):
        one, _ = blend_block(init_carry(64), feat[i], px[i], py[i],
                             in_range[i][None, :], cfg)
        for a, b in zip(batched, one):
            torch.testing.assert_close(a[i], b, rtol=0, atol=0)


@pytest.mark.parametrize("binning", ["tiered", "sort"])
def test_saturated_early_exit_render_matches_jax(binning):
    """Opaque front Gaussians saturate pixels, so they terminate early; the
    port's render must still match both JAX rasterizers' render."""
    jscene = jax_random_scene(jax.random.key(2), 300, sh_degree=0)
    jscene = jscene.replace(
        opacity_logits=jnp.full_like(jscene.opacity_logits, 4.0),
        log_scales=jnp.full_like(jscene.log_scales, -1.5),
    )
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    kw = dict(KW, binning=binning)
    out = render(scene, cam, RenderConfig(**kw))
    assert float(out.transmittance.min()) < 1e-3  # saturation happened
    for extra in (JAX_PALLAS, dict(impl="jnp")):
        jout = jax_render(jscene, jcam, JaxConfig(**kw, **extra))
        np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                                   rtol=1e-4, atol=1e-5)


def test_tile32_g128_render_matches_jax():
    """tile_size 32 (one CUDA block of 1024 pixel threads) with the bench's
    Pallas block of 128, as in the JAX package's tile-32 test."""
    kw = dict(width=64, height=64, tile_size=32, max_intersections=1 << 13,
              max_tiles_per_gaussian=16, block_size=8, max_per_tile=256,
              binning="packed", pallas_block_size=128)
    jscene = jax_random_scene(jax.random.key(21), 150, sh_degree=1)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    out = render(scene, cam, RenderConfig(**kw))
    assert float(out.image.max()) > 0.01
    for extra in (JAX_PALLAS, dict(impl="jnp")):
        jout = jax_render(jscene, jcam, JaxConfig(**kw, **extra))
        np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                                   rtol=1e-4, atol=1e-5)


def test_dense_oracle_matches_jax():
    jscene = jax_random_scene(jax.random.key(4), 60, sh_degree=1)
    jcam = JaxCamera.default(32, 32)
    kw = dict(KW, width=32, height=32)
    scene, cam = to_port(jscene, jcam)
    img, trans = raster_torch.rasterize_dense_oracle(
        project_gaussians(scene, cam, RenderConfig(**kw)), RenderConfig(**kw))
    jimg, jtrans = jax_oracle(jax_project(jscene, jcam, JaxConfig(**kw)),
                              JaxConfig(**kw))
    assert float(img.max()) > 0.01
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), rtol=1e-4,
                               atol=1e-6)


def test_raster_wrapper_checks_its_inputs(stream):
    feats, ranges = stream
    cfg = RenderConfig(**KW)
    with pytest.raises(ValueError, match="device"):
        raster.rasterize_tiles(torch.zeros((9, 8), device="meta"),
                               torch.zeros(65, dtype=torch.int32,
                                           device="meta"), cfg)
    # The kernel launcher itself takes CUDA tensors only: a CPU tensor
    # never reaches a build or a launch.
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_tiles_cuda(torch.from_numpy(feats),
                                 torch.from_numpy(ranges), cfg)
