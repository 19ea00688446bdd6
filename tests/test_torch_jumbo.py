"""The jumbo tiers of the port (`cfg.max_tiles_jumbo`, K3 on the gathered
rows at K = max_tiles_jumbo) against full-K 'sort' binning and against the
JAX package on the big-splat scene of tests/test_jumbo.py:18-35 (CPU), and
the statistics of the port's `realistic_scene`."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops import binning as jbin  # noqa: E402
from gsplat_tpu.ops.pallas.cull import cull_mask_from_params as jax_cull_rows  # noqa: E402
from gsplat_tpu.ops.pallas.cull import cull_params as jax_cull_params  # noqa: E402
from gsplat_tpu.ops.projection import project_gaussians as jax_project  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu_torch import RenderConfig, realistic_scene  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.ops.cuda import cull  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from gsplat_tpu_torch.render.pipeline import render, render_loss_and_grad  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
BASE = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
            block_size=8, max_per_tile=256)
JUMBO = dict(BASE, binning="tiered", max_tiles_per_gaussian=8,
             tier_spec=((4, 0), (8, 2)), max_tiles_jumbo=64,
             jumbo_tier_spec=((16, 16), (32, 8), (64, 8)))
# Full-K 'sort' binning covers every tile of every splat (K 64 is the whole
# 8x8 tile grid): the exact reference of the jumbo stream.
FULL_K = dict(BASE, binning="sort", max_tiles_per_gaussian=64)


def big_splat_scene(n=60, n_big=6, seed=0):
    """tests/test_jumbo.py's scene: a tail of huge splats whose rects blow
    past the base K_max of 8."""
    scene = jax_random_scene(jax.random.key(seed), n, sh_degree=1)
    big = jnp.zeros((n, 1)).at[:n_big].set(1.0)
    return scene.replace(
        log_scales=jnp.where(big > 0, jnp.log(1.5), scene.log_scales),
        opacity_logits=jnp.where(big[:, 0] > 0, 1.0, scene.opacity_logits),
    )


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


def _per_tile_multisets(binned):
    g, r = binned.sorted_gid.numpy(), binned.ranges.numpy()
    return [sorted(g[r[t]:r[t + 1]].tolist()) for t in range(len(r) - 1)]


def test_jumbo_stream_matches_full_k_sort():
    jscene = big_splat_scene()
    scene, cam = to_port(jscene, JaxCamera.default(64, 64))
    cfg, ref = RenderConfig(**JUMBO), RenderConfig(**FULL_K)
    proj = project_gaussians(scene, cam, cfg)
    assert bool(proj.overflow), "the big splats must exceed the base K_max"
    b = tbin.bin_gaussians(proj, cfg)
    b_ref = tbin.bin_gaussians(project_gaussians(scene, cam, ref), ref)
    assert not bool(b.overflow) and not bool(b_ref.overflow)
    assert int(b.num_intersections) == int(b_ref.num_intersections) > 0
    np.testing.assert_array_equal(b.ranges.numpy(), b_ref.ranges.numpy())
    assert _per_tile_multisets(b) == _per_tile_multisets(b_ref)
    np.testing.assert_array_equal(b.gauss_counts.numpy(),
                                  b_ref.gauss_counts.numpy())
    out, out_ref = render(scene, cam, cfg), render(scene, cam, ref)
    np.testing.assert_allclose(out.image.numpy(), out_ref.image.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tile_culling", [True, False])
def test_jumbo_counts_and_offsets_match_jax(tile_culling):
    jscene = big_splat_scene()
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    kw = dict(JUMBO, tile_culling=tile_culling)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw, impl="pallas",
                                              pallas_interpret=True)
    b = tbin.bin_gaussians(project_gaussians(scene, cam, cfg), cfg)
    jb = jbin.bin_gaussians(jax_project(jscene, jcam, jcfg), jcfg)
    assert int(b.num_intersections) == int(jb.num_intersections)
    assert bool(b.overflow) == bool(jb.overflow) is False
    for field in ("gauss_counts", "gauss_offsets", "ranges"):
        np.testing.assert_array_equal(getattr(b, field).numpy(),
                                      np.asarray(getattr(jb, field)), field)
    # The same gidk values per tile: gid << 11 | rank, kmax_eff 64 -> 7 bits.
    g, r = b.sorted_gidk.numpy(), b.ranges.numpy()
    jg = np.asarray(jb.sorted_gidk)
    assert [sorted(g[r[t]:r[t + 1]]) for t in range(len(r) - 1)] == \
        [sorted(jg[r[t]:r[t + 1]]) for t in range(len(r) - 1)]


@pytest.mark.parametrize("tile_culling", [True, False])
def test_jumbo_rank_route_matches_jax(tile_culling):
    """The jumbo grid's mask, krank and counts (K3's rank stage; its plain
    route here) equal the JAX package's maskj & is_jumbo, cumsum - 1 and
    row sums on the same rows, the walk bound 0 on rows that are not
    jumbo taking the place of the & is_jumbo."""
    jscene = big_splat_scene()
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    kw = dict(JUMBO, tile_culling=tile_culling)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw, impl="pallas",
                                              pallas_interpret=True)
    proj, jproj = project_gaussians(scene, cam, cfg), jax_project(
        jscene, jcam, jcfg)
    jumbo, kmax = cfg.max_tiles_jumbo, cfg.max_tiles_per_gaussian
    area = (torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 0)
            * torch.clamp_min(proj.rect[:, 3] - proj.rect[:, 1], 0))
    area = torch.where(proj.mask, area, 0)
    # More rows than jumbo splats: budget-padding rows are in the grid.
    ids_r = torch.sort(-area, stable=True).indices[: 16]
    assert 0 < int((area[ids_r] > kmax).sum()) < ids_r.numel()
    bound = torch.where(area > kmax, torch.clamp_max(area, jumbo), 0)
    kj = torch.arange(jumbo, dtype=torch.int32)[None, :]
    if tile_culling:
        params = cull.cull_params(proj, cfg, counts=bound)[:, ids_r]
        got = cull.cull_rank_from_params(params.contiguous(), jumbo,
                                         cfg.tile_size)
    else:
        got = cull.rank_from_mask(kj < bound[ids_r][:, None])
    ids = jnp.asarray(ids_r.numpy())
    rect = jproj.rect
    j_area = jnp.where(jproj.mask, jnp.maximum(rect[:, 2] - rect[:, 0], 0)
                       * jnp.maximum(rect[:, 3] - rect[:, 1], 0), 0)
    if tile_culling:
        jparams = jax_cull_params(jproj, jcfg,
                                  counts=jnp.minimum(j_area, jumbo))
        maskj = jax_cull_rows(jnp.take(jparams, ids, axis=1), jumbo,
                              cfg.tile_size, True)
    else:
        maskj = jnp.asarray(kj.numpy()) < jnp.minimum(
            j_area, jumbo)[ids][:, None]
    maskj = maskj & (j_area > kmax)[ids][:, None]
    want = (maskj, jnp.cumsum(maskj, axis=1).astype(jnp.int32) - 1,
            jnp.sum(maskj, axis=1).astype(jnp.int32))
    for g, w, name in zip(got, want, ("mask", "krank", "counts")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[2].sum()) > 0


def test_jumbo_cull_params_take_the_walk_bound():
    """The jumbo grid culls with the raw rect area (clipped to
    max_tiles_jumbo) as its walk bound, the `counts=` override."""
    scene, cam = to_port(big_splat_scene(), JaxCamera.default(64, 64))
    cfg = RenderConfig(**JUMBO)
    proj = project_gaussians(scene, cam, cfg)
    bound = torch.full_like(proj.counts, 37)
    params = cull.cull_params(proj, cfg, counts=bound)
    assert bool((params[cull.R_COUNT] == 37).all())
    torch.testing.assert_close(params[: cull.R_COUNT],
                               cull.cull_params(proj, cfg)[: cull.R_COUNT])


def test_jumbo_row_budget_overflow_flagged():
    scene, cam = to_port(big_splat_scene(n=60, n_big=12),
                         JaxCamera.default(64, 64))
    cfg = dataclasses.replace(RenderConfig(**JUMBO),
                              jumbo_tier_spec=((16, 4), (32, 2), (64, 1)))
    assert bool(render(scene, cam, cfg).overflow)
    # Without the jumbo tiers the same rects overflow the base K_max.
    base = RenderConfig(**{k: v for k, v in JUMBO.items()
                           if k not in ("max_tiles_jumbo", "jumbo_tier_spec")})
    assert bool(render(scene, cam, base).overflow)


@pytest.mark.parametrize("extra", [
    {},
    dict(stream_format="packed4", gather_backward="bf16", grad_readout="bf16",
         segment_sum="pallas"),
])
def test_jumbo_render_and_gradients_match_jax(extra):
    """f32: the image at rtol 1e-4 / atol 1e-5 and the scene gradients at
    rtol 5e-3 / atol 1e-5. The bench default (packed4, bf16 gradients, K5
    at depth 64): the same image tolerance, the gradients within 1e-5 +
    1e-2 of each field's largest value (tests/test_torch_packed_train.py)."""
    jscene = big_splat_scene(n=40, n_big=4)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    target = np.random.default_rng(1).uniform(size=(64, 64, 3)).astype(
        np.float32)
    kw = dict(JUMBO, **extra)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw, impl="jnp")
    out = render(scene, cam, cfg)
    jout = jax_render(jscene, jcam, jcfg)
    assert not bool(out.overflow) and not bool(jout.overflow)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                               rtol=1e-4, atol=1e-5)
    loss, grads = render_loss_and_grad(scene, cam, torch.from_numpy(target),
                                       cfg)
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jnp.abs(
        jax_render(s, jcam, jcfg).image - target)))(jscene)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for f in SCENE_FIELDS:
        got, want = getattr(grads, f).numpy(), np.asarray(getattr(jg, f))
        assert np.abs(got).max() > 0.0, f
        if extra:
            assert np.abs(got - want).max() <= 1e-5 + 1e-2 * np.abs(want).max(), f
        else:
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5,
                                       err_msg=f)


def test_realistic_scene_statistics():
    """The checks of tests/test_realistic_scene.py:30-42 on the port's
    draw: a fat tail of scales, bimodal opacity, a long depth tail."""
    scene = realistic_scene(20_000, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert scene.sh.shape == (20_000, 16, 3) and scene.means.shape == (20_000, 3)
    ls = scene.log_scales.numpy()
    op = torch.sigmoid(scene.opacity_logits).numpy()
    assert np.exp(ls.max()) / np.exp(np.median(ls)) > 50
    assert (op < 0.1).mean() > 0.15 and (op > 0.6).mean() > 0.3
    z = scene.means[:, 2].numpy()
    assert z.max() / np.median(z) > 2.5
    assert 2.0 <= z.min() and z.max() <= 20.0
    # Seeded: the same generator seed gives the same scene.
    again = realistic_scene(20_000, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(again.means, scene.means)
