"""The plain backward blend of the port (the CPU side of kernel K2) against
the JAX package's rasterizer VJPs on the same features, ranges and upstream
gradients (CPU). The JAX side runs as its own tests run it: the Pallas
kernels in interpret mode, and the jnp rasterizer's analytic VJP."""

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
from gsplat_tpu.ops.raster_jnp import rasterize_tiles_jnp  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.ops import raster_torch  # noqa: E402
from gsplat_tpu_torch.ops.blend import (  # noqa: E402
    blend_block_bwd,
    init_carry,
    tile_pixel_coords,
)
from gsplat_tpu_torch.ops.cuda import counters, raster  # noqa: E402

# The configuration of the JAX package's backward test (test_pallas.py).
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32)
JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)
# Per-slot raster gradients: the tolerance of tests/test_pallas.py:71.
RTOL, ATOL = 2e-3, 2e-4


def jax_stream(key, n, degree, **replace):
    """JAX-binned features and ranges of a JAX random scene, as numpy."""
    jcfg = JaxConfig(**KW)
    jscene = jax_random_scene(jax.random.key(key), n, sh_degree=degree)
    if replace:
        jscene = jscene.replace(**{k: jnp.full_like(getattr(jscene, k), v)
                                   for k, v in replace.items()})
    jproj = jax_project(jscene, JaxCamera.default(64, 64), jcfg)
    jb = jax_bin(jproj, jcfg)
    feats, ranges = np.array(jax_gather(jproj, jb, jcfg)), np.array(jb.ranges)
    # The port walks every segment whole; the JAX walk stops at max_per_tile.
    assert int(np.diff(ranges).max()) <= KW["max_per_tile"]
    return feats, ranges


def upstream(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(64, 64, 3)).astype(np.float32),
            rng.normal(size=(64, 64)).astype(np.float32))


def port_grad(feats, ranges, g_img, g_trans, cfg):
    f = torch.from_numpy(feats).requires_grad_(True)
    img, trans = raster.rasterize_tiles(f, torch.from_numpy(ranges), cfg)
    loss = (img * torch.from_numpy(g_img)).sum() + \
        (trans * torch.from_numpy(g_trans)).sum()
    (g,) = torch.autograd.grad(loss, f)
    return g.numpy(), trans.detach()


def jax_grads(feats, ranges, g_img, g_trans):
    jcfg = JaxConfig(**KW, **JAX_PALLAS)
    out = []
    for rasterize in (rasterize_pallas, rasterize_tiles_jnp):
        def loss(f, rasterize=rasterize):
            img, trans = rasterize(f, jnp.asarray(ranges), jcfg)
            return jnp.sum(img * g_img) + jnp.sum(trans * g_trans)
        out.append(np.asarray(jax.grad(loss)(jnp.asarray(feats))))
    return out


@pytest.fixture(scope="module")
def stream():
    return jax_stream(0, 150, 2)


def test_plain_backward_matches_both_jax_vjps(stream):
    feats, ranges = stream
    g_img, g_trans = upstream()
    got, _ = port_grad(feats, ranges, g_img, g_trans, RenderConfig(**KW))
    assert np.abs(got).max() > 1e-3
    for want in jax_grads(feats, ranges, g_img, g_trans):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_early_exit_backward_is_finite_and_matches_jax():
    """Opaque front Gaussians saturate pixels (the scene of the JAX
    package's early-exit test); slots behind the termination get no
    gradient, and the rest match both JAX VJPs."""
    feats, ranges = jax_stream(2, 300, 0, opacity_logits=4.0, log_scales=-1.5)
    g_img, g_trans = upstream(6)
    got, trans = port_grad(feats, ranges, g_img, g_trans, RenderConfig(**KW))
    assert float(trans.min()) < 1e-3  # saturation happened
    assert np.isfinite(got).all()
    for want in jax_grads(feats, ranges, g_img, g_trans):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_nan_opacity_slots_backward_like_jax(stream):
    """Every 17th slot with a NaN opacity (reachable at tile_culling=False):
    the forward skips its pairs, and both JAX VJPs give the slot 0 in every
    gradient, the rest finite. The plain backward, which K2 is held to on
    the card, does the same: its clamp masks are selects, for a product
    with the mask would turn the skipped pair's da = 0 times alpha_u = NaN
    into NaN geometry gradients."""
    feats, ranges = stream
    feats = feats.copy()
    nan = np.zeros(feats.shape[1], bool)
    nan[: int(ranges[-1]): 17] = True
    feats[8, nan] = np.nan
    g_img, g_trans = upstream()
    got, _ = port_grad(feats, ranges, g_img, g_trans, RenderConfig(**KW))
    assert np.isfinite(got).all() and not got[:, nan].any()
    assert np.abs(got[:, ~nan]).max() > 1e-3
    for want in jax_grads(feats, ranges, g_img, g_trans):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_empty_tiles_give_zero_gradients(stream):
    feats, ranges = stream
    g_img, g_trans = upstream()
    got, _ = port_grad(feats, np.zeros_like(ranges), g_img, g_trans,
                       RenderConfig(**KW))
    assert not got.any()


def test_slots_outside_every_segment_get_exactly_zero(stream):
    """The invalid tail past ranges[-1] reaches real Gaussians through the
    gather backward's sort unless it is exactly 0."""
    feats, ranges = stream
    g_img, g_trans = upstream()
    junk_tail = feats.copy()
    junk_tail[:, ranges[-1]:] = np.random.default_rng(3).uniform(
        0.5, 2.0, size=junk_tail[:, ranges[-1]:].shape)
    got, _ = port_grad(junk_tail, ranges, g_img, g_trans, RenderConfig(**KW))
    assert ranges[-1] < feats.shape[1]
    assert not got[:, ranges[-1]:].any()
    ref, _ = port_grad(feats, ranges, g_img, g_trans, RenderConfig(**KW))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("block_size", [1, 4, 32])
def test_backward_is_invariant_to_block_size(stream, block_size):
    feats, ranges = stream
    g_img, g_trans = upstream()
    ref, _ = port_grad(feats, ranges, g_img, g_trans, RenderConfig(**KW))
    cfg = RenderConfig(**dict(KW, block_size=block_size,
                              max_per_tile=512 * block_size // 8 or 1))
    got, _ = port_grad(feats, ranges, g_img, g_trans, cfg)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_zero_opacity_slots_give_zero_not_nan():
    """A zero-feature lane (zero opacity) must give d_op = 0, not 0/0: the
    backward forms d_op as a product, never a quotient by opacity."""
    cfg = RenderConfig(**KW)
    feat = torch.zeros((1, 9, 8))
    feat[0, :5, :4] = torch.tensor([4.0, 4.0, 0.5, 0.0, 0.5])[:, None]
    feat[0, 5:8, :4] = 0.5
    feat[0, 8, :4] = 0.8  # lanes 4..7 keep every feature 0
    px, py = tile_pixel_coords(torch.tensor([0]), cfg)
    g_color = torch.ones((1, 3, 64))
    dfeat, _, _, applied = blend_block_bwd(
        init_carry(64, (1,)), feat, px, py, torch.ones((1, 1, 8), dtype=bool),
        g_color, torch.full((1, 64, 1), 0.5), torch.zeros((1, 64, 1)), cfg)
    assert bool(torch.isfinite(dfeat).all()) and int(applied) > 0
    assert not dfeat[0, :, 4:].any()
    assert bool((dfeat[0, 8, :4] != 0).any())


def test_applied_pairs_count_the_nonzero_weights(stream):
    """The backward walk's pair count (sizing K2's bound) is the number of
    (pixel, Gaussian) pairs that carry weight in the forward walk."""
    feats, ranges = stream
    cfg = RenderConfig(**KW)
    f, r = torch.from_numpy(feats), torch.from_numpy(ranges)
    g = torch.zeros((cfg.num_tiles, 3, cfg.pixels_per_tile))
    _, applied = raster_torch._raster_tiles_bwd_walk(
        f, r, 0, g, torch.zeros((cfg.num_tiles, cfg.pixels_per_tile, 1)), cfg)
    _, _, walked = raster_torch._raster_tiles(f, r, 0, cfg)
    assert 0 < int(applied) < int(walked.sum())


def test_no_grad_input_records_nothing(stream):
    feats, ranges = stream
    img, trans = raster.rasterize_tiles(torch.from_numpy(feats),
                                        torch.from_numpy(ranges),
                                        RenderConfig(**KW))
    assert img.grad_fn is None and trans.grad_fn is None


def test_backward_kernel_wrapper_checks_its_inputs(stream):
    feats, ranges = stream
    cfg = RenderConfig(**KW)
    g = torch.zeros((cfg.num_tiles, 3, cfg.pixels_per_tile))
    b = torch.zeros((cfg.num_tiles, cfg.pixels_per_tile))
    # The launcher takes CUDA tensors only: a CPU tensor never reaches a
    # build or a launch.
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_bwd_cuda(torch.from_numpy(feats),
                               torch.from_numpy(ranges), g, b, cfg)
    before = counters.snapshot()
    port_grad(feats, ranges, *upstream(), cfg)
    assert counters.rise(before, counters.snapshot()) == {}


def test_image_to_tiles_inverts_tiles_to_image():
    """The chip check forms per-tile upstream gradients with it; the ragged
    edge (60 = 7.5 tiles of 8) pads with zeros."""
    cfg = RenderConfig(**dict(KW, width=60, height=52))
    img = torch.from_numpy(np.random.default_rng(0).normal(
        size=(52, 60, 3)).astype(np.float32))
    tiles = raster_torch._image_to_tiles(img, cfg)
    assert tiles.shape == (cfg.num_tiles, 3, cfg.pixels_per_tile)
    torch.testing.assert_close(raster_torch._tiles_to_image(tiles, cfg), img,
                               rtol=0, atol=0)
    assert int(torch.count_nonzero(tiles)) == img.numel()  # zero padding
