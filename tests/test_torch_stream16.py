"""The packed forward streams of the port (`ops/stream16.py`) and the bf16
pairs (`ops/bf16_pairs.py`) against the JAX package on the same numpy
inputs (CPU): the int32 words bit for bit, the packed renders at the image
tolerance, and the gradients of the packed stream with the float32
gradient paths, which are still exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.ops import stream16 as jstream16  # noqa: E402
from gsplat_tpu.ops.binning import _pack_bf16_pairs as jax_pack_pairs  # noqa: E402
from gsplat_tpu.ops.binning import _unpack_bf16_pairs as jax_unpack_pairs  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402
from gsplat_tpu_torch.ops import stream16  # noqa: E402
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs  # noqa: E402
from gsplat_tpu_torch.ops.cuda import raster  # noqa: E402
from gsplat_tpu_torch.render.pipeline import render, render_loss_and_grad  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32, binning="tiered",
          tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)))
JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)
JAX_JNP = dict(impl="jnp")


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


def features(n=500, seed=0):
    """Feature rows in the ranges a frame gives them, plus the edge cases
    of the quantisers: means and colours outside their ranges (clipped),
    and a colour on each fixed-point half step."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((9, n), np.float32)
    feats[0:2] = rng.uniform(-6.0, 70.0, (2, n))
    feats[2:5] = rng.normal(size=(3, n))
    feats[5:8] = rng.uniform(-0.5, 4.5, (3, n))
    feats[8] = rng.uniform(0.0, 1.0, n)
    feats[5, :4] = np.float32(4.0 / 2047.0) * np.float32([0.5, 1.5, 2.5, 3.5])
    return feats


@pytest.mark.parametrize("fmt", ["packed16", "packed4"])
def test_pack_stream_and_unpack_block_match_jax_bit_for_bit(fmt):
    feats = features()
    cfg = RenderConfig(**KW, stream_format=fmt)
    jcfg = JaxConfig(**KW, stream_format=fmt)
    got = stream16.pack_stream(torch.from_numpy(feats), cfg)
    want = np.asarray(jstream16.pack_stream(jnp.asarray(feats), jcfg))
    assert got.dtype == torch.int32
    assert got.shape == (stream16.STREAM_ROWS[fmt], feats.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        stream16.unpack_block(got, cfg).numpy(),
        np.asarray(jstream16.unpack_block(jnp.asarray(want), jcfg)))
    assert stream16.quant_params(cfg) == jstream16.quant_params(jcfg)


def test_bf16_pairs_match_jax_bit_for_bit():
    """Zero-high pairs (an odd row count pads with a zero row, and zeros in
    the data), signed zeros, f32 denormals, values on a round-to-nearest-
    even tie and one ulp either side of it, and infinities."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(9, 64)).astype(np.float32)
    tie = np.float32(1.0 + 2.0**-8)  # halfway between two bf16 values
    x[:, 0] = [0.0, -0.0, 0.0, 1e-40, -3e-39, tie, np.nextafter(tie, 2),
               np.nextafter(tie, 0), -tie]
    x[:, 1] = [np.inf, -np.inf, 1.0 + 3 * 2.0**-8, 0.0, 5.0, 0.0, -0.0, 2.0,
               0.0]
    got = pack_bf16_pairs(torch.from_numpy(x))
    want = np.asarray(jax_pack_pairs(jnp.asarray(x))).view(np.int32)
    assert got.dtype == torch.int32 and got.shape == (5, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    # The opacity pair (8|pad) has a zero high half: as float32 bits it is a
    # denormal, which the int32 typing keeps away from float arithmetic.
    assert (got[4].numpy() & np.int32(-65536) == 0).all()
    back = unpack_bf16_pairs(got, 9).numpy()
    np.testing.assert_array_equal(
        back.view(np.int32),
        np.asarray(jax_unpack_pairs(jnp.asarray(want.view(np.float32)),
                                    9)).view(np.int32))
    assert back[1, 0] == 0.0 and np.signbit(back[1, 0])
    with pytest.raises(ValueError, match="int32"):
        unpack_bf16_pairs(got.view(torch.float32), 9)


@pytest.mark.parametrize("fmt, jax_impls", [
    ("packed4", (JAX_PALLAS, JAX_JNP)),
    ("packed16", (JAX_JNP,)),
])
def test_packed_render_matches_jax(fmt, jax_impls):
    """The quantised inputs are the same bits in both packages, so the
    packed render is held to the float32 render's tolerance."""
    jscene = jax_random_scene(jax.random.key(3), 300, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    kw = dict(KW, stream_format=fmt)
    out = render(scene, cam, RenderConfig(**kw))
    assert not bool(out.overflow) and float(out.image.max()) > 0.01
    for extra in jax_impls:
        jout = jax_render(jscene, jcam, JaxConfig(**kw, **extra))
        assert int(out.num_intersections) == int(jout.num_intersections)
        np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out.transmittance.numpy(),
                                   np.asarray(jout.transmittance),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["packed4", "packed16"])
def test_packed_stream_gradients_with_f32_paths_match_jax(fmt):
    """Straight-through gradients of the packed stream through the float32
    gather backward (K4's plain version): exact, so the scene-gradient
    tolerance of the float32 path holds (rtol 5e-3, atol 1e-5)."""
    jscene = jax_random_scene(jax.random.key(4), 150, sh_degree=1)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    target = np.random.default_rng(5).uniform(size=(64, 64, 3)).astype(
        np.float32)
    kw = dict(KW, stream_format=fmt, segment_sum="pallas")
    loss, grads = render_loss_and_grad(scene, cam, torch.from_numpy(target),
                                       RenderConfig(**kw))
    jcfg = JaxConfig(**kw, **JAX_JNP)
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jnp.abs(
        jax_render(s, jcam, jcfg).image - target)))(jscene)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for f in SCENE_FIELDS:
        g = getattr(grads, f).numpy()
        assert np.abs(g).max() > 0.0, f
        np.testing.assert_allclose(g, np.asarray(getattr(jg, f)), rtol=5e-3,
                                   atol=1e-5, err_msg=f)


def test_packed_streams_are_typed_int32():
    """A packed stream must reach the kernels as int32: a float32 one raises
    in the unpacker and in the kernel wrappers, before any launch."""
    cfg = RenderConfig(**KW, stream_format="packed4")
    stream = stream16.pack_stream(torch.from_numpy(features()), cfg)
    ranges = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    as_float = stream.view(torch.float32)
    with pytest.raises(ValueError, match="int32"):
        stream16.unpack_block(as_float, cfg)
    with pytest.raises(ValueError, match="int32"):
        raster.raster_tiles_cuda(as_float, ranges, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_tiles_cuda(stream, ranges, cfg)
    g_col = torch.zeros((cfg.num_tiles, 3, cfg.pixels_per_tile))
    with pytest.raises(ValueError, match="int32"):
        raster.raster_bwd_cuda(as_float, ranges, g_col, g_col[:, 0], cfg,
                               pack_out=True)
    # The gather moves the packed words unchanged; a -1 gid reads zeros.
    gid = torch.tensor([3, -1, 0, 3], dtype=torch.int32)
    feats = torch.from_numpy(features())
    slots = stream16.gather_packed(feats, gid, cfg)
    torch.testing.assert_close(slots[:, [0, 2, 3]], stream[:, [3, 0, 3]],
                               rtol=0, atol=0)
    assert not slots[:, 1].any()
