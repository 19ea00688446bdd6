"""The bench-default training path of the port (bench.py:85-120 with no
flags: stream_format='packed4', gather_backward='bf16', grad_readout='bf16',
segment_sum='pallas', matmul_precision='high') against the JAX package on
the CPU. The JAX side runs its Pallas kernels in interpret mode: the route
whose raster backward emits bf16-pair slot gradients (raster.py
_pack_grads), which the port's K2 mirrors.

Tolerance of the bf16 gradients. Each slot's float32 gradient differs from
JAX's at the 1e-6 relative level (the two packages sum pixels in another
order), so its bf16 rounding can land one bf16 ulp (2^-8 relative) apart;
the per-Gaussian gradient is a float32 sum of such slots, rounded to bf16
once more at the read-out. So every field is held within 1e-5 + 1e-2 times
its largest JAX magnitude (a few ulps of the largest slot), and at least
99% of the entries within 1e-5 + 8e-3 times their own JAX value (two ulps).
The JAX package's own packed-gradient test allows 3% of the maximum
(tests/test_stream16.py:95).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu.train import losses as jlosses  # noqa: E402
from gsplat_tpu.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.ops import binning  # noqa: E402
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs  # noqa: E402
from gsplat_tpu_torch.ops.cuda import counters, raster  # noqa: E402
from gsplat_tpu_torch.render.pipeline import render_loss_and_grad  # noqa: E402
from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32, binning="tiered",
          tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)))
# bench.py's defaults for the training step.
BENCH_DEFAULT = dict(stream_format="packed4", gather_backward="bf16",
                     grad_readout="bf16", segment_sum="pallas",
                     matmul_precision="high")
JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)
ATOL, MAX_RTOL, RTOL, SHARE = 1e-5, 1e-2, 8e-3, 0.99


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


def target_image(seed):
    return np.random.default_rng(seed).uniform(size=(64, 64, 3)).astype(
        np.float32)


def assert_bf16_close(got, want, name):
    """The bf16-gradient tolerance of the module docstring."""
    err = np.abs(got - want)
    assert err.max() <= ATOL + MAX_RTOL * np.abs(want).max(), name
    share = float(np.mean(err <= ATOL + RTOL * np.abs(want)))
    assert share >= SHARE, (name, share)


def test_bench_default_gradients_match_jax():
    jscene = jax_random_scene(jax.random.key(8), 150, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    target = target_image(9)
    cfg = RenderConfig(**KW, **BENCH_DEFAULT)
    loss, grads = render_loss_and_grad(scene, cam, torch.from_numpy(target),
                                       cfg)
    jcfg = JaxConfig(**KW, **BENCH_DEFAULT, **JAX_PALLAS)
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jnp.abs(
        jax_render(s, jcam, jcfg).image - target)))(jscene)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for f in SCENE_FIELDS:
        g = getattr(grads, f).numpy()
        assert np.abs(g).max() > 0.0, f
        assert_bf16_close(g, np.asarray(getattr(jg, f)), f)


def test_one_bench_default_train_step_matches_jax():
    """Loss, aux, gradients and the updated scene of one L1 + 0.2 DSSIM Adam
    step. Adam's first update is about lr * sign(g), so the updated
    parameters are held to 1e-6 where JAX's gradient is too large for the
    bf16 tolerance to flip its sign, and to 2x the group's lr elsewhere."""
    kw = dict(KW, **BENCH_DEFAULT)
    jscene = jax_random_scene(jax.random.key(0), 150, sh_degree=1)
    jcam = JaxCamera.default(64, 64)
    target = target_image(10)[None]
    jcfg = JaxConfig(**kw, **JAX_PALLAS)
    jopt = jax_make_optimizer(1e-2)
    jstep = jax_make_train_step(jcfg, jopt, ssim_weight=0.2)
    jstate, jl, jaux, (jtap, jvis) = jstep(
        init_train_state(jscene, jopt),
        jax.tree.map(lambda x: x[None], jcam), jnp.asarray(target))
    jg = jax.grad(lambda s: jlosses.rgb_loss(
        jax_render(s, jcam, jcfg).image, target[0], 0.2))(jscene)

    scene, cam = to_port(jscene, jcam)
    opt = make_optimizer(scene, 1e-2)
    step = make_train_step(RenderConfig(**kw), opt, ssim_weight=0.2)
    before = counters.snapshot()
    loss, aux, (tap, vis) = step(scene, [cam], torch.from_numpy(target))
    # The CPU takes the plain versions: no kernel is launched.
    assert counters.rise(before, counters.snapshot()) == {}

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert bool(aux["overflow"]) == bool(jaux["overflow"]) is False
    assert int(aux["num_intersections"]) == int(jaux["num_intersections"])
    assert bool(aux["grads_finite"]) and bool(jaux["grads_finite"])
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert_bf16_close(tap.numpy(), np.asarray(jtap), "uv_tap")
    got = scene_to_numpy(scene)
    for group in opt.param_groups:
        f = group["name"]
        g = np.asarray(getattr(jg, f))
        assert_bf16_close(getattr(scene, f).grad.numpy(), g, f)
        want = np.asarray(getattr(jstate.scene, f))
        firm = np.abs(g) > 2 * (ATOL + MAX_RTOL * np.abs(g).max())
        np.testing.assert_allclose(got[f][firm], want[firm], rtol=1e-6,
                                   atol=1e-6, err_msg=f)
        assert np.abs(got[f] - want).max() <= 2 * group["lr"], f


def test_opacity_lanes_survive_the_packed_route():
    """Denormal pin. K2's bf16-pair output pairs the opacity gradient with
    a zero pad row, so every opacity lane is an int32 whose high half is 0:
    as float32 bits, a denormal, which a flushing float path would zero.
    Through pack -> gather -> K2-out -> sort -> K5 -> read-out those lanes
    stay int32, and the opacity gradients come out nonzero and equal to the
    float32 route's to the bf16 tolerance."""
    jscene = jax_random_scene(jax.random.key(4), 150, sh_degree=1)
    scene, cam = to_port(jscene, JaxCamera.default(64, 64))
    target = torch.from_numpy(target_image(11))
    fast = RenderConfig(**KW, **BENCH_DEFAULT)
    exact = RenderConfig(**KW, **dict(BENCH_DEFAULT, gather_backward="c64",
                                      grad_readout="f32"))
    assert raster.packs_grads(fast) and not raster.packs_grads(exact)
    g_fast = render_loss_and_grad(scene, cam, target, fast)[1]
    g_exact = render_loss_and_grad(scene, cam, target, exact)[1]
    op_fast = g_fast.opacity_logits.numpy()
    op_exact = g_exact.opacity_logits.numpy()
    assert (op_exact != 0).sum() > 50
    np.testing.assert_array_equal(op_fast != 0, op_exact != 0)
    assert_bf16_close(op_fast, op_exact, "opacity_logits")

    # The lanes themselves: nonzero opacity slot gradients packed with the
    # pad row are float32 denormal bit patterns, and the packed reduction
    # returns their run totals.
    rng = np.random.default_rng(0)
    n, m = 6, 40
    gidk = torch.from_numpy(
        (np.repeat(np.arange(n), 5)[:, None] << binning._kbits(64)
         | np.tile(np.arange(5), n)[:, None])[:, 0].astype(np.int32))
    gidk = torch.cat([gidk, torch.full((m - 5 * n,), -1, dtype=torch.int32)])
    dslot = torch.zeros((9, m))
    dslot[8, : 5 * n] = torch.from_numpy(
        rng.uniform(0.5, 2.0, 5 * n).astype(np.float32))
    xp = pack_bf16_pairs(dslot)
    lanes = xp[4, : 5 * n]
    assert bool((lanes != 0).all() and (lanes & -65536 == 0).all())
    as_float = lanes.view(torch.float32).abs()
    assert bool((as_float < torch.finfo(torch.float32).tiny).all())
    counts = torch.full((n,), 5, dtype=torch.int32)
    offsets = torch.arange(0, 5 * n, 5, dtype=torch.int32)
    key = torch.where(gidk >= 0, gidk, 2**31 - 1)
    got = binning.packed_grad_reduce(xp, key, offsets, counts, 64, 9)
    want = dslot[8, : 5 * n].to(torch.bfloat16).float().reshape(n, 5).sum(1)
    torch.testing.assert_close(got[8], want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
