"""The training step of the port against the JAX package (CPU): scene and
uv_tap gradients of the render loss, the L1 + DSSIM loss, the per-field Adam
with its position-lr decay, and one whole train step."""

import dataclasses

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
from gsplat_tpu.ops.camera import look_at as jax_look_at  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu.render.pipeline import (  # noqa: E402
    render_loss_with_aux as jax_render_loss_with_aux,
)
from gsplat_tpu.train import losses as jlosses  # noqa: E402
from gsplat_tpu.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from gsplat_tpu.train.loop import sh_band_mask as jax_sh_band_mask  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.render.pipeline import (  # noqa: E402
    render,
    render_loss,
    render_loss_and_grad,
    render_loss_with_aux,
)
from gsplat_tpu_torch.train import losses  # noqa: E402
from gsplat_tpu_torch.train.loop import (  # noqa: E402
    LR_SCALES,
    TRAIN_SPANS,
    make_optimizer,
    make_train_step,
    sh_band_mask,
)
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import tiered_oracle  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          pallas_block_size=32)
LADDER = ((4, 0), (8, 2), (16, 6), (32, 25), (64, 50))
# The exact-gradient bench setting of the training step.
EXACT = dict(gather_backward="variadic", grad_readout="f32",
             segment_sum="pallas", matmul_precision="highest",
             stream_format="f32")
JAX_PALLAS = dict(impl="pallas", pallas_interpret=True)
JAX_JNP = dict(impl="jnp")
# Scene gradients: the tolerance of tests/test_pallas.py:83-85.
RTOL, ATOL = 5e-3, 1e-5


def to_port(jscene, jcam):
    scene = scene_from_numpy(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS), device="cpu")
    cam = camera_from_numpy(
        *(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS), device="cpu")
    return scene, cam


def target_image(seed=9, shape=(64, 64, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("kw, jax_impls", [
    # The bench ladder against both JAX rasterizers; the other binning modes
    # against the jnp one (the JAX tests hold Pallas to jnp themselves).
    (dict(KW, binning="tiered", tier_spec=LADDER, **EXACT),
     (JAX_PALLAS, JAX_JNP)),
    (dict(KW, binning="tiered", tier_spec=(8, 5, 16)), (JAX_JNP,)),
    (dict(KW, binning="packed"), (JAX_JNP,)),
    (dict(KW, binning="sort"), (JAX_JNP,)),
])
def test_scene_and_tap_gradients_match_jax(kw, jax_impls):
    jscene = jax_random_scene(jax.random.key(8), 150, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    target = target_image()
    cfg = RenderConfig(**kw)

    loss, grads = render_loss_and_grad(scene, cam, torch.from_numpy(target), cfg)
    tap = torch.zeros((150, 2), requires_grad=True)
    out = render(scene, cam, cfg, uv_tap=tap)
    (g_tap,) = torch.autograd.grad(
        torch.mean(torch.abs(out.image - torch.from_numpy(target))), tap)
    assert not bool(out.overflow)
    assert float(g_tap.abs().max()) > 0.0

    for extra in jax_impls:
        jcfg = JaxConfig(**kw, **extra)

        def jloss(s, t, jcfg=jcfg):
            img = jax_render(s, jcam, jcfg, uv_tap=t).image
            return jnp.mean(jnp.abs(img - target))

        jl, (jg, jg_tap) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jscene, jnp.zeros((150, 2)))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for f in SCENE_FIELDS:
            np.testing.assert_allclose(
                getattr(grads, f).numpy(), np.asarray(getattr(jg, f)),
                rtol=RTOL, atol=ATOL, err_msg=f)
        np.testing.assert_allclose(g_tap.numpy(), np.asarray(jg_tap),
                                   rtol=RTOL, atol=ATOL)


def first_lanes(proj, cfg, n_local, tile_start=None):
    """`binning._tiered_candidates` from the lane grids: every tier's valid
    lanes in concatenation order (`tiered_oracle.tiered_lanes`), the first
    max_intersections of them kept, the rest of the slots SENTINEL_KEY and
    -1."""
    key, gidk, total, ovf, counts = tiered_oracle.tiered_lanes(
        proj, cfg, n_local, tile_start)
    valid = key != tbin.SENTINEL_KEY
    kept_key = key[valid][: cfg.max_intersections]
    kept_gidk = gidk[valid][: cfg.max_intersections]
    out_key = torch.full((cfg.max_intersections,), tbin.SENTINEL_KEY,
                         dtype=torch.int64)
    out_gidk = torch.full((cfg.max_intersections,), -1, dtype=torch.int32)
    out_key[: kept_key.numel()] = kept_key
    out_gidk[: kept_gidk.numel()] = kept_gidk
    return out_key, out_gidk, total, ovf, counts


def test_render_loss_with_aux_matches_jax(monkeypatch):
    """The L1 loss and the capacity flags, and on a stream too small for
    the scene, so that overflow is set, the flags and a loss that is not
    JAX's: the tiered route keeps the first max_intersections candidates in
    emission order where the JAX package keeps the lowest keys
    (`ops/binning.py`). That loss is held to the render of the lane grids'
    first max_intersections valid lanes in concatenation order."""
    jscene = jax_random_scene(jax.random.key(8), 150, sh_degree=2)
    jcam = JaxCamera.default(64, 64)
    scene, cam = to_port(jscene, jcam)
    target = target_image()
    for kw in (KW, dict(KW, max_intersections=64)):
        kw = dict(kw, binning="tiered", tier_spec=LADDER)
        loss, aux = render_loss_with_aux(scene, cam, torch.from_numpy(target),
                                         RenderConfig(**kw))
        jl, jaux = jax_render_loss_with_aux(jscene, jcam, jnp.asarray(target),
                                            JaxConfig(**kw, **JAX_JNP))
        if bool(aux["overflow"]):
            with monkeypatch.context() as m:
                m.setattr(tbin, "_tiered_candidates", first_lanes)
                want, _ = render_loss_with_aux(
                    scene, cam, torch.from_numpy(target), RenderConfig(**kw))
            np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
            assert abs(float(loss) - float(jl)) > 1e-5 * abs(float(jl))
        else:
            np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert float(render_loss(scene, cam, torch.from_numpy(target),
                                 RenderConfig(**kw))) == float(loss)
        assert bool(aux["overflow"]) == bool(jaux["overflow"])
        assert int(aux["num_intersections"]) == int(jaux["num_intersections"])
    assert bool(aux["overflow"])


@pytest.mark.parametrize("ssim_weight", [0.0, 0.2])
def test_rgb_loss_and_its_gradient_match_jax(ssim_weight):
    pred, target = target_image(1, (40, 48, 3)), target_image(2, (40, 48, 3))
    pred[:12, :12] = 0.0  # a flat black patch: zero local variance
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.rgb_loss(p, torch.from_numpy(target), ssim_weight)
    (g,) = torch.autograd.grad(got, p)
    want, jg = jax.value_and_grad(
        lambda a: jlosses.rgb_loss(a, target, ssim_weight))(jnp.asarray(pred))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_ssim_map_and_psnr_match_jax():
    a, b = target_image(3, (32, 32, 3)), target_image(4, (32, 32, 3))
    np.testing.assert_allclose(
        losses.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jlosses.ssim_map(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    assert abs(float(losses.ssim(torch.from_numpy(a), torch.from_numpy(a)))
               - 1.0) < 1e-5
    np.testing.assert_allclose(
        float(losses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_sh_band_mask_matches_jax():
    for degree in range(4):
        np.testing.assert_array_equal(
            sh_band_mask(16, degree, "cpu").numpy(),
            np.asarray(jax_sh_band_mask(16, degree)))


@pytest.mark.parametrize("decay", [None, dict(position_lr_final_ratio=0.1,
                                              lr_max_steps=2)])
def test_make_optimizer_matches_optax(decay):
    """Three updates fed the same numpy gradients; the decay case runs the
    means group past lr_max_steps, where the schedule holds its end value."""
    decay = decay or {}
    jscene = jax_random_scene(jax.random.key(3), 40, sh_degree=1)
    scene, _ = to_port(jscene, JaxCamera.default(64, 64))
    opt = make_optimizer(scene, 1e-2, **decay)
    assert [g["name"] for g in opt.param_groups] == list(SCENE_FIELDS)
    assert [g["lr"] for g in opt.param_groups] == \
        [1e-2 * LR_SCALES[f] for f in SCENE_FIELDS]
    jopt = jax_make_optimizer(1e-2, **decay)
    jstate = jopt.init(jscene)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = {f: rng.normal(size=getattr(jscene, f).shape).astype(np.float32)
             for f in SCENE_FIELDS}
        for f in SCENE_FIELDS:
            getattr(scene, f).grad = torch.from_numpy(g[f])
        opt.step()
        updates, jstate = jopt.update(
            jscene.replace(**{f: jnp.asarray(g[f]) for f in SCENE_FIELDS}),
            jstate, jscene)
        jscene = optax.apply_updates(jscene, updates)
    got = scene_to_numpy(scene)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(jscene, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def two_views():
    cams = [JaxCamera.default(64, 64)]
    eye = np.asarray(cams[0].cam_pos, np.float64)
    view = jax_look_at(eye + [0.1, 0.0, 0.0], eye + [0.15, 0.0, 1.0],
                       up=(0.0, -1.0, 0.0))
    cams.append(JaxCamera.create(view, 64, 64, fx=64.0, fy=64.0, znear=0.2,
                                 zfar=10.0))
    return cams


@pytest.mark.parametrize("active_sh_degree", [None, 0])
def test_one_train_step_matches_jax(active_sh_degree):
    """Loss, gradients, tap gradients, visibility, aux and the updated scene
    of one step against the JAX step (jnp rasterizer, the Pallas segment sum
    interpreted). Adam's first update is lr * g / (|g| + eps), about lr *
    sign(g): it turns the rounding noise of a near-zero gradient into a full
    lr step of either sign. So the updated parameters are held to 1e-6
    where JAX's gradient exceeds 100x the gradient tolerance, and to 2x the
    group's lr elsewhere."""
    kw = dict(KW, binning="tiered", tier_spec=(8, 5, 16), **EXACT)
    jscene = jax_random_scene(jax.random.key(0), 150, sh_degree=1)
    jcams = two_views()
    targets = np.stack([target_image(10), target_image(11)])
    jcfg = JaxConfig(**kw, **JAX_JNP)

    jopt = jax_make_optimizer(1e-2)
    jstep = jax_make_train_step(jcfg, jopt, ssim_weight=0.2)
    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs), *jcams)
    jstate, jl, jaux, (jtap, jvis) = jstep(
        init_train_state(jscene, jopt), jbatch, jnp.asarray(targets),
        active_sh_degree)

    def jloss(s):
        if active_sh_degree is not None:
            s = s.replace(sh=s.sh * jax_sh_band_mask(s.sh.shape[1],
                                                     active_sh_degree))
        return jnp.mean(jnp.stack([
            jlosses.rgb_loss(jax_render(s, c, jcfg).image, t, 0.2)
            for c, t in zip(jcams, targets)]))

    jg = jax.grad(jloss)(jscene)

    scene, _ = to_port(jscene, jcams[0])
    cams = [to_port(jscene, c)[1] for c in jcams]
    opt = make_optimizer(scene, 1e-2)
    step = make_train_step(RenderConfig(**kw), opt, ssim_weight=0.2)
    loss, aux, (tap, vis) = step(scene, cams, torch.from_numpy(targets),
                                 active_sh_degree)

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert bool(aux["overflow"]) == bool(jaux["overflow"]) is False
    assert int(aux["num_intersections"]) == int(jaux["num_intersections"])
    np.testing.assert_array_equal(aux["tier_members"].numpy(),
                                  np.asarray(jaux["tier_members"]))
    assert bool(aux["grads_finite"]) and bool(jaux["grads_finite"])
    np.testing.assert_array_equal(aux["grads_finite_leaves"].numpy(),
                                  np.asarray(jaux["grads_finite_leaves"]))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_allclose(tap.numpy(), np.asarray(jtap), rtol=RTOL,
                               atol=ATOL)
    got = scene_to_numpy(scene)
    for group in opt.param_groups:
        f = group["name"]
        g = np.asarray(getattr(jg, f))
        np.testing.assert_allclose(getattr(scene, f).grad.numpy(), g,
                                   rtol=RTOL, atol=ATOL, err_msg=f)
        want = np.asarray(getattr(jstate.scene, f))
        firm = np.abs(g) > 100 * ATOL
        np.testing.assert_allclose(got[f][firm], want[firm], rtol=1e-6,
                                   atol=1e-6, err_msg=f)
        assert np.abs(got[f] - want).max() <= 2 * group["lr"], f


def test_train_step_opens_its_spans_and_checks_its_scene():
    jscene = jax_random_scene(jax.random.key(0), 60, sh_degree=0)
    scene, cam = to_port(jscene, JaxCamera.default(64, 64))
    cfg = RenderConfig(**KW, binning="tiered")
    step = make_train_step(cfg, make_optimizer(scene), ssim_weight=0.2)
    target = torch.from_numpy(target_image())[None]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(scene, [cam], target)
    names = {e.name for e in prof.events()}
    assert set(TRAIN_SPANS) <= names
    other = dataclasses.replace(scene, means=scene.means.detach().clone())
    with pytest.raises(ValueError, match="optimizer's parameters"):
        step(other, [cam], target)
