"""`fit` of the port (CPU): against the JAX fit on the same numpy scene,
cameras and targets, with densification, opacity reset, SH warm-up and
position-lr decay, also resumed from the JAX fit's own checkpoint; and the
JAX fit's contracts ported: the overflow policy, the non-finite-gradient
abort, the staged capacity, checkpoints and the resume's view path."""

import ast
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
from gsplat_tpu.ops.camera import look_at as jax_look_at  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.render.pipeline import render as jax_render  # noqa: E402
from gsplat_tpu.train import densify as jd  # noqa: E402
from gsplat_tpu.train.loop import fit as jax_fit  # noqa: E402
from gsplat_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from gsplat_tpu_torch import Camera, RenderConfig, random_scene, render  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy,
    scene_adam_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.train.loop import fit, make_optimizer  # noqa: E402
from gsplat_tpu_torch.utils.checkpoint import (  # noqa: E402
    checkpoint_step,
    load_checkpoint,
    save_checkpoint,
)

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")
KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 13,
          max_tiles_per_gaussian=64, block_size=8, max_per_tile=512,
          binning="tiered", tier_spec=(8, 5, 16),
          gather_backward="variadic", grad_readout="f32",
          segment_sum="pallas", stream_format="f32")
# The parity run: densify rounds at steps 2 and 4, a checkpoint at 4 (after
# the round, whose fresh accumulator is what a resume starts from), an
# opacity reset at 5, the SH bands one per 3 steps, position-lr decay.
FIT = dict(steps=8, lr=1e-2, ssim_weight=0.2, seed=3, log_every=1,
           densify_every=2, densify_from=2, densify_until=4,
           densify_grad_threshold=1e-4, opacity_reset_every=5,
           sh_warmup_every=3, position_lr_final_ratio=0.1,
           checkpoint_every=4)
LOSS_RTOL = 2e-3


def two_views():
    cams = [JaxCamera.default(64, 64)]
    eye = np.asarray(cams[0].cam_pos, np.float64)
    view = jax_look_at(eye + [0.1, 0.0, 0.0], eye + [0.15, 0.0, 1.0],
                       up=(0.0, -1.0, 0.0))
    cams.append(JaxCamera.create(view, 64, 64, fx=64.0, fy=64.0, znear=0.2,
                                 zfar=10.0))
    return cams


def densify_rows(text):
    return [ast.literal_eval(line) for line in text.splitlines()
            if line.startswith("{'num_alive'")]


def test_fit_matches_jax(tmp_path, capsys, monkeypatch):
    jcams = two_views()
    target_scene = jax_random_scene(jax.random.key(1), 120, sh_degree=1)
    jcfg = JaxConfig(**KW, impl="jnp")
    targets = np.stack([np.asarray(jax_render(target_scene, c, jcfg).image)
                        for c in jcams])
    init = jax_random_scene(jax.random.key(2), 100, sh_degree=1).replace(
        opacity_logits=jnp.full((100,), 1.0)).pad_to(160)

    # The JAX run, with every accumulator it densifies from recorded.
    states = []
    accumulate = jd.accumulate_grads

    def recording(state, screen_grads, visible=None):
        out = accumulate(state, screen_grads, visible)
        states.append(out)
        return out

    monkeypatch.setattr(jd, "accumulate_grads", recording)
    jdir = tmp_path / "jax"
    _, jrows = jax_fit(init, jax.tree.map(lambda *x: jnp.stack(x), *jcams),
                       jnp.asarray(targets), jcfg,
                       checkpoint_dir=str(jdir), **FIT)
    jdensify = densify_rows(capsys.readouterr().out)
    assert [d["densify_at"] for d in jdensify] == [2, 4]
    assert sum(d["num_split"] + d["num_clone"] for d in jdensify) > 0
    # No accumulated gradient lies within 1% of the threshold, so a
    # flipped decision would be a fault and not rounding.
    thr = FIT["densify_grad_threshold"]
    for at in (2, 4):
        st = states[at - 1]
        avg = np.asarray(st.grad_accum) / np.maximum(
            np.asarray(st.visit_count), 1)
        assert np.min(np.abs(avg - thr)) > 0.01 * thr

    scene = scene_from_numpy(*(np.asarray(getattr(init, f))
                               for f in SCENE_FIELDS), device="cpu")
    cams = [camera_from_numpy(*(np.asarray(getattr(c, f)) for f in CAM_FIELDS),
                              device="cpu") for c in jcams]
    cfg = RenderConfig(**KW)
    tdir = tmp_path / "port"
    _, rows = fit(scene, cams, torch.from_numpy(targets), cfg,
                  checkpoint_dir=str(tdir), **FIT)
    assert densify_rows(capsys.readouterr().out) == jdensify
    assert [r["step"] for r in rows] == [r["step"] for r in jrows]
    np.testing.assert_allclose([r["loss"] for r in rows],
                               [r["loss"] for r in jrows], rtol=LOSS_RTOL)
    # The caller's scene is left as it was.
    np.testing.assert_array_equal(scene.means.numpy(),
                                  np.asarray(init.means))

    # The port resumed from the JAX fit's step-4 checkpoint, carried over
    # as numpy arrays: the same losses as the JAX fit's steps 5-8.
    jopt = jax_make_optimizer(FIT["lr"], position_lr_final_ratio=0.1,
                              lr_max_steps=FIT["steps"])
    jstate = jax_load_checkpoint(str(jdir / "ckpt_000004.npz"),
                                 init_train_state(init, jopt))
    adam = {f: jstate.opt_state.inner_states[f].inner_state[0]
            for f in SCENE_FIELDS}
    mid, opt = scene_adam_from_numpy(
        {f: np.asarray(getattr(jstate.scene, f)) for f in SCENE_FIELDS},
        {f: np.asarray(getattr(adam[f].mu, f)) for f in SCENE_FIELDS},
        {f: np.asarray(getattr(adam[f].nu, f)) for f in SCENE_FIELDS},
        int(adam["means"].count), FIT["lr"], device="cpu",
        position_lr_final_ratio=0.1, lr_max_steps=FIT["steps"])
    path = str(tmp_path / "from_jax.npz")
    save_checkpoint(path, mid, opt, int(jstate.step))
    assert checkpoint_step(path) == 4
    _, rrows = fit(scene, cams, torch.from_numpy(targets), cfg,
                   checkpoint_dir=str(tmp_path / "resumed"), resume=path,
                   **FIT)
    assert [r["step"] for r in rrows] == [5, 6, 7, 8]
    np.testing.assert_allclose([r["loss"] for r in rrows],
                               [r["loss"] for r in jrows[4:]], rtol=LOSS_RTOL)


# The JAX fit's contract tests, on the port (tests/test_overflow.py,
# tests/test_train.py).
CFG = RenderConfig(width=32, height=32, tile_size=8, max_intersections=1 << 12,
                   max_tiles_per_gaussian=32, block_size=8, max_per_tile=128)
TINY = dataclasses.replace(CFG, max_intersections=8)


def _scene(seed, n=40, degree=1):
    return random_scene(n, degree, generator=torch.Generator().manual_seed(seed),
                        device="cpu")


def _batch(scene, cfg=CFG):
    cam = Camera.default(cfg.width, cfg.height, device="cpu")
    with torch.no_grad():
        target = render(scene, cam, CFG).image
    return [cam], target[None]


def test_fit_raises_on_overflow_with_the_demand():
    scene = _scene(0)
    cams, targets = _batch(scene)
    with torch.no_grad():
        demand = int(render(scene, cams[0], TINY).num_intersections)
    assert demand > TINY.max_intersections
    with pytest.raises(RuntimeError, match=f"max_intersections.*{demand}"
                       f"|{demand}.*max_intersections"):
        fit(scene, cams, targets, TINY, steps=4, log_every=2)


def test_fit_warn_policy_continues(capsys):
    scene = _scene(0)
    cams, targets = _batch(scene)
    _, metrics = fit(scene, cams, targets, TINY, steps=4, log_every=2,
                     overflow_policy="warn")
    assert len(metrics) == 2
    assert "capacity overflow" in capsys.readouterr().out
    _, metrics = fit(scene, cams, targets, CFG, steps=4, log_every=2)
    assert len(metrics) == 2


def test_fit_aborts_naming_nonfinite_grad_leaf():
    scene = _scene(0)
    cams, targets = _batch(scene)
    scene.means[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="means"):
        fit(scene, cams, targets, CFG, steps=2, lr=1e-2, ssim_weight=0.0,
            log_every=1, overflow_policy="raise")


def test_fit_refuses_a_mesh():
    """fit(mesh=...) refuses a mesh whose data axis does not divide the
    batch, and one whose tile axis does not divide the tile rows (rank 0's
    view of such meshes; tests/test_torch_sharding.py fits on real ones)."""
    from gsplat_tpu_torch.parallel.sharding import Mesh

    scene = _scene(0)
    cams, targets = _batch(scene)
    cpu = torch.device("cpu")
    data2 = Mesh(("data", "tiles"), (2, 1), (0, 0), (None, None), cpu, False)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        fit(scene, cams, targets, CFG, steps=1, batch=1, mesh=data2)
    tiles3 = Mesh(("tiles",), (3,), (0,), (None,), cpu, False)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        fit(scene, cams, targets, CFG, steps=1, mesh=tiles3)


def test_staged_capacity_tightens(capsys):
    scene = _scene(0)
    cams, targets = _batch(scene)
    init = dataclasses.replace(scene, opacity_logits=scene.opacity_logits - 0.5)
    _, metrics = fit(init, cams, targets, CFG, steps=12, lr=1e-2,
                     ssim_weight=0.0, log_every=4, overflow_policy="raise",
                     densify_until=6, retighten_capacity=1.3)
    assert "staged capacity: tightening max_intersections" in \
        capsys.readouterr().out
    assert np.isfinite(metrics[-1]["loss"])


def test_staged_capacity_no_tighten_when_demand_high(capsys):
    scene = _scene(1)
    cams, targets = _batch(scene)
    with torch.no_grad():
        demand = int(render(scene, cams[0], CFG).num_intersections)
    snug = dataclasses.replace(CFG, max_intersections=demand + 64)
    fit(scene, cams, targets, snug, steps=8, lr=1e-3, ssim_weight=0.0,
        log_every=4, overflow_policy="warn", densify_until=2,
        retighten_capacity=1.3)
    assert "staged capacity: tightening" not in capsys.readouterr().out


def test_staged_capacity_tightens_tier_spec(capsys):
    cfg = dataclasses.replace(CFG, binning="tiered",
                              tier_spec=((4, 0), (8, 2), (16, 4), (32, 8)))
    scene = _scene(2, n=60)
    cams, targets = _batch(scene, cfg)
    _, metrics = fit(scene, cams, targets, cfg, steps=10, lr=1e-3,
                     ssim_weight=0.0, log_every=5, overflow_policy="raise",
                     densify_until=4, retighten_capacity=1.5)
    out = capsys.readouterr().out
    assert "tier_spec" in out and "staged capacity: tightening" in out
    assert np.isfinite(metrics[-1]["loss"])


def test_staged_capacity_regrows_on_overflow(capsys):
    """A tightened stream that the scene then outgrows: the step is rebuilt
    at the original sizing, with a warning and no abort, under 'raise'."""
    cfg = dataclasses.replace(CFG, max_intersections=1 << 14)
    scene = _scene(2, n=3000)
    cams, targets = _batch(scene, cfg)

    def eval_fn(s, step):
        # Grow every splat once the tightened step runs: the demand it was
        # sized from no longer holds.
        if step == 5:
            s.log_scales.add_(2.0)
        return {}

    _, metrics = fit(scene, cams, targets, cfg, steps=10, lr=1e-4,
                     ssim_weight=0.0, log_every=5, overflow_policy="raise",
                     densify_until=4, retighten_capacity=1.0,
                     eval_every=5, eval_fn=eval_fn)
    out = capsys.readouterr().out
    assert "staged capacity: tightening" in out
    assert "staged capacity overflowed" in out
    assert len(metrics) == 2


def test_checkpoint_roundtrip(tmp_path):
    scene = _scene(0, n=16)
    opt = make_optimizer(scene, 1e-2, position_lr_final_ratio=0.1,
                         lr_max_steps=10)
    for p in (scene.means, scene.sh):
        p.grad = torch.ones_like(p)
    opt.step()
    path = str(tmp_path / "c" / "ckpt.npz")
    save_checkpoint(path, scene, opt, 7)
    assert checkpoint_step(path) == 7
    other = _scene(5, n=16)
    opt2 = make_optimizer(other, 1e-2, position_lr_final_ratio=0.1,
                          lr_max_steps=10)
    assert load_checkpoint(path, other, opt2) == 7
    assert opt2.updates == opt.updates == 1
    for f in SCENE_FIELDS:
        p, q = getattr(scene, f), getattr(other, f)
        np.testing.assert_array_equal(q.detach().numpy(), p.detach().numpy())
        a, b = opt.state.get(p, {}), opt2.state[q]
        for k in ("exp_avg", "exp_avg_sq"):
            want = a[k].numpy() if a else np.zeros(tuple(p.shape), np.float32)
            np.testing.assert_array_equal(b[k].numpy(), want)
        assert float(b["step"]) == (float(a["step"]) if a else 0.0)


def test_checkpoint_shape_mismatch(tmp_path):
    scene = _scene(0, n=16)
    opt = make_optimizer(scene)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, scene, opt, 0)
    bigger = _scene(1, n=32)
    before = scene_to_numpy(bigger)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, bigger, make_optimizer(bigger))
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(scene_to_numpy(bigger)[f], before[f])


def test_resumed_run_draws_the_same_views(tmp_path):
    """Four views, one per step: a run resumed at step 3 logs the same
    losses for steps 4-6 as the uninterrupted run, which it can only do
    drawing the same views from a restored scene and optimizer."""
    scene = _scene(3, n=30)
    cams = [Camera.create(np.asarray(jax_look_at(
        [0.3 * i, 0.0, -0.5], [0.0, 0.0, 4.0], up=(0.0, -1.0, 0.0))),
        32, 32, fx=32.0, fy=32.0, znear=0.2, zfar=10.0, device="cpu")
        for i in range(4)]
    with torch.no_grad():
        targets = torch.stack([render(scene, c, CFG).image for c in cams])
    init = dataclasses.replace(scene, opacity_logits=scene.opacity_logits - 1)
    kw = dict(steps=6, lr=1e-2, ssim_weight=0.2, seed=5, log_every=1,
              checkpoint_every=3, position_lr_final_ratio=0.1)
    _, rows = fit(init, cams, targets, CFG,
                  checkpoint_dir=str(tmp_path / "a"), **kw)
    _, resumed = fit(init, cams, targets, CFG,
                     checkpoint_dir=str(tmp_path / "b"),
                     resume=str(tmp_path / "a" / "ckpt_000003.npz"), **kw)
    assert [r["step"] for r in resumed] == [4, 5, 6]
    np.testing.assert_allclose([r["loss"] for r in resumed],
                               [r["loss"] for r in rows[3:]], rtol=1e-6)
    losses = {r["loss"] for r in rows}
    assert len(losses) == len(rows)  # the views differ step to step
