"""Adaptive density control of the port against the JAX package (CPU): the
same numpy scene and accumulator through both `densify_and_prune`s give
the same changed mask and stats exactly and the same scene within rtol
1e-6; `accumulate_grads`, `reset_opacity` and `mask_opt_moments` (against
optax's mu / nu) likewise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.train import densify as jd  # noqa: E402
from gsplat_tpu_torch.convert import (  # noqa: E402
    scene_adam_from_numpy,
    scene_from_numpy,
    scene_to_numpy,
)
from gsplat_tpu_torch.train import densify as td  # noqa: E402
from gsplat_tpu_torch.train.loop import make_optimizer  # noqa: E402

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
# Scene arrays: rtol 1e-6 (the split children's rotations and scales may
# round an ulp apart); atol 1e-6 for the children's means x +/- offset, which
# can cancel to near zero and keep the rounding of |x| up to 6 (an ulp of
# 4.8e-7).
RTOL, ATOL = 1e-6, 1e-6


def np_scene(jscene):
    return {f: np.array(getattr(jscene, f)) for f in SCENE_FIELDS}


# Every case has this capacity and SH degree, and the thresholds ride as
# traced arguments, so the JAX round compiles once for the file. A
# max_world_scale past every splat prunes nothing, as None does.
CAP, DEGREE = 64, 1
NO_BOUND = 1e30


@jax.jit
def jax_round(scene, state, grad_threshold, max_world_scale):
    return jd.densify_and_prune(scene, state, grad_threshold=grad_threshold,
                                max_world_scale=max_world_scale)


def run_both(scene_np, grad_accum, visit_count, count=1,
             grad_threshold=2e-4, max_world_scale=None):
    """densify_and_prune of both packages on the same arrays; asserts the
    results agree and returns the port's."""
    jscene = jax_random_scene(jax.random.key(0), 1, sh_degree=0).replace(
        **{f: jnp.asarray(v) for f, v in scene_np.items()})
    jstate = jd.DensifyState(
        grad_accum=jnp.asarray(grad_accum, jnp.float32),
        count=jnp.asarray(count, jnp.int32),
        visit_count=jnp.asarray(visit_count, jnp.int32))
    jout, jfresh, jchanged, jstats = jax_round(
        jscene, jstate, jnp.float32(grad_threshold),
        jnp.float32(NO_BOUND if max_world_scale is None else max_world_scale))
    kw = dict(grad_threshold=grad_threshold, max_world_scale=max_world_scale)

    scene = scene_from_numpy(**scene_np, device="cpu")
    state = td.DensifyState(
        grad_accum=torch.tensor(grad_accum, dtype=torch.float32),
        count=torch.tensor(count, dtype=torch.int32),
        visit_count=torch.tensor(visit_count, dtype=torch.int32))
    out, fresh, changed, stats = td.densify_and_prune(scene, state, **kw)

    np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))
    assert {k: int(v) for k, v in stats.items()} == \
        {k: int(v) for k, v in jstats.items()}
    got = scene_to_numpy(out)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(jout, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert int(fresh.count) == int(jfresh.count) == 0
    assert float(fresh.grad_accum.abs().sum()) == 0.0
    # The inputs are left as they were.
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(scene, f).numpy(), scene_np[f])
    return out, changed, stats


def _scene(n, cap=CAP, seed=0, degree=DEGREE):
    return np_scene(jax_random_scene(jax.random.key(seed), n,
                                     sh_degree=degree).pad_to(cap))


def test_prune_split_clone_and_big_splats():
    """Transparent slots pruned, big-and-quiet splats pruned by
    max_world_scale, big splats with a gradient split first, small ones
    cloned, with free capacity to spare."""
    cap, n = CAP, 40
    s = _scene(n, seed=1)
    rng = np.random.default_rng(0)
    s["opacity_logits"][:4] = -10.0                      # transparent
    s["log_scales"][4:8] = np.log(0.8)                   # big, quiet
    s["log_scales"][8:12] = np.log(0.8)                  # big, triggered
    s["log_scales"][12:20] = np.log(0.004)               # small: clones
    s["opacity_logits"][4:20] = 2.0
    grad = np.zeros(cap, np.float32)
    grad[8:n] = rng.uniform(3e-4, 1e-2, n - 8)
    visits = rng.integers(1, 4, cap).astype(np.int32)
    grad *= visits
    out, changed, stats = run_both(s, grad, visits, count=3,
                                   max_world_scale=0.5)
    assert int(stats["num_split"]) > 0 and int(stats["num_clone"]) > 0
    assert not bool(stats["saturated"])
    assert bool(changed[:8].all())


@pytest.mark.parametrize("threshold", [2e-4, 0.0])
def test_random_round_matches_jax(threshold):
    cap, n = CAP, 48
    s = _scene(n, seed=2)
    rng = np.random.default_rng(1)
    grad = rng.exponential(4e-4, cap).astype(np.float32)
    grad[n:] = 0.0
    visits = rng.integers(0, 3, cap).astype(np.int32)
    run_both(s, grad, visits, grad_threshold=threshold)


def test_saturated_round_is_a_no_op():
    """No free slot: nothing changes, and the saturated flag is set."""
    cap = CAP
    s = _scene(cap, seed=3)
    s["opacity_logits"][:] = 3.0
    s["log_scales"][:] = np.log(0.5)
    out, changed, stats = run_both(s, np.ones(cap, np.float32),
                                   np.ones(cap, np.int32))
    assert bool(stats["saturated"]) and not bool(changed.any())
    assert int(stats["num_alive"]) == cap


def test_partially_saturated_round_admits_the_budget():
    """16 free slots, 48 wanted splits: the 16 largest gradients split."""
    cap, n = CAP, 48
    s = _scene(n, seed=4)
    s["opacity_logits"][:n] = 3.0
    s["log_scales"][:n] = np.log(0.5)
    grad = np.zeros(cap, np.float32)
    grad[:n] = np.random.default_rng(2).uniform(1e-3, 1.0, n)
    out, changed, stats = run_both(s, grad, np.ones(cap, np.int32))
    assert bool(stats["saturated"]) and int(stats["num_split"]) == 16
    assert int(stats["num_alive"]) == cap


def test_tied_scores_at_the_cutoff():
    """Equal scores straddle the admission cutoff: both packages admit them
    in slot order (a stable sort), also with the big-splat priority and
    the pruning of big splats whose split was not admitted."""
    cap, n = CAP, 58
    s = _scene(n, seed=5)
    s["opacity_logits"][:n] = 3.0
    s["log_scales"][:n] = np.log(0.02)
    s["log_scales"][[3, 17, 29]] = np.log(0.9)   # big: first in line
    grad = np.zeros(cap, np.float32)
    grad[:n] = 5e-3
    grad[[1, 2]] = 7e-3
    out, changed, stats = run_both(s, grad, np.ones(cap, np.int32),
                                   max_world_scale=0.5)
    assert bool(stats["saturated"])
    # Fewer tied free slots than the tied ops: the rest keep their slots.
    assert 0 < int(stats["num_split"]) < n


def test_accumulate_grads_matches_jax():
    rng = np.random.default_rng(7)
    cap = 50
    st = td.init_densify_state(cap, "cpu")
    jst = jd.init_densify_state(cap)
    for vis in (None, rng.random(cap) < 0.5):
        g = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-3
        st = td.accumulate_grads(st, torch.from_numpy(g),
                                 None if vis is None else torch.from_numpy(vis))
        jst = jd.accumulate_grads(jst, jnp.asarray(g),
                                  None if vis is None else jnp.asarray(vis))
    np.testing.assert_allclose(st.grad_accum.numpy(),
                               np.asarray(jst.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(st.visit_count.numpy(),
                                  np.asarray(jst.visit_count))
    assert int(st.count) == int(jst.count) == 2
    np.testing.assert_array_equal(
        td.alive_mask(scene_from_numpy(**_scene(8, 12), device="cpu")).numpy(),
        np.asarray(jd.alive_mask(jax_random_scene(
            jax.random.key(0), 8, sh_degree=1).pad_to(12))))


def test_reset_opacity_matches_jax():
    s = _scene(4, 8)
    s["opacity_logits"] = np.array([5.0, -1.0, 2.0, -6.0] + [-30.0] * 4,
                                   np.float32)
    got = td.reset_opacity(scene_from_numpy(**s, device="cpu"))
    jscene = jax_random_scene(jax.random.key(0), 4, sh_degree=1).pad_to(8)
    want = jd.reset_opacity(jscene.replace(
        opacity_logits=jnp.asarray(s["opacity_logits"])))
    np.testing.assert_allclose(got.opacity_logits.numpy(),
                               np.asarray(want.opacity_logits), rtol=1e-6)
    assert float(got.opacity_logits[4]) == td.DEAD_OPACITY_LOGIT


def test_mask_opt_moments_matches_optax():
    """Adam moments after three updates, masked at the changed slots: equal
    to optax's mu / nu, a NaN moment at a changed slot included (the mask
    multiplies, so it stays NaN), the step counts untouched."""
    cap = 16
    jscene = jax_random_scene(jax.random.key(3), 10, sh_degree=1).pad_to(cap)
    scene = scene_from_numpy(**np_scene(jscene), device="cpu")
    opt = make_optimizer(scene, 1e-2)
    jopt = jax_make_optimizer(1e-2)
    jstate = init_train_state(jscene, jopt).opt_state
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = {f: rng.normal(size=getattr(jscene, f).shape).astype(np.float32)
             for f in SCENE_FIELDS}
        for f in SCENE_FIELDS:
            getattr(scene, f).grad = torch.from_numpy(g[f])
        opt.step()
        _, jstate = jopt.update(
            jscene.replace(**{f: jnp.asarray(g[f]) for f in SCENE_FIELDS}),
            jstate, jscene)
    # A NaN first moment of slot 2's means, in both.
    opt.state[scene.means]["exp_avg"][2, 0] = float("nan")
    adam = jstate.inner_states["means"].inner_state[0]
    jstate.inner_states["means"] = jstate.inner_states["means"]._replace(
        inner_state=(adam._replace(mu=adam.mu.replace(
            means=adam.mu.means.at[2, 0].set(jnp.nan))),)
        + jstate.inner_states["means"].inner_state[1:])

    changed = np.zeros(cap, bool)
    changed[[0, 2, 5, 11]] = True
    td.mask_opt_moments(opt, torch.from_numpy(changed))
    jmasked = jd.mask_opt_moments(jstate, jnp.asarray(changed))
    for group in opt.param_groups:
        f = group["name"]
        st = opt.state[group["params"][0]]
        jadam = jmasked.inner_states[f].inner_state[0]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(getattr(jadam.mu, f)),
                                   rtol=1e-6, atol=1e-8, err_msg=f)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(getattr(jadam.nu, f)),
                                   rtol=1e-6, atol=1e-8, err_msg=f)
        assert float(st["step"]) == int(jadam.count) == 3
    assert np.isnan(opt.state[scene.means]["exp_avg"][2, 0].item())
    assert float(opt.state[scene.means]["exp_avg"][0].abs().sum()) == 0.0


def test_scene_adam_from_numpy_continues_like_optax():
    """A SceneAdam built from optax's mu, nu and count takes the next
    update exactly as optax does, position-lr schedule included."""
    kw = dict(position_lr_final_ratio=0.1, lr_max_steps=5)
    jscene = jax_random_scene(jax.random.key(4), 12, sh_degree=1)
    jopt = jax_make_optimizer(1e-2, **kw)
    jstate = init_train_state(jscene, jopt).opt_state
    rng = np.random.default_rng(1)

    def grads():
        return {f: rng.normal(size=getattr(jscene, f).shape).astype(np.float32)
                for f in SCENE_FIELDS}

    for _ in range(3):
        g = grads()
        upd, jstate = jopt.update(
            jscene.replace(**{f: jnp.asarray(g[f]) for f in SCENE_FIELDS}),
            jstate, jscene)
        jscene = optax.apply_updates(jscene, upd)
    adam = {f: jstate.inner_states[f].inner_state[0] for f in SCENE_FIELDS}
    scene, opt = scene_adam_from_numpy(
        np_scene(jscene), {f: np.asarray(getattr(adam[f].mu, f))
                           for f in SCENE_FIELDS},
        {f: np.asarray(getattr(adam[f].nu, f)) for f in SCENE_FIELDS},
        int(adam["means"].count), 1e-2, device="cpu", **kw)
    g = grads()
    for f in SCENE_FIELDS:
        getattr(scene, f).grad = torch.from_numpy(g[f])
    opt.step()
    upd, jstate = jopt.update(
        jscene.replace(**{f: jnp.asarray(g[f]) for f in SCENE_FIELDS}),
        jstate, jscene)
    jscene = optax.apply_updates(jscene, upd)
    got = scene_to_numpy(scene)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(jscene, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert opt.updates == 4
