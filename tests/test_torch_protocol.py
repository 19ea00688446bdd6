"""The port's training protocol (`gsplat_tpu_torch.train_protocol`) and its
sharded smoke (`gsplat_tpu_torch.train_sharded_smoke`) against
`scripts/train_protocol.py` (CPU): the capacity sizing on the same scenes
and cameras, the sizing plan against the reference runs' own sizing lines,
the init on given draws, and short runs of both entry points."""

import ast
import importlib.util
import json
import os
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu import random_scene as jax_random_scene  # noqa: E402
from gsplat_tpu.models.gaussians import GaussianScene as JaxScene  # noqa: E402
from gsplat_tpu.models.gaussians import realistic_scene as jax_realistic  # noqa: E402
from gsplat_tpu.ops.camera import orbit_cameras as jax_orbit  # noqa: E402
from gsplat_tpu_torch import RenderConfig  # noqa: E402
from gsplat_tpu_torch import train_protocol as tp  # noqa: E402
from gsplat_tpu_torch import train_sharded_smoke  # noqa: E402
from gsplat_tpu_torch.convert import camera_from_numpy, scene_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "focal", "tan_fov",
              "znear")


@pytest.fixture(scope="module")
def jax_script():
    """scripts/train_protocol.py as a module (a script, not in a package)."""
    spec = importlib.util.spec_from_file_location(
        "train_protocol_jax", ROOT / "scripts" / "train_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_scene(js):
    return scene_from_numpy(*(np.asarray(getattr(js, f)) for f in FIELDS),
                            device="cpu")


@pytest.mark.parametrize("run", ["protocol_r4", "protocol_r5_1024"])
def test_sized_plan_reproduces_the_reference_runs(run):
    """The sizing line each reference run logged: its measured membership
    and total give its tier spec and stream capacity."""
    line = next(x for x in (ROOT / "runs" / f"{run}.log").read_text()
                .splitlines() if x.startswith("sized:"))
    members = ast.literal_eval(re.search(r"members=(\{.*?\})", line)[1])
    total = int(re.search(r"worst_total=(\d+)", line)[1])
    spec = ast.literal_eval(re.search(r"tier_spec=(\[.*?\]) ", line)[1])
    max_i = int(re.search(r"max_intersections=(\d+)", line)[1])
    with open(ROOT / "runs" / run / "run_meta.json") as f:
        capacity = json.load(f)["args"]["capacity"]
    assert tp.sized_plan(members, total, capacity) == (spec, max_i)


def test_sized_plan_of_the_512_run():
    assert tp.sized_plan({4: 120000, 8: 119077, 16: 49131, 32: 3259},
                         1885404, 256_000) == (
        [(4, 0), (8, 1), (16, 1), (32, 1), (64, 18)], 4714496)


def test_size_capacities_matches_jax(jax_script):
    """The same scenes and orbit cameras through both functions, the JAX
    probe config at impl='jnp'."""
    s = 96
    # Both scenes of one size: the JAX probe compiles once.
    target = jax_realistic(jax.random.key(3), 1500)
    target = target.replace(means=target.means - target.means.mean(0))
    init = jax_random_scene(jax.random.key(4), 1500, sh_degree=3)
    init = init.replace(means=(init.means - init.means.mean(0)) * 0.4)
    radius = 2.5 * float(np.percentile(
        np.linalg.norm(np.asarray(target.means), axis=-1), 90))
    jcams = jax_orbit(np.zeros(3), radius, 3, s, s, fx=float(s), fy=float(s))
    jcfg = JaxConfig(width=s, height=s, impl="jnp", **tp.PROBE)
    want = jax_script.size_capacities([target, init], jcams, jcfg, tp.KMAX)
    cams = [camera_from_numpy(*(np.asarray(getattr(c, f)) for f in CAM_FIELDS),
                              device="cpu") for c in jcams]
    got = tp.size_capacities([_port_scene(target), _port_scene(init)], cams,
                             RenderConfig(width=s, height=s, **tp.PROBE),
                             tp.KMAX)
    assert got == want
    assert got[0][4] > got[0][8] > 0 and got[1] > 0 and got[2] > 4


@pytest.mark.parametrize("init", ["sfm", "random"])
def test_protocol_init_follows_the_recipe(init):
    """protocol_init on given numpy draws against the JAX script's lines
    (scripts/train_protocol.py:162-228) on the same draws."""
    rng = np.random.default_rng(7)
    # The scene sizes of test_size_capacities_matches_jax, whose JAX scene
    # programs are then compiled already; sel permutes the target.
    n_t, n, cap = 1500, 1500, 1600
    target = jax_realistic(jax.random.key(5), n_t)
    target = target.replace(means=target.means - target.means.mean(0))
    base = jax_random_scene(jax.random.key(6), n, sh_degree=3)
    radius = 2.5 * float(np.percentile(
        np.linalg.norm(np.asarray(target.means), axis=-1), 90))
    max_log_scale = float(np.log(0.05 * radius))
    sel = rng.choice(n_t, n, replace=False)
    jitter = (0.01 * radius * rng.standard_normal((n, 3))).astype(np.float32)
    dc_noise = (0.1 * rng.standard_normal((n, 1, 3))).astype(np.float32)

    # The JAX script's recipe on these draws.
    want = base
    if init == "sfm":
        want = want.replace(
            means=jnp.take(target.means, sel, axis=0) + jitter,
            sh=want.sh.at[:, 0:1].set(
                jnp.take(target.sh[:, 0:1], sel, axis=0) + dc_noise))
    nn_spacing = radius / max(n, 1) ** (1.0 / 3.0)
    want = want.replace(
        means=want.means if init == "sfm"
        else (want.means - want.means.mean(0)) * (radius / 2.5),
        log_scales=jnp.minimum(jnp.full_like(want.log_scales,
                                             np.log(nn_spacing)),
                               max_log_scale),
        opacity_logits=jnp.full_like(want.opacity_logits, -2.197),
        sh=want.sh.at[:, 1:].set(0.0),
    ).pad_to(cap)
    assert isinstance(want, JaxScene)

    got = tp.protocol_init(_port_scene(base), _port_scene(target),
                           torch.from_numpy(sel), torch.from_numpy(jitter),
                           torch.from_numpy(dc_noise), radius, cap, init,
                           max_log_scale)
    assert got.num_gaussians == cap
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "means" and init == "random":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert float(got.log_scales[0, 0]) <= max_log_scale


def test_init_draws_are_seeded_and_distinct():
    sel, jitter, dc = tp.init_draws(3, 500, 200, 2.0, "cpu")
    sel2, jitter2, dc2 = tp.init_draws(3, 500, 200, 2.0, "cpu")
    assert torch.equal(sel, sel2) and torch.equal(jitter, jitter2)
    assert torch.equal(dc, dc2)
    assert sel.unique().numel() == 200 and int(sel.max()) < 500
    assert jitter.shape == (200, 3) and dc.shape == (200, 1, 3)


def test_train_protocol_short_run_writes_the_jax_summary(tmp_path, capsys):
    """10 steps at 48x48 on the CPU: the JAX run's summary keys, its files,
    and a second run into the same directory refused."""
    out = tmp_path / "run"
    argv = ["--size", "48", "--target-n", "600", "--init-n", "300",
            "--capacity", "500", "--views", "3", "--holdout", "1",
            "--steps", "10", "--eval-every", "5", "--log-every", "5",
            "--device", "cpu", "--out-dir", str(out)]
    summary = tp.main(argv)
    with open(ROOT / "runs" / "protocol_r5_512" / "summary.json") as f:
        want_keys = list(json.load(f))
    with open(out / "summary.json") as f:
        assert list(json.load(f)) == want_keys
    assert list(summary) == want_keys
    assert np.isfinite(summary["holdout_psnr"]) and summary["steps"] == 10
    for name in ("metrics.csv", "run_meta.json", "trained.ply",
                 "target_v0.png", "fitted_v0.png", "fitted_holdout.png",
                 "target_holdout.png"):
        assert (out / name).exists(), name
    assert "sized: members=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="one run per directory"):
        tp.main(argv)


def test_sharded_smoke_runs_on_two_gloo_ranks(tmp_path, monkeypatch):
    """A few steps of the sharded smoke on 2 CPU ranks (tiles 2) over gloo:
    rank 0's summary with the JAX script's keys."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "smoke"
    summary = train_sharded_smoke.main([
        "--dist-backend", "gloo", "--device", "cpu", "--data", "1",
        "--tiles", "2", "--steps", "3", "--size", "32", "--target-n", "300",
        "--init-n", "150", "--capacity", "400", "--views", "2",
        "--out-dir", str(out)])
    with open(ROOT / "runs" / "sharded_smoke" / "summary.json") as f:
        jax_keys = set(json.load(f))
    assert set(summary) == jax_keys
    assert summary["mesh"] == {"data": 1, "tiles": 2}
    assert np.isfinite(summary["loss_last"]) and summary["psnr_first"] > 0
    assert os.path.exists(out / "metrics.csv")
    # No densify round within 3 steps: no more alive than the init's 150.
    assert summary["alive_last"] <= 150
    with pytest.raises(AssertionError, match="densify"):
        train_sharded_smoke.check(dict(summary, loss_last=-1.0,
                                       psnr_last=99.0), 150)
