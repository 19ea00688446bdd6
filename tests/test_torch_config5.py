"""The port of scripts/probe_config5_memory.py (`gsplat_tpu_torch.
config5_memory`) on the CPU: its constants and config are the script's
(read with `ast`: the script compiles the step when imported), its
analytic wire bytes are the port's `exchange_bytes`, the proxy's first
loss is the JAX step's on the same scene, and the ranks' first loss (two
gloo ranks) is the single-device step's."""

import ast
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import Camera as JaxCamera  # noqa: E402
from gsplat_tpu import RenderConfig as JaxConfig  # noqa: E402
from gsplat_tpu.models.gaussians import GaussianScene as JaxScene  # noqa: E402
from gsplat_tpu.parallel.train_step import init_train_state  # noqa: E402
from gsplat_tpu.parallel.train_step import make_optimizer as jax_make_optimizer  # noqa: E402
from gsplat_tpu.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from gsplat_tpu_torch import config5_memory as c5  # noqa: E402
from gsplat_tpu_torch.convert import scene_to_numpy  # noqa: E402
from gsplat_tpu_torch.ops.camera import Camera  # noqa: E402
from gsplat_tpu_torch.parallel.gaussian_sharded import exchange_bytes  # noqa: E402
from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402

SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
          / "probe_config5_memory.py")
# The reduced size of the CPU runs: the proxy's shard is N // 16.
SMALL = ["--device", "cpu", "--width", "256", "--height", "128",
         "--max-intersections", "65536"]
N_PROXY, N_RANKS = 4096, 2048


def _script_constants():
    """The script's module-level numbers and its RenderConfig's keywords,
    each name resolved against the numbers before it."""
    tree = ast.parse(SCRIPT.read_text())
    consts, cfg = {}, None
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        target, value = node.targets[0], node.value
        if isinstance(value, ast.Call) and getattr(
                value.func, "id", None) == "RenderConfig":
            cfg = {kw.arg: (consts[kw.value.id] if isinstance(
                kw.value, ast.Name) else ast.literal_eval(kw.value))
                for kw in value.keywords}
        elif isinstance(target, ast.Tuple):
            for t, v in zip(target.elts, value.elts):
                consts[t.id] = ast.literal_eval(v)
        elif isinstance(target, ast.Name) and isinstance(value, ast.BinOp):
            consts[target.id] = eval(compile(ast.Expression(value), "c",
                                             "eval"), {}, dict(consts))
        elif isinstance(target, ast.Name):
            try:
                consts[target.id] = ast.literal_eval(value)
            except ValueError:
                pass
    return consts, cfg


def _run(capsys, argv) -> dict:
    assert c5.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_constants_and_config_are_the_scripts():
    consts, cfg = _script_constants()
    assert {k: consts[k] for k in ("N_TOTAL", "D", "N_SHARD", "W", "H",
                                   "PER_DEST_CAP")} == dict(
        N_TOTAL=c5.N_TOTAL, D=c5.D, N_SHARD=c5.N_SHARD, W=c5.W, H=c5.H,
        PER_DEST_CAP=c5.PER_DEST_CAP)
    assert cfg.pop("impl") == "pallas"  # the TPU rasterizer: no counterpart
    assert cfg == c5.CONFIG5
    port = c5.config5_cfg()
    assert (port.width, port.height, port.num_tiles) == (3840, 2048, 7680)


def test_wire_bytes_are_exchange_bytes():
    per_rank = sum(exchange_bytes(c5.config5_cfg(), c5.D,
                                  c5.PER_DEST_CAP).values()) // c5.D
    assert c5.a2a_wire_bytes_analytic() == per_rank == 387_200_000


def test_proxy_on_cpu_matches_jax_step(capsys):
    out = _run(capsys, ["--n-total", str(N_PROXY), *SMALL])
    assert {"config", "mode", "memory", "a2a_wire_bytes_analytic",
            "device"} <= out.keys()
    assert out["mode"] == "per-shard-proxy-1dev"
    assert out["config"]["n_shard"] == N_PROXY // c5.D
    assert out["memory"] == dict.fromkeys(c5.MEMORY_FIELDS)  # no allocator
    assert out["device"] == {"name": "cpu", "power_limit": None}
    steps = out["steps"]
    assert steps["bit_identical"] and steps["finite"]
    assert not steps["overflow"]
    assert len(steps["losses"]) == c5.STEPS + 1

    # The JAX step at the same config on the same scene, carried as numpy.
    scene = c5.config5_scene(N_PROXY // c5.D, "cpu")
    jscene = JaxScene(**{k: jnp.asarray(v)
                         for k, v in scene_to_numpy(scene).items()})
    jcfg = JaxConfig(**dict(c5.CONFIG5, width=256, height=128,
                            max_intersections=65536, pallas_interpret=True))
    jopt = jax_make_optimizer(c5.LR)
    jcam = JaxCamera.default(256, 128)
    _, jloss, jaux, _ = jax_make_train_step(jcfg, jopt, ssim_weight=0.0)(
        init_train_state(jscene, jopt), jax.tree.map(lambda x: x[None], jcam),
        jnp.zeros((1, 128, 256, 3), jnp.float32))
    assert not bool(jaux["overflow"])
    np.testing.assert_allclose(steps["losses"][0], float(jloss), rtol=1e-5)


def test_ranks_on_gloo_match_single_device_step(capsys):
    out = _run(capsys, ["--mode", "ranks", "--n-total", str(N_RANKS),
                        *SMALL])
    assert out["mode"] == "gaussian-sharded-2-ranks"
    assert out["backend"] == "gloo"
    caps = out["capacity"]
    assert caps["max_intersections"] >= 1.15 * max(caps["demand"][0])
    assert caps["per_dest_capacity"] >= 1.15 * max(
        o["max_segment"] for o in caps["occupancy"]) - 1
    assert out["config"]["per_dest_capacity"] == caps["per_dest_capacity"]
    assert out["a2a_wire_bytes_analytic"] == sum(
        out["exchange_bytes_per_step"].values()) // 2
    assert out["memory"] == [dict.fromkeys(c5.MEMORY_FIELDS)] * 2
    losses = {r["rank"]: r["losses"] for r in out["steps"]}
    assert losses[0] == losses[1]
    for r in out["steps"]:
        assert r["bit_identical"] and r["finite"] and not r["overflow"]

    # The single-device step on the whole scene, room for every slot.
    cfg = c5.config5_cfg(256, 128, 65536)
    scene = c5.config5_scene(N_RANKS, "cpu")
    step = make_train_step(cfg, make_optimizer(scene, c5.LR), 0.0)
    loss, aux, _ = step(scene, [Camera.default(256, 128, device="cpu")],
                        torch.zeros((1, 128, 256, 3)))
    assert not bool(aux["overflow"])
    assert np.isfinite(losses[0][0])
    np.testing.assert_allclose(losses[0][0], float(loss), rtol=1e-5)


@pytest.mark.parametrize("where", ["binning", "merge"])
def test_stream_past_int32_is_refused(where):
    """A stream whose slots int32 cannot index (max_intersections, or D x
    per_dest_capacity of the Gaussian-sharded merge, past 2^31 - 1) is
    refused before anything is allocated."""
    from gsplat_tpu_torch.ops.binning import MAX_STREAM_SLOTS, bin_gaussians
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.parallel.gaussian_sharded import render_gaussian_sharded
    from gsplat_tpu_torch.parallel.sharding import make_mesh

    scene = c5.config5_scene(64, "cpu")
    cam = Camera.default(256, 128, device="cpu")
    cfg = c5.config5_cfg(256, 128, 65536)
    with pytest.raises(ValueError, match="int32"):
        if where == "binning":
            big = c5.config5_cfg(256, 128, MAX_STREAM_SLOTS + 1)
            bin_gaussians(project_gaussians(scene, cam, big), big)
        else:
            render_gaussian_sharded(scene, cam, cfg,
                                    make_mesh({"gauss": 1}, "cpu"),
                                    per_dest_capacity=MAX_STREAM_SLOTS + 1)
    # At the bound's side of the line the same calls run.
    bin_gaussians(project_gaussians(scene, cam, cfg), cfg)
