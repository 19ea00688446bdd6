"""A tiny cell of each kind runs end to end on the CPU, through the
program's plain paths, and gives the contract's line; without a card the
command prints no line and exits non-zero."""

import os
import shutil
import subprocess
import sys

import pytest

from splatbench import run
from splatbench.tests import helpers

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", [helpers.TRAIN, helpers.RENDER])
def test_tiny_cell_line(cell):
    res = helpers.line(helpers.run_tiny(cell))
    assert list(res)[:5] == LINE_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = helpers.spec()
    want = {m["name"] for m in run.cell_metrics(spec, "end_to_end", cell)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values()
               if v["unit"] != "GiB")
    assert res["device"]["count"] == 1
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", [helpers.TRAIN, helpers.RENDER])
def test_tiny_cell_traced_line(cell):
    res = helpers.line(helpers.run_tiny(cell, trace=True))
    assert res["correct"] is True, res["checks"]
    dev = res["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] >= 0
    spec = helpers.spec()
    allowed = {m["name"] for m in run.cell_metrics(spec, "per_layer", cell)}
    # On the CPU no kernel runs on a card: the readers of kernel times
    # return nothing, the MFU share and the idle share read.
    assert set(res["metrics"]) <= allowed and res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())


def _command(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "splatbench/run.py", "--workload",
         "garden-1m-1080p.train", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_line():
    p = _command(run.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_line(tmp_path):
    """A directory holding only BENCHMARK.json and splatbench/."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["gsplat_tpu_torch", "gsplat_tpu_torch.ops",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["gsplat_tpu.ops", "jax.numpy"]) == [
        "gsplat_tpu", "jax"]
