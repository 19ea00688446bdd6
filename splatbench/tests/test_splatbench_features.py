"""The Feature 3DGS cell resolves by name (its configuration, traffic,
kind, limits and metric readers), and a tiny copy of it runs end to end on
the CPU through the program's plain paths: correct against its limits, and
not correct with the reference in bfloat16 or with the feature rows in
bfloat16 in the program's place."""

import copy
import importlib
import time
import types

import pytest
import torch

from splatbench import run
from splatbench.kinds import train_features
from splatbench.tests import helpers

FEAT = "feat3dgs-garden-1m-1080p.train"
TINY = "tiny-feat3dgs.train"
SEED = 2 ** 33 + 5


def _spec() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def test_feature_cell_resolves_by_name():
    spec, name = _spec(), FEAT
    cell = run.find_cell(spec, name)
    config, traffic = run.load_cell(cell)
    kind = importlib.import_module(f"splatbench.kinds.{traffic['kind']}")
    for fn in ("setup", "window", "traced_window", "wind_down", "numbers",
               "control", "work"):
        assert callable(getattr(kind, fn))
    assert run.load_limits(name), f"no limits for {name}"
    for section in ("end_to_end", "per_layer"):
        for m in run.cell_metrics(spec, section, name):
            if section == "per_layer":
                assert callable(run.metric_reader(m["name"]))
    assert {"setup_s", "peak_mem_gib"} <= {
        m["name"] for m in run.cell_metrics(spec, "end_to_end", name)}
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    assert (run.ROOT / conf["file"]).exists()


def test_feature_cell_numbers_match_its_limits():
    config, traffic = run.load_cell(run.find_cell(_spec(), FEAT))
    assert config["features"]["channels"] == 128
    assert config["features"]["decoder_out"] == 512
    assert set(run.load_limits(FEAT)) == {
        "first_loss_gap", "later_loss_gap", "grad_median_gap",
        "grad_worst_gap", "change_gap", "feature_rmse",
        "decoder_grad_gap"}
    garden = run.load_json(run.HERE / "configs" / "garden-1m-1080p.json")
    for key in ("scene", "render", "train"):
        assert config[key] == garden[key]


def _tiny_spec() -> tuple[dict, dict]:
    spec = _spec()
    cell = dict(run.find_cell(spec, FEAT), name=TINY, config="tiny-feat3dgs")
    spec["workloads"] = [cell]
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if "workloads" in m:
                m["workloads"] = [TINY if w == FEAT else w
                                  for w in m["workloads"]]
    return spec, cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_feature_cell_runs_and_is_correct(trace):
    spec, cell = _tiny_spec()
    res = run.run_cell(spec, cell, SEED, 0.3, trace, torch.device("cpu"),
                       time.perf_counter(), helpers.DATA)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    if not trace:
        assert {"step_ms", "setup_s", "peak_mem_gib"} <= set(res["metrics"])


def test_tiny_feature_controls_read_not_correct():
    from splatbench import compare

    spec, cell = _tiny_spec()
    config, traffic = run.load_cell(cell, helpers.DATA)
    limits = run.load_limits(TINY, helpers.DATA)
    ctx = types.SimpleNamespace(config=copy.deepcopy(config), traffic=traffic,
                                seed=SEED, device=torch.device("cpu"))
    train_features.setup(ctx)
    train_features.window(ctx, 0.1)
    train_features.wind_down(ctx, False)
    assert compare.judge(train_features.numbers(ctx), limits)[0]
    for fault in (None, "bf16_rows", "half"):
        ok, checks = compare.judge(train_features.control(ctx, fault), limits)
        assert not ok, (fault, checks)
