"""The 2D Gaussian splatting cell resolves by name (its configuration,
traffic, kind, limits and metric readers), and a tiny copy of it runs end
to end on the CPU through the program's plain paths: correct against its
limits, and not correct with the reference in bfloat16, or with the
filter taken out, the distortion left out of the loss, the normal left
unflipped or half of the batch left out, in the program's place."""

import copy
import importlib
import time
import types

import pytest
import torch

from splatbench import run
from splatbench.kinds import train_surfels
from splatbench.tests import helpers

CELL = "2dgs-garden-1m-1080p.train"
TINY = "tiny-2dgs.train"
SEED = 2 ** 33 + 5
NUMBERS = {"first_loss_gap", "later_loss_gap", "grad_median_gap",
           "grad_worst_gap", "change_gap", "normal_rmse", "depth_rmse",
           "distortion_rmse"}


def _spec() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def test_surfel_cell_resolves_by_name():
    spec = _spec()
    cell = run.find_cell(spec, CELL)
    config, traffic = run.load_cell(cell)
    kind = importlib.import_module(f"splatbench.kinds.{traffic['kind']}")
    for fn in ("setup", "window", "traced_window", "wind_down", "numbers",
               "control", "work"):
        assert callable(getattr(kind, fn))
    assert set(run.load_limits(CELL)) == NUMBERS
    layer = {m["name"] for m in run.cell_metrics(spec, "per_layer", CELL)}
    assert {"k10_roofline", "k11_roofline", "k12_roofline", "k13_roofline",
            "reg_ms.step", "step_mfu_pct", "blend_ms.step"} <= layer
    for name in layer:
        assert callable(run.metric_reader(name))
    assert {"step_ms", "setup_s", "peak_mem_gib"} == {
        m["name"] for m in run.cell_metrics(spec, "end_to_end", CELL)}
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    assert (run.ROOT / conf["file"]).exists() and conf["reduced"] == []


def test_surfel_config_is_gardens_but_for_its_slots():
    config, _ = run.load_cell(run.find_cell(_spec(), CELL))
    garden = run.load_json(run.HERE / "configs" / "garden-1m-1080p.json")
    for key in ("scene", "train"):
        assert config[key] == garden[key]
    # The surfel path's own slots and float32 table stream; garden's EWA
    # fields, which no surfel reads, left out.
    ewa = {"lowpass", "radius_sigma", "eigen_clamp"}
    assert set(garden["render"]) - set(config["render"]) == ewa
    differ = {k for k in garden["render"]
              if k not in ewa and config["render"][k] != garden["render"][k]}
    assert differ == {"max_intersections", "stream_format",
                      "gather_backward", "grad_readout"}
    assert (config["render"]["stream_format"],
            config["render"]["gather_backward"],
            config["render"]["grad_readout"]) == ("f32", "variadic", "f32")
    assert config["surfels"]["lambda_dist"] == 100
    assert config["surfels"]["lambda_normal"] == 0.05
    assert config["surfels"]["filter_inv_square"] == 2.0


def _tiny_spec() -> tuple[dict, dict]:
    spec = _spec()
    cell = dict(run.find_cell(spec, CELL), name=TINY, config="tiny-2dgs")
    spec["workloads"] = [cell]
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if "workloads" in m:
                m["workloads"] = [TINY if w == CELL else w
                                  for w in m["workloads"]]
    return spec, cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_surfel_cell_runs_and_is_correct(trace):
    spec, cell = _tiny_spec()
    res = run.run_cell(spec, cell, SEED, 0.3, trace, torch.device("cpu"),
                       time.perf_counter(), helpers.DATA)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    if not trace:
        assert {"step_ms", "setup_s", "peak_mem_gib"} <= set(res["metrics"])
    assert set(res["checks"]) == NUMBERS


def test_tiny_surfel_controls_and_faults_read_not_correct():
    from splatbench import compare

    spec, cell = _tiny_spec()
    config, traffic = run.load_cell(cell, helpers.DATA)
    limits = run.load_limits(TINY, helpers.DATA)
    ctx = types.SimpleNamespace(config=copy.deepcopy(config), traffic=traffic,
                                seed=SEED, device=torch.device("cpu"))
    train_surfels.setup(ctx)
    train_surfels.window(ctx, 0.1)
    train_surfels.wind_down(ctx, False)
    assert compare.judge(train_surfels.numbers(ctx), limits)[0]
    for fault in (None, "half", "no_filter", "no_distortion", "no_flip"):
        ok, checks = compare.judge(train_surfels.control(ctx, fault), limits)
        assert not ok, (fault, checks)
