"""The record of stages and calls (`gsplat_tpu_torch/utils/trace.py`) on the
CPU, where every call runs its body eagerly and the record is host-only,
and the benchmark's reduction of a record with marks (`splatbench/stages.py`)
on a synthetic one."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsplat_tpu_torch import Camera, RenderConfig, random_scene, render_jit
from gsplat_tpu_torch.ops.cuda import counters
from gsplat_tpu_torch.render.pipeline import STAGES
from gsplat_tpu_torch.train.loop import (
    TRAIN_SPANS,
    make_optimizer,
    make_train_step,
)
from gsplat_tpu_torch.utils import graphs, trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench import stages  # noqa: E402

KW = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
          block_size=8, max_per_tile=256, binning="tiered")
NEW_METRICS = [m["name"] for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if m["name"].split(".")[0] in (
        "project_ms", "bin_ms", "gather_ms", "blend_ms", "loss_ms", "adam_ms",
        "launch_gap_ms", "bin_useful_pct")]


@pytest.fixture
def scene_cam():
    trace.drain()
    scene = random_scene(120, 1, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    yield scene, Camera.default(64, 64, device="cpu")
    trace.drain()


def _in_order(spans) -> list:
    return [s[0] for s in sorted(spans, key=lambda s: s[1])]


def test_eager_render_records_its_stages_in_order(scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(**KW)
    with trace.recording():
        render_jit(scene, cam, cfg)
        render_jit(scene, cam, cfg)
    rec = trace.drain()
    assert [c["call"] for c in rec["calls"]] == [1, 2]
    assert rec["lost"] == 0 and rec["lost_calls"] == 0 and rec["clock"] == {}
    for c in rec["calls"]:
        assert c["kind"] == "render" and c["replay"] is False
        assert list(c["spans"]) == ["body"] and "marks" not in c
        assert _in_order(c["stages"]) == list(STAGES)
        t0, t1 = c["spans"]["body"]
        assert all(t0 <= a <= b <= t1 for _, a, b in c["stages"])
    assert trace.drain()["calls"] == []


def test_eager_train_step_records_its_stages_in_order(scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(**KW)
    step = make_train_step(cfg, make_optimizer(scene), ssim_weight=0.2)
    target = torch.full((1, 64, 64, 3), 0.5)
    step(scene, [cam], target)
    with trace.recording():
        for _ in range(2):
            step(scene, [cam], target)
    rec = trace.drain()
    assert [(c["kind"], c["call"]) for c in rec["calls"]] == [
        ("train_step", 1), ("train_step", 2)]
    for c in rec["calls"]:
        order = _in_order(c["stages"])
        assert order == ["train.forward", *STAGES, "train.loss", "train.loss",
                         "train.backward", "train.optimizer"]
        assert set(order) == set(TRAIN_SPANS) | set(STAGES)


@pytest.mark.parametrize("switch", ["off", "profiler", "recording", "nested"])
def test_recording_is_on_under_a_profiler_or_recording(scene_cam, switch):
    scene, cam = scene_cam
    cfg = RenderConfig(**KW)
    render_jit(scene, cam, cfg)
    if switch == "off":
        render_jit(scene, cam, cfg)
        assert not trace.active()
    elif switch == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert trace.active()
            render_jit(scene, cam, cfg)
        names = {e.name for e in prof.events()}
        assert {"graphs.render.body", *STAGES} <= names
    elif switch == "recording":
        with trace.recording():
            assert trace.active()
            render_jit(scene, cam, cfg)
    else:
        with trace.recording():
            with trace.recording():
                render_jit(scene, cam, cfg)
            assert trace.active()
            render_jit(scene, cam, cfg)
    assert not trace.active()
    render_jit(scene, cam, cfg)
    want = {"off": 0, "profiler": 1, "recording": 1, "nested": 2}[switch]
    assert len(trace.drain()["calls"]) == want


def test_outside_a_capture_a_stage_launches_no_mark(scene_cam):
    scene, cam = scene_cam
    before = counters.snapshot()
    with trace.recording():
        with trace.stage("render.bin") as st:
            st.payload(torch.zeros((), dtype=torch.int32), 10)
        render_jit(scene, cam, RenderConfig(**KW))
    assert "mark" in before
    assert counters.rise(before, counters.snapshot()) == {}


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_counters_still_count_per_replay():
    """A replay adds its graph's launches, marks among them, to the table
    of launch counts, recording or not."""
    cap = graphs.Captured("fake")
    x = torch.zeros(3)
    cap(("k",), [x], lambda b: b + 1)
    (entry,) = cap.entries.values()
    entry.graph, entry.outputs = _FakeGraph(), torch.ones(3)
    entry.launches = {"mark": 6, "K3.compact": 1}
    before = counters.snapshot()
    for _ in range(3):
        out = cap(("k",), [x], lambda b: b + 1)
    assert torch.equal(out, torch.ones(3)) and entry.graph.replays == 3
    assert counters.rise(before, counters.snapshot()) == {
        "mark": 18, "K3.compact": 3}
    counters.add(counters.rise(before, counters.snapshot()), -1)


# --------------------------------------------------- the benchmark's reduction

OFFSET = 1_000_000_000  # the card's clock minus the host's, ns


def _mark(stage, t, end=0, count=-1, keys=-1):
    return dict(call=0, stage=stage, end=end, t_ns=t, count=count, keys=keys)


def _replay(t, stage_ns, count=40, keys=1000, launch_lag=2_000):
    """One replay on the card from t (card ns): a copy in of 1 us, a gap
    while the host launches (launch_lag), the graph's stages, a copy out of
    1 us; its host spans on the host's clock."""
    marks = [_mark("copy_in", t), _mark("copy_in", t + 1_000, end=1)]
    g = t + 1_000 + launch_lag
    marks.append(_mark("call", g))
    for name, ns in stage_ns:
        marks.append(_mark(name, g))
        if name == "render.gather":  # the bin stage's payload
            marks[-1].update(count=count, keys=keys)
        g += ns
    marks.append(_mark("call", g, end=1))
    marks += [_mark("copy_out", g), _mark("copy_out", g + 1_000, end=1)]
    host = dict(copy_in=(t - OFFSET, t + 1_000 - OFFSET),
                launch=(t + 1_000 - OFFSET, g - 500 - OFFSET),
                copy_out=(g - 500 - OFFSET, g + 1_000 - OFFSET))
    return dict(kind="train_step", device="cuda:0", replay=True, spans=host,
                stages=[], nodes={"kernel": 9}, marks=marks), g + 1_000


STEP = [("train.forward", 0), ("render.project", 3_000_000),
        ("render.bin", 2_000_000), ("render.gather", 1_000_000),
        ("render.blend", 4_000_000), ("train.loss", 1_500_000),
        ("train.backward", 500_000), ("render.blend.backward", 6_000_000),
        ("render.project.backward", 2_000_000), ("train.optimizer", 1_000_000)]


def _record(n=2, caller_ns=3_000):
    calls, t = [], 10_000_000
    for _ in range(n):
        c, t = _replay(t, STEP)
        calls.append(c)
        t += caller_ns
    return dict(calls=calls, lost=0, lost_calls=0,
                clock={"cuda:0": [dict(offset_ns=OFFSET, bracket_ns=1_500,
                                       host_ns=0)]})


def test_stages_sum_each_layer_forward_and_backward():
    s = stages.reduce(_record(), 2)
    assert s["layer_ms"] == pytest.approx(dict(
        project=5.0, bin=2.0, gather=1.0, blend=10.0, loss=2.0, adam=1.0))
    assert s["stage_ms"]["render.bin"] == pytest.approx(2.0)
    assert s["copy_ms"] == pytest.approx({"copy_in": 1e-3, "copy_out": 1e-3})
    assert s["graph_ms"] == pytest.approx(21.0)
    assert s["bin_useful_pct"] == pytest.approx(4.0)


def test_stages_put_each_gap_down_to_the_host_span_it_lies_in():
    s = stages.reduce(_record(caller_ns=3_000), 2)
    # Each call's 2 us before its graph lies in its launch span; the 3 us
    # after the first call's copy out lie in the caller (and the second's
    # last gap, after the window, is no gap between intervals).
    assert s["gap_ms"] == pytest.approx(dict(launch=2e-3, copy=0.0,
                                             caller=1.5e-3))
    total = (sum(s["stage_ms"].values()) + sum(s["copy_ms"].values())
             + sum(s["gap_ms"].values()))
    assert s["span_ms"] == pytest.approx(total)


@pytest.mark.parametrize("clock", ["shifted", "drifting"])
def test_stages_map_host_spans_by_the_clock_offset(clock):
    rec = _record()
    if clock == "shifted":
        rec["clock"]["cuda:0"][0]["offset_ns"] = OFFSET + 5_000
    else:
        # Two measurements 2 s apart, the clocks drifting 10 us between
        # them: at the calls, in the middle, 5 us.
        mid = rec["calls"][0]["spans"]["launch"][0]
        rec["clock"]["cuda:0"] = [
            dict(offset_ns=OFFSET, bracket_ns=1_500, host_ns=mid - 10**9),
            dict(offset_ns=OFFSET + 10_000, bracket_ns=1_500,
                 host_ns=mid + 10**9)]
        assert stages.offset_at(rec["clock"]["cuda:0"], mid) == OFFSET + 5_000
    s = stages.reduce(rec, 2)
    # The host spans now map 5 us later on the card's clock: the 2 us
    # before each graph no longer lie in its launch span.
    assert s["gap_ms"]["launch"] < 2e-3
    assert s["layer_ms"]["bin"] == pytest.approx(2.0)


@pytest.mark.parametrize("fault", ["calls", "lost", "lost_calls", "mark",
                                   "clock", "eager"])
def test_stages_read_nothing_from_a_record_that_is_not_whole(fault):
    rec, calls = _record(), 2
    if fault == "calls":
        calls = 3
    elif fault == "mark":
        rec["calls"][1]["marks"].pop()
    elif fault == "clock":
        rec["clock"] = {}
    elif fault == "eager":
        for c in rec["calls"]:
            c["replay"] = False
    else:
        rec[fault] = 1
    assert stages.reduce(rec, calls) is None


def test_stages_read_nothing_from_a_program_without_the_record(monkeypatch):
    monkeypatch.setattr(stages, "_record", None)
    import gsplat_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "gsplat_tpu_torch.utils.trace", None)
    assert stages.record() == {}
    assert stages.layer_ms({"calls": 2}, "bin") is None


def _metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}",
        ROOT / "splatbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", NEW_METRICS)
def test_each_new_metric_reads_the_record(name, monkeypatch):
    monkeypatch.setattr(stages, "_record", _record())
    value = _metric(name)({"calls": 2})
    want = {"launch_gap_ms": 2e-3, "bin_useful_pct": 4.0}.get(
        name.split(".")[0])
    if want is None:
        layer = name.split("_ms")[0]
        want = stages.reduce(_record(), 2)["layer_ms"][layer]
    assert value == pytest.approx(want)
    assert _metric(name)({"calls": 3}) is None


def _timeline_ms(rec) -> dict:
    """The timeline's rows summed per replay, by track and name."""
    calls = sum(1 for c in rec["calls"] if c.get("marks"))
    ms: dict = {}
    for track, name, a, b in trace.timeline(rec):
        key = f"{track}:{name}"
        ms[key] = ms.get(key, 0.0) + (b - a) / 1e6 / calls
    return ms


def test_timeline_gives_each_stage_and_gap_per_replay():
    ms = _timeline_ms(_record())
    assert ms["stages:render.bin"] == pytest.approx(2.0)
    assert ms["stages:render.blend.backward"] == pytest.approx(6.0)
    assert ms["stages:copy_in"] == pytest.approx(1e-3)
    assert ms["gaps:graphs.train_step.launch"] == pytest.approx(2e-3)
    assert ms["gaps:caller"] == pytest.approx(1.5e-3)


@pytest.mark.parametrize("lag_ns", [500, 4_000])
def test_timeline_splits_gaps_as_the_benchmark_does(lag_ns):
    """The program's timeline and the benchmark's reduction put each gap
    down to the host spans by one rule, overlap: the launch span opens
    lag_ns after the copy in ends, so of the 2 us gap before each graph
    the part before it lies in no span (the caller's) and the rest in the
    launch span (lag 500 ns), or all of it in the caller's (lag 4 us)."""
    rec = _record(caller_ns=3_000)
    for c in rec["calls"]:
        t0, t1 = c["spans"]["launch"]
        c["spans"]["launch"] = (t0 + lag_ns, t1)
    ms = _timeline_ms(rec)
    got = {"launch": ms.get("gaps:graphs.train_step.launch", 0.0),
           "copy": ms.get("gaps:graphs.train_step.copy_in", 0.0)
           + ms.get("gaps:graphs.train_step.copy_out", 0.0),
           "caller": ms.get("gaps:caller", 0.0)}
    assert got == pytest.approx(stages.reduce(rec, 2)["gap_ms"], abs=1e-9)
    assert got["caller"] > 0


def test_cli_profile_adds_the_record_on_the_traces_clock(tmp_path):
    from gsplat_tpu_torch import cli

    rec, shift_us = _record(), 5e6
    events = [dict(ph="X", name="graphs.train_step.launch", pid=1, tid=1,
                   cat=cat, ts=c["spans"]["launch"][0] / 1e3 + shift_us + lag,
                   dur=1.0)
              for c in rec["calls"]
              for cat, lag in (("user_annotation", 0.0),
                               ("gpu_user_annotation", 50.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    added = cli.add_record_rows(str(path), rec)
    rows = [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "trace"]
    assert added == len(rows) > 0
    (first_bin, _) = [e for e in rows if e["name"] == "render.bin"]
    mark = next(m for m in rec["calls"][0]["marks"]
                if m["stage"] == "render.bin")
    assert first_bin["ts"] == pytest.approx((mark["t_ns"] - OFFSET) / 1e3
                                            + shift_us)
    assert first_bin["dur"] == pytest.approx(2000.0)
    assert {e["name"] for e in rows if e["tid"] == 1} == {
        "graphs.train_step.launch", "caller"}
    assert cli.add_record_rows(str(path), dict(calls=[], clock={})) == 0
