"""On a CUDA card: the marks of captured calls (`utils/trace.py`) run on
every replay, in call order, agree with CUDA events around the graph, and
share the profiler's clock. Imports no JAX; skips without a card. On a
machine without JAX, run it without tests/conftest.py (which imports
JAX); the file needs nothing from it:

    python -m pytest --noconftest tests/test_torch_trace_card.py -q -s
"""

import statistics
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import record_function

from gsplat_tpu_torch import Camera, RenderConfig, random_scene, render_jit
from gsplat_tpu_torch.render.pipeline import RENDER_GRAPHS, STAGES
from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step
from gsplat_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench import stages  # noqa: E402

REPLAYS = 3
# The frame of `render_jit` and the step of `make_train_step`, graph marks
# in order (the copies' marks aside).
FRAME = ["call", *STAGES, "call"]
STEP = ["call", "train.forward", *STAGES, "train.loss", "train.loss",
        "train.backward", "render.blend.backward", "render.project.backward",
        "train.optimizer", "call"]
# Where the card's and the profiler's clocks may disagree on a mark, ns.
CLOCK_NS = 10_000
# The clock test's window (a cell's traced window: bicycle's 12 frames take
# 1.2 s), its pause between replays, and its witness spans' name.
WINDOW_S = 1.3
PAUSE_S = 0.01
WITNESS = "trace_card.witness"


@pytest.fixture
def cuda_device():
    """cuda:0, or a skip where there is no card (decided here, not while the
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _setup(device, n=300_000):
    from gsplat_tpu_torch import bench

    kw = {k: v for k, v in bench.CARD.items()
          if k not in ("num_gaussians", "impl", "mode", "iters")}
    cfg = RenderConfig(**dict(kw, **bench.DEFAULT))
    scene = random_scene(n, 3, generator=torch.Generator(device).manual_seed(0),
                         device=device)
    return scene, Camera.default(cfg.width, cfg.height, device=device), cfg


class _Timed:
    """A graph whose replays are bracketed by CUDA events."""

    def __init__(self, graph):
        self.graph, self.ms, self._pending = graph, [], []

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self._pending.append((a, b))

    def read(self):
        torch.cuda.synchronize()
        self.ms += [a.elapsed_time(b) for a, b in self._pending]
        self._pending = []
        return self.ms


def _record_replays(call, entries, n=REPLAYS):
    """call() twice (capture, replay), then n recorded replays, the graph's
    own replays timed by CUDA events: (the record, the events' ms)."""
    call()
    call()
    entry = next(reversed(entries.values()))
    timed = entry.graph = _Timed(entry.graph)
    with trace.recording():
        call()
        torch.cuda.synchronize()
        trace.drain()
        timed.read().clear()
        for _ in range(n):
            call()
        ms = timed.read()
        rec = trace.drain()
    entry.graph = timed.graph
    return rec, ms


def _check_record(rec, ms, order):
    calls = rec["calls"]
    assert rec["lost"] == 0 and rec["lost_calls"] == 0
    assert [c["call"] for c in calls] == list(range(1, REPLAYS + 1))
    (clock, now), = rec["clock"].values()
    assert clock["bracket_ns"] <= CLOCK_NS
    print(f"clock bracket {clock['bracket_ns']} ns, offset drift "
          f"{now['offset_ns'] - clock['offset_ns']} ns over "
          f"{(now['host_ns'] - clock['host_ns']) / 1e9:.3f} s")
    last = 0
    for c, event_ms in zip(calls, ms):
        graph = [m for m in c["marks"]
                 if m["stage"] not in (trace.COPY_IN, trace.COPY_OUT)]
        assert [m["stage"] for m in graph] == order
        assert [m["end"] for m in graph] == [0] * (len(order) - 1) + [1]
        times = [m["t_ns"] for m in c["marks"]]
        assert times == sorted(times) and times[0] >= last
        last = times[-1]
        stage_ms = (graph[-1]["t_ns"] - graph[0]["t_ns"]) / 1e6
        print(f"call {c['call']}: stages {stage_ms:.4f} ms, events "
              f"{event_ms:.4f} ms, nodes {c['nodes']}")
        assert stage_ms == pytest.approx(event_ms, rel=0.02)
    return stages.reduce(rec, REPLAYS)


@pytest.mark.card
def test_render_replays_record_their_stages(cuda_device):
    scene, cam, cfg = _setup(cuda_device)
    rec, ms = _record_replays(lambda: render_jit(scene, cam, cfg),
                              RENDER_GRAPHS.entries)
    s = _check_record(rec, ms, FRAME)
    out = render_jit(scene, cam, cfg)
    (c, *_) = rec["calls"]
    (bin_end,) = [m for m in c["marks"] if m["count"] >= 0]
    assert bin_end["stage"] == "render.gather"
    assert bin_end["count"] == int(out.num_intersections)
    assert bin_end["keys"] > bin_end["count"]
    assert c["nodes"]["kernel"] > len(FRAME)
    print(f"frame: {s}")
    assert set(s["layer_ms"]) == {"project", "bin", "gather", "blend"}


@pytest.mark.card
def test_train_replays_record_their_stages(cuda_device):
    scene, cam, cfg = _setup(cuda_device)
    step = make_train_step(cfg, make_optimizer(scene), ssim_weight=0.2)
    target = torch.full((1, cfg.height, cfg.width, 3), 0.5, device=cuda_device)
    rec, ms = _record_replays(lambda: step(scene, [cam], target),
                              step.graphs.entries)
    s = _check_record(rec, ms, STEP)
    print(f"step: {s}")
    assert set(s["layer_ms"]) == set(stages.LAYERS)
    assert 0.0 < s["bin_useful_pct"] < 100.0


def _witness(n: int = 20) -> list:
    """Empty profiler spans, each bracketed by CLOCK_MONOTONIC reads:
    (before, after) ns."""
    out = []
    for _ in range(n):
        a = time.monotonic_ns()
        with record_function(WITNESS):
            pass
        out.append((a, time.monotonic_ns()))
    return out


def _to_prof(brackets: list, starts_us: list) -> tuple:
    """The profiler's host clock (ns) minus CLOCK_MONOTONIC, from the
    tightest bracket, and that bracket's width."""
    (a, b), p = min(zip(brackets, starts_us),
                    key=lambda x: x[0][1] - x[0][0])
    return p * 1e3 - (a + b) / 2, b - a


@pytest.mark.card
def test_marks_share_the_profilers_clock(cuda_device):
    """Over a window as long as a cell's traced window: the record's two
    clocks stay on its line (a clock measurement in the middle lies within
    CLOCK_NS of the line through the first and the last); the profiler's
    host clock is CLOCK_MONOTONIC plus a constant (empty spans bracketed by
    CLOCK_MONOTONIC reads at the window's start and end agree within
    CLOCK_NS); every mark's kernel record is kept and matched to its mark
    by order, and the first replay's records start within CLOCK_NS of
    their marks mapped onto the profiler's clock; each graph's first mark
    follows the start of its launch span. Later records are reported, not
    held: the profiler's device timeline drifts from its own host timeline
    by up to tens of ppm and steps back now and then, while the record's
    clocks stay on their line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene, cam, cfg = _setup(cuda_device)
    render_jit(scene, cam, cfg)
    render_jit(scene, cam, cfg)
    torch.cuda.synchronize()
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = _witness()
        t_end = time.monotonic() + WINDOW_S
        mid, n = None, 0
        while time.monotonic() < t_end:
            render_jit(scene, cam, cfg)
            torch.cuda.synchronize()
            n += 1
            if mid is None and time.monotonic() > t_end - WINDOW_S / 2:
                mid = trace.clock_offset(cuda_device)
            time.sleep(PAUSE_S)
        end = _witness()
    rec = trace.drain()
    calls = rec["calls"]
    assert len(calls) == n and rec["lost"] == 0 and mid is not None
    (clock,) = rec["clock"].values()
    on_line = mid["offset_ns"] - trace.offset_at(clock, mid["host_ns"])
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    wit = sorted(e.time_range.start for e in host if e.name == WITNESS)
    assert len(wit) == len(start) + len(end)
    (shift, width0), (shift1, width1) = (
        _to_prof(start, wit[:len(start)]), _to_prof(end, wit[len(start):]))
    kept = sorted(e.time_range.start * 1e3 for e in events
                  if e.device_type == DeviceType.CUDA
                  and "mark_kernel" in e.name)
    marks = sorted((m["t_ns"], c["call"]) for c in calls for m in c["marks"])
    assert len(kept) == len(marks), "the profiler dropped mark records"
    gaps = [k - (trace.to_host(clock, t) + shift)
            for k, (t, _) in zip(kept, marks)]
    first = [abs(g) for g, (_, c) in zip(gaps, marks) if c == 1]
    span_s = (marks[-1][0] - marks[0][0]) / 1e9
    drift = (gaps[-1] - gaps[0]) / span_s / 1e3
    launches = sorted(e.time_range.start for e in host
                      if e.name == "graphs.render.launch")
    lag = statistics.median(p * 1e3 - shift - c["spans"]["launch"][0]
                            for p, c in zip(launches, calls))
    print(f"{n} replays over {span_s:.3f} s; the record's clocks: bracket "
          f"{clock[0]['bracket_ns']} ns, middle off their line {on_line:.0f} "
          f"ns; the profiler's host clock: {shift1 - shift:.0f} ns from start "
          f"to end (brackets {width0}, {width1} ns); launch spans: the "
          f"profiler's start minus the record's {lag:.0f} ns (median); the "
          f"first replay's records: worst {max(first):.0f} ns; over the window: "
          f"median {statistics.median(abs(g) for g in gaps):.0f}, worst "
          f"{max(abs(g) for g in gaps):.0f} ns, the profiler's device "
          f"timeline drifting {drift:.1f} ppm")
    assert abs(on_line) <= CLOCK_NS
    assert abs(shift1 - shift) <= CLOCK_NS
    assert max(first) <= CLOCK_NS
    for c in calls:
        mark = next(m for m in c["marks"] if m["stage"] == "call")
        assert trace.to_host(clock, mark["t_ns"]) >= c["spans"]["launch"][0]
