"""From the program's own record of its calls to per-call numbers.

The program (`gsplat_tpu_torch/utils/trace.py`) records every captured call
made while a profiler runs: each replay's marks on the card's clock (where
each stage began, and the binning's payload: the intersections and the keys
its sort ordered), its host spans (the copy in, the graph's launch, the copy
out) on the host's clock, and the offset between the two clocks. The
traced window's calls are its only replays: the eager pass that the kinds
profile after the window writes nothing to the record. `record()` drains it
once per process; every number here is None where the record does not hold
exactly the window's calls, each with its marks, or lost a mark, or where
the program keeps no such record.

A stage runs from its mark to the next mark of the call. A layer's time is
the sum of its stages' intervals, forward and backward:

- project: the projection and SH, and their backward (from the features'
  gradient on);
- bin: the binning; gather: the feature table and the gather into the
  stream;
- blend: K1, and the backward of the blend and the gather (from the image's
  gradient on);
- loss: L1 + DSSIM and the mean over views, and their backward (from the
  backward's start to the image's gradient);
- adam: the optimizer's update.

A gap is device time between two of the program's intervals (the copy in,
the graph, the copy out, of one call or of two) in which none runs. Each
gap is split by the host spans it overlaps, on one clock: the part in a
launch span is the launch's, in a copy span the copy's, and the rest the
caller's.

The gap rule and `offset_at` are copies of the program's
(`gsplat_tpu_torch/utils/trace.py::timeline`, `::offset_at`, which the
operator's profiles read), kept here so that the yardstick does not move
with the program; a test holds the two to the same gaps.
"""

from __future__ import annotations

LAYERS = {
    "project": ("render.project", "render.project.backward"),
    "bin": ("render.bin",),
    "gather": ("render.gather",),
    "blend": ("render.blend", "render.blend.backward"),
    "loss": ("train.loss", "train.backward"),
    "adam": ("train.optimizer",),
}
CALL, COPY_IN, COPY_OUT = "call", "copy_in", "copy_out"

_record = None


def record() -> dict:
    """The program's record, drained on the first call of the process; {}
    where the program keeps none."""
    global _record
    if _record is None:
        try:
            from gsplat_tpu_torch.utils import trace
        except ImportError:
            _record = {}
        else:
            _record = trace.drain()
    return _record


def _bracket(marks: list, name: str):
    """(begin, end) ns of the marks of `name` that begin and end it."""
    begin = [m["t_ns"] for m in marks if m["stage"] == name and not m["end"]]
    end = [m["t_ns"] for m in marks if m["stage"] == name and m["end"]]
    if len(begin) != 1 or len(end) != 1:
        return None
    return begin[0], end[0]


def offset_at(clock: list, host_ns: float) -> float:
    """The card's clock minus the host's at host_ns: the first and last
    measurements of `clock` joined by a line (the two clocks drift apart
    by some ns a second), the first alone where there is one."""
    first, last = clock[0], clock[-1]
    if last["host_ns"] == first["host_ns"]:
        return first["offset_ns"]
    rate = ((last["offset_ns"] - first["offset_ns"])
            / (last["host_ns"] - first["host_ns"]))
    return first["offset_ns"] + rate * (host_ns - first["host_ns"])


def _one_call(c: dict, clock: list):
    """A replay's intervals on the card's clock: its stages' (name, ns)
    in order, its payloads, and its program intervals and host spans;
    None when a mark is missing."""
    marks = c.get("marks", [])
    graph = [m for m in marks if m["stage"] not in (COPY_IN, COPY_OUT)]
    copy_in, copy_out = _bracket(marks, COPY_IN), _bracket(marks, COPY_OUT)
    if (len(graph) < 2 or graph[0]["stage"] != CALL or graph[0]["end"]
            or graph[-1]["stage"] != CALL or not graph[-1]["end"]
            or copy_in is None or copy_out is None
            or any(k not in c["spans"] for k in (COPY_IN, "launch", COPY_OUT))):
        return None
    stages = [(a["stage"], b["t_ns"] - a["t_ns"])
              for a, b in zip(graph[:-1], graph[1:])]
    payloads = [(m["count"], m["keys"]) for m in graph
                if m["count"] >= 0 and m["keys"] > 0]
    host = {k: tuple(t + offset_at(clock, t) for t in span)
            for k, span in c["spans"].items()}
    return dict(stages=stages, payloads=payloads, host=host,
                intervals=[copy_in, (graph[0]["t_ns"], graph[-1]["t_ns"]),
                           copy_out])


def _overlap(a: int, b: int, span) -> int:
    return max(0, min(b, span[1]) - max(a, span[0]))


def reduce(raw: dict, calls: int) -> dict | None:
    """Per-call means (ms) of each stage, layer, copy and gap by cause, the
    binning's useful share, and the card's span from the first copy in to
    the last copy out over the calls; None where the record does not hold
    `calls` whole replays. Host spans go onto the card's clock by
    `offset_at`."""
    replays = [c for c in raw.get("calls", []) if c.get("replay")]
    if (not replays or len(replays) != calls or raw.get("lost")
            or raw.get("lost_calls")):
        return None
    parsed = []
    for c in replays:
        clock = raw.get("clock", {}).get(c["device"])
        if not clock:
            return None
        one = _one_call(c, clock)
        if one is None:
            return None
        parsed.append(one)
    stage_ns: dict = {}
    for p in parsed:
        for name, ns in p["stages"]:
            stage_ns[name] = stage_ns.get(name, 0) + ns
    intervals = sorted(iv for p in parsed for iv in p["intervals"])
    gaps = {"launch": 0, "copy": 0, "caller": 0}
    reach = intervals[0][1]
    for a, b in intervals[1:]:
        if a > reach:
            launch = sum(_overlap(reach, a, p["host"]["launch"])
                         for p in parsed)
            copy = sum(_overlap(reach, a, p["host"][k]) for p in parsed
                       for k in (COPY_IN, COPY_OUT))
            gaps["launch"] += launch
            gaps["copy"] += copy
            gaps["caller"] += max(0, (a - reach) - launch - copy)
        reach = max(reach, b)
    counts = [p for q in parsed for p in q["payloads"]]
    ms = 1e-6 / calls
    return dict(
        calls=calls,
        stage_ms={k: v * ms for k, v in stage_ns.items()},
        layer_ms={layer: sum(stage_ns[s] for s in names if s in stage_ns) * ms
                  for layer, names in LAYERS.items()
                  if any(s in stage_ns for s in names)},
        copy_ms={k: sum(p["intervals"][i][1] - p["intervals"][i][0]
                        for p in parsed) * ms
                 for i, k in ((0, COPY_IN), (2, COPY_OUT))},
        graph_ms=sum(p["intervals"][1][1] - p["intervals"][1][0]
                     for p in parsed) * ms,
        gap_ms={k: v * ms for k, v in gaps.items()},
        span_ms=(reach - intervals[0][0]) * ms,
        bin_useful_pct=(100.0 * sum(n for n, _ in counts)
                        / sum(k for _, k in counts)) if counts else None)


def summary(trace: dict) -> dict | None:
    """`reduce` of the program's record over the traced window's calls."""
    return reduce(record(), trace["calls"])


def layer_ms(trace: dict, layer: str):
    s = summary(trace)
    return None if s is None else s["layer_ms"].get(layer)


def launch_gap_ms(trace: dict):
    s = summary(trace)
    return None if s is None else s["gap_ms"]["launch"]


def bin_useful_pct(trace: dict):
    s = summary(trace)
    return None if s is None else s["bin_useful_pct"]
