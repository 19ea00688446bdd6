"""Stages of a call that a CUDA graph's replay keeps, and the record of calls.

A captured call (`utils/graphs.py::Captured`) runs on the card as one graph
replay: no Python runs inside it, so the `record_function` spans of its
stages exist only where the body runs eagerly, and a profile of a replay
shows one `cudaGraphLaunch`. `stage(name)` opens the same span and, while a
`Captured` captures the body, also enqueues a mark: a one-thread kernel
(`csrc/trace_mark.cu`) that becomes a node of the graph and so runs on every
replay. A mark reads a flag on the card and returns at once when it is off;
when it is on, it appends one record to a ring on the card: the call's id,
the stage, whether the mark ends the call or a copy, `%globaltimer` in ns,
and a payload (a count read on the card where the graph holds it, and a
number fixed at capture).

Stages run in stream order, so one mark per boundary is enough: a stage's
mark is enqueued where it begins, and the stage runs on the card from its
mark to the next mark of the call (work enqueued after a stage's block and
before the next mark counts to it). A payload set on a stage (`payload`) is
carried by the next mark: it belongs to the stage that mark ends.
`on_grad(t, name)` marks a boundary of the backward the same way, by a hook
that runs when t's gradient is ready.

Recording is on while a `torch.profiler` session is active or inside
`recording()`. `Captured` reads that host flag once a call and writes the
card's flag only when it changes; while it is on, each replay's host spans
(`graphs.<kind>.copy_in`, `.launch`, `.copy_out`) are kept in
`time.monotonic_ns` (CLOCK_MONOTONIC) and opened as `record_function`
spans too, and the two copies are bracketed by marks of their own. When a
card's flag turns on, the offset between the host clock and `%globaltimer`
is measured (`clock_offset`); `drain()` measures it again, returns the
record and clears it.

A body run eagerly (on the CPU, on gloo) enqueues no mark and writes
nothing to the ring: its call's record is host-only, its stage spans in
host ns. A mark's launch counts as "mark" (`ops/cuda/counters.py`).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch
from torch.profiler import record_function

from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import INT, INT64, PTR

# Records the ring holds per card (48 bytes each: 768 KiB), and calls the
# host keeps between drains; marks and calls past them are counted as lost.
RING_RECORDS = 16384
MAX_CALLS = 4096
# Pings of a clock-offset measurement (at most 64); the tightest bracket is
# kept.
CLOCK_TRIES = 20
# The ring's columns (csrc/trace_mark.cu, Record).
RECORD_FIELDS = ("call", "stage", "end", "t_ns", "count", "keys")
# The stage ids of the calls' own marks: the graph's first and last, and
# the copies' brackets.
CALL, COPY_IN, COPY_OUT = "call", "copy_in", "copy_out"
# cuGraphNodeGetType's CUgraphNodeType values by the name of their count.
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}

# The mark (on, cursor, calls done, ring, its records, stage, end, begins
# call, call delta, count, its bytes, keys), counted as "mark", and the
# clock's pings (tries, the host's before and after, the card's times).
_MARK = _build.kernel(
    "trace_mark", "gsplat_trace_mark",
    [PTR, PTR, PTR, PTR, INT64, INT, INT, INT, INT, PTR, INT, INT64], "mark")
_CLOCK = _build.kernel("trace_mark", "gsplat_trace_clock",
                       [INT, PTR, PTR, PTR], None)

# Stage names by id, the id their index; ids are given on first use.
_stage_names: list = []
_stage_ids: dict = {}
# recording()'s depth; each card's `_Card`; the capture under way; the
# eager call whose body runs; the host records of eager calls (no card's
# ring) and those past MAX_CALLS.
_depth = 0
_devices: dict = {}
_capture = None
_eager_call = None
_eager = dict(calls=[], lost=0)


def stage_id(name: str) -> int:
    i = _stage_ids.get(name)
    if i is None:
        i = _stage_ids[name] = len(_stage_names)
        _stage_names.append(name)
    return i


def active() -> bool:
    """The host flag: a `torch.profiler` session is active, or the caller is
    inside `recording()`."""
    return _depth > 0 or torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record the captured calls made inside the block (the operator's
    switch; any `torch.profiler` session turns recording on too)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


@dataclasses.dataclass
class _Card:
    """One card's flag, ring, cursor, call counter and host records."""

    device: torch.device
    on: torch.Tensor
    cursor: torch.Tensor
    calls_done: torch.Tensor
    ring: torch.Tensor
    flag: bool = False
    calls: list = dataclasses.field(default_factory=list)
    lost_calls: int = 0
    clock: list = dataclasses.field(default_factory=list)


def _launch(card: _Card, name: str, end: int = 0, begins_call: int = 0,
            call_delta: int = 0, count: torch.Tensor | None = None,
            keys: int = -1) -> None:
    if count is not None and count.element_size() not in (4, 8):
        raise ValueError(f"trace: a mark's count must be a 4- or 8-byte "
                         f"integer, got {count.dtype}")
    _MARK(card.device, card.on.data_ptr(), card.cursor.data_ptr(),
          card.calls_done.data_ptr(), card.ring.data_ptr(), RING_RECORDS,
          stage_id(name), end, begins_call, call_delta,
          0 if count is None else count.data_ptr(),
          0 if count is None else count.element_size(), keys)


def prepare(device: torch.device) -> _Card:
    """The card's state, made before the first capture on it: its buffers
    lie outside every graph's pool, one mark runs (off) so that the
    kernel's library is built and loaded before a capture reaches it, and
    one clock measurement allocates its mapped host words."""
    card = _devices.get(device)
    if card is None:
        z = dict(device=device)
        card = _devices[device] = _Card(
            device=device, on=torch.zeros((1,), dtype=torch.int32, **z),
            cursor=torch.zeros((1,), dtype=torch.int64, **z),
            calls_done=torch.zeros((1,), dtype=torch.int64, **z),
            ring=torch.zeros((RING_RECORDS, len(RECORD_FIELDS)),
                             dtype=torch.int64, **z))
        _launch(card, CALL, end=1)
        clock_offset(device)
    return card


def clock_offset(device: torch.device, tries: int = CLOCK_TRIES) -> dict:
    """`%globaltimer` minus CLOCK_MONOTONIC, in ns, from the tightest of
    `tries` pings answered by the card (after a synchronise): offset_ns,
    the bracket's width (bracket_ns) and when it was taken (host_ns)."""
    torch.cuda.synchronize(device)
    before, after, dev_t = ((ctypes.c_int64 * tries)() for _ in range(3))
    _CLOCK(device, tries, before, after, dev_t)
    i = min(range(tries), key=lambda k: after[k] - before[k])
    mid = (before[i] + after[i]) // 2
    return dict(offset_ns=dev_t[i] - mid, bracket_ns=after[i] - before[i],
                host_ns=mid)


def set_flag(device: torch.device, on: bool) -> None:
    """Write the card's flag if it differs from `on` (in stream order, no
    synchronise); the clock's offset is measured when it turns on."""
    card = _devices.get(device)
    if card is None or card.flag == on:
        return
    if on:
        card.clock.append(clock_offset(device))
    card.on.fill_(int(on))
    card.flag = on


def graph_nodes(graph) -> dict:
    """The nodes of a captured graph (`CUDAGraph(keep_graph=True)`) by type:
    kernel, memcpy, memset, other: the launches one replay makes."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _driver_check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)),
                  "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _driver_check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
                  "cuGraphGetNodes")
    out = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kind = ctypes.c_int(0)
    for node in nodes:
        _driver_check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                              ctypes.byref(kind)),
                      "cuGraphNodeGetType")
        out[NODE_TYPES.get(kind.value, "other")] += 1
    return out


def _driver_check(res: int, what: str) -> None:
    if res != 0:
        raise RuntimeError(f"{what} failed: CUresult {res}")


class _Capture:
    """The marks of one body being captured, and the payload the next mark
    carries."""

    def __init__(self, card: _Card):
        self.card = card
        self.count, self.keys = None, -1

    def mark(self, name: str, end: int = 0, begins_call: int = 0) -> None:
        _launch(self.card, name, end, begins_call, 0, self.count, self.keys)
        self.count, self.keys = None, -1


class Stage:
    """The handle `stage` yields: `payload(count, keys)` sets what the next
    mark carries (a () integer tensor on the card, and a number)."""

    def __init__(self, capture):
        self.capture = capture

    def payload(self, count: torch.Tensor, keys: int) -> None:
        if self.capture is not None:
            self.capture.count, self.capture.keys = count, int(keys)


@contextlib.contextmanager
def stage(name: str):
    """The stage `name`: a `record_function` span; inside a capture, a mark
    where it begins; in an eager call while recording, a host span in the
    call's record."""
    cap, call = _capture, _eager_call
    with record_function(name):
        if cap is not None:
            cap.mark(name)
        span = None
        if call is not None:
            span = [name, time.monotonic_ns(), None]
            call["stages"].append(span)
        try:
            yield Stage(cap)
        finally:
            if span is not None:
                span[2] = time.monotonic_ns()


def on_grad(t: torch.Tensor, name: str) -> None:
    """Inside a capture, a mark that begins stage `name` when t's gradient
    is ready (a boundary of the backward); nothing elsewhere."""
    cap = _capture
    if cap is not None and t.requires_grad:
        t.register_hook(lambda g: cap.mark(name))


@contextlib.contextmanager
def capturing(device: torch.device):
    """Around a body being captured on `device`: the graph's first mark
    begins the call (and counts it on the card), its last ends it.
    `prepare(device)` has run before the capture began."""
    global _capture
    cap = _Capture(_devices[device])
    cap.mark(CALL, begins_call=1)
    _capture = cap
    try:
        yield
    finally:
        _capture = None
    cap.mark(CALL, end=1)


class _Call:
    """The host record of one call while recording: its spans, each a
    `record_function` span too; a replay's copies are bracketed by marks
    (their call id the coming replay's for the copy in)."""

    def __init__(self, kind: str, card: _Card | None, rec: dict):
        self.kind, self.card, self.rec = kind, card, rec

    @contextlib.contextmanager
    def span(self, name: str):
        global _eager_call
        marks = self.card is not None and name in (COPY_IN, COPY_OUT)
        delta = int(name == COPY_IN)
        with record_function(f"graphs.{self.kind}.{name}"):
            t0 = time.monotonic_ns()
            if marks:
                _launch(self.card, name, call_delta=delta)
            outer, _eager_call = _eager_call, (
                self.rec if self.card is None else None)
            try:
                yield
            finally:
                _eager_call = outer
                if marks:
                    _launch(self.card, name, end=1, call_delta=delta)
                self.rec["spans"][name] = (t0, time.monotonic_ns())


class _Off:
    """The call of a body while recording is off: spans that do nothing."""

    _null = contextlib.nullcontext()

    def span(self, name: str):
        return self._null


OFF = _Off()


def call(kind: str, device: torch.device, replay: bool, nodes=None):
    """The record of one call of a `Captured` of `kind` on `device`: a
    replay (its copies marked on the card) or an eager run of the body
    (host-only). Reads the host flag and writes the card's when it changed;
    returns `OFF`, whose spans do nothing, when recording is off."""
    on = active()
    if device.type == "cuda":
        set_flag(device, on)
    if not on:
        return OFF
    card = _devices[device] if replay else None
    rec = dict(kind=kind, device=str(device), replay=replay, spans={},
               stages=[], nodes=dict(nodes or {}))
    if card is not None:
        if len(card.calls) < MAX_CALLS:
            card.calls.append(rec)
        else:
            card.lost_calls += 1
    elif len(_eager["calls"]) < MAX_CALLS:
        _eager["calls"].append(rec)
    else:
        _eager["lost"] += 1
    return _Call(kind, card, rec)


def drain() -> dict:
    """The record since the last drain, then cleared: "calls", each with its
    kind, device, whether it was a replay, its host spans (name -> (start,
    end) ns), the eager stage spans, its graph's nodes by type and, for a
    replay, its marks (each a dict of RECORD_FIELDS, the stage by name, in
    the order they ran) and call id; "lost" (marks past a full ring),
    "lost_calls", and per card the clock offsets ("clock": the one taken
    when recording turned on, and one taken now)."""
    out = dict(calls=_eager["calls"], lost=0, lost_calls=_eager["lost"],
               clock={})
    for i, c in enumerate(out["calls"]):
        c["call"] = i + 1
    _eager.update(calls=[], lost=0)
    for dev, card in _devices.items():
        torch.cuda.synchronize(dev)
        n = int(card.cursor.item())
        ring = card.ring[:min(n, RING_RECORDS)].tolist()
        card.cursor.zero_()
        card.calls_done.zero_()
        by_call: dict = {}
        for row in ring:
            r = dict(zip(RECORD_FIELDS, row))
            r["stage"] = _stage_names[r["stage"]]
            by_call.setdefault(r["call"], []).append(r)
        for i, c in enumerate(card.calls):
            c["call"] = i + 1
            c["marks"] = by_call.get(i + 1, [])
        out["calls"] += card.calls
        out["lost"] += max(0, n - RING_RECORDS)
        out["lost_calls"] += card.lost_calls
        if card.clock:
            now = clock_offset(dev)
            out["clock"][str(dev)] = card.clock + [now]
            card.clock = [now] if card.flag else []
        card.calls, card.lost_calls = [], 0
    return out


def offset_at(clock: list, host_ns: float) -> float:
    """The card's clock minus the host's at host_ns, from a drained card's
    clock measurements: the first and last joined by a line (the clocks
    drift apart by some ns a second)."""
    first, last = clock[0], clock[-1]
    if last["host_ns"] == first["host_ns"]:
        return first["offset_ns"]
    rate = ((last["offset_ns"] - first["offset_ns"])
            / (last["host_ns"] - first["host_ns"]))
    return first["offset_ns"] + rate * (host_ns - first["host_ns"])


def to_host(clock: list, card_ns: float) -> float:
    """A time on the card's clock on the host's (`offset_at`, refined
    once)."""
    host = card_ns - clock[0]["offset_ns"]
    return card_ns - offset_at(clock, host)


def timeline(rec: dict) -> list:
    """A drained record's replays as rows on the host's clock: (track,
    name, start ns, end ns). Track "stages": each stage from its mark to the
    next, and the copies as the card ran them; track "gaps": the card's
    time between them, split by the host spans it overlaps (each part named
    by its span) and "caller" for the parts that lie in none of the
    program's spans."""
    rows = []
    for c in rec["calls"]:
        clock = rec["clock"].get(c["device"])
        if not c.get("marks") or not clock:
            continue
        graph = [m for m in c["marks"] if m["stage"] not in (COPY_IN, COPY_OUT)]
        rows += [("stages", a["stage"], to_host(clock, a["t_ns"]),
                  to_host(clock, b["t_ns"]))
                 for a, b in zip(graph[:-1], graph[1:])]
        for name in (COPY_IN, COPY_OUT):
            t = [to_host(clock, m["t_ns"]) for m in c["marks"]
                 if m["stage"] == name]
            if len(t) == 2:
                rows.append(("stages", name, t[0], t[1]))
    host = sorted((t0, t1, f"graphs.{c['kind']}.{k}") for c in rec["calls"]
                  for k, (t0, t1) in c["spans"].items())
    busy = sorted((a, b) for _, _, a, b in rows)
    reach = busy[0][1] if busy else 0
    for a, b in busy[1:]:
        if a > reach:
            rows += _gap_rows(reach, a, host)
        reach = max(reach, b)
    return rows


def _gap_rows(lo: float, hi: float, host: list) -> list:
    """The gap [lo, hi) as rows: each part that a host span (start, end,
    name; sorted, disjoint) overlaps, by the span's name, and the rest as
    "caller"."""
    rows, at = [], lo
    for t0, t1, name in host:
        a, b = max(at, t0), min(hi, t1)
        if b <= a:
            continue
        if a > at:
            rows.append(("gaps", "caller", at, a))
        rows.append(("gaps", name, a, b))
        at = b
    if hi > at:
        rows.append(("gaps", "caller", at, hi))
    return rows
