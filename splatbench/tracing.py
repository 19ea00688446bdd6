"""From a `torch.profiler` trace of a window of replayed calls to the
numbers the per-layer metrics read.

The profiler can drop records of kernels inside a graph replay, so a
kernel's time per call is the mean of the records it kept times the
launches per call that one eager pass of the same body counts
(`eager_counts`); a kernel the eager pass does not launch keeps its
records' sum. The device's busy time is the union of its kernels, copies
and sets over the window, whose length is the host's clock around the
window's calls and the synchronise that ends it.
"""

from __future__ import annotations

import contextlib
import time

import torch

# The program's kernels by name (csrc/*.cu): K3 the cull, K1 and K2 the
# blend and its backward, K4 and K5 the segmented sums over float32 rows
# and bf16 pairs.
PORT_KERNELS = {"K1": "raster_fwd_kernel", "K2": "raster_bwd_kernel",
                "K3": "cull_kernel", "K4": "F32Rows", "K5": "Bf16Pairs"}
NCCL = "nccl"
WINDOW_SPAN = "splatbench.window"
BREAKDOWN_ENTRIES = 10


def kernel_class(name: str) -> str:
    """'K1'..'K5', 'nccl', 'copy' (a copy or set), 'sort' (a sort kernel
    of PyTorch's) or 'torch' (any other PyTorch kernel)."""
    for k, sub in PORT_KERNELS.items():
        if sub in name:
            return k
    low = name.lower()
    if NCCL in low:
        return "nccl"
    if low.startswith(("memcpy", "memset")):
        return "copy"
    if "sort" in low:
        return "sort"
    return "torch"


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


@contextlib.contextmanager
def profiled():
    """A CPU and CUDA profiler around the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def eager_counts(prof, calls: int = 1) -> dict:
    """Kernel launches per call by name, of a profiled eager pass."""
    counts: dict = {}
    for e in _device_events(prof):
        if kernel_class(e.name) != "copy":
            counts[e.name] = counts.get(e.name, 0) + 1
    return {k: v / calls for k, v in counts.items()}


def sync(device) -> None:
    """Wait for the card's queue; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(calls: int, body, device):
    """Run body(i) for i < calls inside the window span, after a
    synchronise and ending in one. Returns the host seconds."""
    sync(device)
    with torch.profiler.record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        for i in range(calls):
            body(i)
        sync(device)
        return time.perf_counter() - t0


def reduce(prof, window_s: float, calls: int, eager: dict) -> dict:
    """The trace of `calls` calls in window_s host seconds: kernels by name
    (records, seconds), the device's busy seconds (the union of its
    operations over the window), and the breakdown: the device operations
    that took most time, and the longest idle gaps named by what the host
    was doing in them."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type == DeviceType.CPU]
    lo = min(e.time_range.start for e in window) if window else None
    hi = max(e.time_range.end for e in window) if window else None
    dev = _device_events(prof)
    if lo is None:
        lo = min((e.time_range.start for e in dev), default=0.0)
        hi = max((e.time_range.end for e in dev), default=0.0)
    kernels: dict = {}
    spans = []
    for e in dev:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        k = kernels.setdefault(e.name, {"n": 0, "sum_s": 0.0})
        k["n"] += 1
        k["sum_s"] += (e.time_range.end - e.time_range.start) * 1e-6
        spans.append((s, t))
    spans.sort()
    busy_us, gaps = 0.0, []
    cur_s, cur_t = lo, lo
    for s, t in spans:
        if s > cur_t:
            busy_us += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy_us += cur_t - cur_s
    if hi > cur_t:
        gaps.append((cur_t, hi))
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name != WINDOW_SPAN]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    idle = [[_host_at(host, (a + b) / 2), (b - a) * 1e-6] for a, b in longest]
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["sum_s"])
    return dict(
        calls=calls, window_s=window_s, busy_s=busy_us * 1e-6,
        kernels=kernels, eager=eager,
        breakdown=dict(
            device_ops=[[n, v["sum_s"]] for n, v in top[:BREAKDOWN_ENTRIES]],
            idle_gaps=idle))


def _host_at(host_events, t: float) -> str:
    """The innermost host event (the latest to start) running at t."""
    best = None
    for e in host_events:
        if e.time_range.start <= t <= e.time_range.end and (
                best is None or e.time_range.start > best.time_range.start):
            best = e
    return f"host: {best.name}" if best is not None else "host: no event"


def seconds_per_call(trace: dict, classes) -> float:
    """Device seconds per call of the kernels of `classes`: per name, the
    mean record times the eager launches per call where the eager pass
    launches it, else the records' sum over the calls."""
    total = 0.0
    for name, k in trace["kernels"].items():
        if kernel_class(name) not in classes:
            continue
        if name in trace["eager"]:
            total += k["sum_s"] / k["n"] * trace["eager"][name]
        else:
            total += k["sum_s"] / trace["calls"]
    return total


def kernel_ms(trace: dict, classes) -> float | None:
    """Device ms per call in the kernels of `classes`; None where the
    window ran none."""
    if not any(kernel_class(n) in classes for n in trace["kernels"]):
        return None
    return 1e3 * seconds_per_call(trace, classes)


def roofline_pct(trace: dict, kernel: str) -> float | None:
    """The kernel's share of its roofline: the least time its work per call
    needs (`roofline.bound_s`) over its device time per call; None where
    the window ran no such kernel."""
    from splatbench import roofline

    t = seconds_per_call(trace, {kernel})
    if t <= 0.0 or kernel not in trace["work"]:
        return None
    return 100.0 * roofline.bound_s(*trace["work"][kernel]) / t


def mfu_pct(trace: dict) -> float:
    """The FP32 operations a call's work needs over the card's peak in the
    window's time per call."""
    from splatbench import roofline

    per_call_s = trace["window_s"] / trace["calls"]
    return 100.0 * trace["work"]["ops"] / (roofline.PEAK_FP32_OPS * per_call_s)


def idle_pct(trace: dict) -> float:
    """The share of the window in which no operation ran on the card."""
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
