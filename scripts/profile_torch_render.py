#!/usr/bin/env python3
"""Where the time of one forward render goes on a CUDA card (PyTorch port).

    python3 scripts/profile_torch_render.py [--out F]

Renders the chip_smoke.py main path (1M-Gaussian SH-3 random scene, seed 0,
1920x1080, the bench config with the f32 stream, its four views) through
`gsplat_tpu_torch.render` itself and reports:
  - the frame's device time between CUDA events around `render`, median over
    REPS rounds of the views;
  - from torch.profiler over one frame of each view, per stage of
    `render.pipeline.STAGES` (the spans `render` opens): the stage's span on
    the device clock, and the device time of the kernels that start inside
    it (by time, since the CUDA kernels launched through ctypes have no
    PyTorch op to be attributed to);
  - the device time of every kernel by name, their sum, and the device's
    busy share of the frame's host wall time;
  - one row for the frame replayed as a CUDA graph (`render_jit`, the
    port's one dispatch per frame): device ms (CUDA events) and wall ms
    (host clock to a synchronise), medians over REPS rounds of the views,
    and from torch.profiler over one round, the busy share of the wall and
    the kernels by name.
With --out, writes the same numbers as JSON to that file.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the main path's config and views)

REPS = 5  # timed rounds over the views, after one warm-up frame


def replay_row(call, n: int) -> dict:
    """The replayed call's row: call(v) for the views v < n, one warm-up
    round (the first call captures), then device and wall ms per call
    (medians over REPS rounds) and one profiled round's busy share and
    kernels by name, per call."""
    for v in range(n):
        call(v)
    timed = chip_smoke.timed_calls(lambda i: call(i % n), REPS * n)
    prof = chip_smoke.profile_window(lambda: [call(v) for v in range(n)], 1)
    return dict(device_ms=timed["device_ms"], wall_ms=timed["host_ms"],
                calls=timed["n"], profiled_wall_ms=prof["wall_ms"] / n,
                kernel_ms=prof["kernel_ms"] / n,
                busy_share=prof["busy_share"],
                kernels={k: dict(ms=v["ms"] / n, calls=v["calls"] / n)
                         for k, v in prof["kernels"].items()})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_render: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch import RenderConfig, random_scene, render, render_jit
    from gsplat_tpu_torch.ops.cuda import _build
    from gsplat_tpu_torch.render.pipeline import STAGES

    dev = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    _build.build_all()
    cfg = RenderConfig(**chip_smoke.BENCH)
    scene = random_scene(chip_smoke.NUM_GAUSSIANS, sh_degree=3,
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cams = chip_smoke.views(cfg.width, cfg.height, dev)

    render(scene, cams[0], cfg)  # warm-up
    torch.cuda.synchronize()
    totals = []
    for _ in range(REPS):
        for cam in cams:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render(scene, cam, cfg)
            end.record()
            torch.cuda.synchronize()
            totals.append(start.elapsed_time(end))
    frame_ms = statistics.median(totals)
    print(f"[frame] median device ms per frame over {len(totals)} frames: "
          f"{frame_ms}, {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            render(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    # The device-clock span of each stage (the profiler's GPU-side record of
    # a record_function range), and every kernel by name with its start.
    spans = []
    kernels: dict[str, list[float]] = {}
    starts = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in STAGES:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            kernels.setdefault(e.name, []).append(e.device_time_total)
            starts.append((e.time_range.start, e.device_time_total))
    kernel_us = dict.fromkeys(STAGES, 0.0)
    span_us = dict.fromkeys(STAGES, 0.0)
    for lo, hi, name in spans:
        span_us[name] += hi - lo
        kernel_us[name] += sum(us for t, us in starts if lo <= t < hi)
    n = len(cams)
    stages = {s: {"span_ms": span_us[s] / 1e3 / n,
                  "kernel_ms": kernel_us[s] / 1e3 / n} if spans else None
              for s in STAGES}
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / n
    print(f"[stages] per frame, torch.profiler over {n} frames:")
    for s, v in stages.items():
        print(f"  {s:16s} " + ("not measured: no device-side spans" if v is None
                               else f"span {v['span_ms']:9.4f} ms, kernels "
                               f"{v['kernel_ms']:9.4f} ms"))
    print(f"[profile] host wall {wall_ms} ms per frame, device kernels "
          f"{busy_ms} ms per frame, busy share "
          f"{busy_ms / wall_ms if kernels else 'not measured'}")
    top = sorted(((name, sum(v) / 1e3 / n, len(v) // n)
                  for name, v in kernels.items()), key=lambda t: -t[1])
    for name, ms, calls in top[:15]:
        print(f"  {ms:9.4f} ms  x{calls:<3d} {name[:90]}")
    replay = replay_row(lambda v: render_jit(scene, cams[v], cfg), len(cams))
    print(f"[replay] render_jit: device {replay['device_ms']} ms, wall "
          f"{replay['wall_ms']} ms per frame; profiled wall "
          f"{replay['profiled_wall_ms']} ms, kernels {replay['kernel_ms']} "
          f"ms, busy share {replay['busy_share']}")
    for name, v in list(replay["kernels"].items())[:15]:
        print(f"  {v['ms']:9.4f} ms  x{v['calls']:<5g} {name[:90]}")
    out = dict(card=card, frames=len(totals), frame_ms_events=frame_ms,
               profile=dict(frames=n, wall_ms_per_frame=wall_ms,
                            kernel_ms_per_frame=busy_ms, stages=stages,
                            kernels={name: {"ms_per_frame": ms,
                                            "calls_per_frame": calls}
                                     for name, ms, calls in top}),
               replay=replay)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
