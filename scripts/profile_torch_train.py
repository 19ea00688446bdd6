#!/usr/bin/env python3
"""Where the time of one training step goes on a CUDA card (PyTorch port).

    python3 scripts/profile_torch_train.py [--scene random|realistic]
        [--out F]

Runs the training main path of chip_smoke.py (the exact-gradient step, L1 +
0.2 DSSIM and Adam, on the 1M-Gaussian SH-3 random scene at 1920x1080, the
bench config with the f32 stream, one of the four views per step) through
the step's eager body (`make_eager_train_step`, whose spans the profile
reads), after one warm-up round of the views. --scene
realistic takes the 1M-Gaussian realistic scene with the jumbo ladder of
bench.py:246-253 (chip_smoke.JUMBO) instead. It reports:
  - the step's time: device ms between CUDA events around the step, and
    host ms of a step that ends in `torch.cuda.synchronize()`, medians over
    REPS rounds of the views;
  - from torch.profiler over one round, per span of `train.loop.TRAIN_SPANS`
    and of `render.pipeline.STAGES` (the render's stages nest in
    train.forward): the device time of the kernels launched inside the
    span. A kernel is placed by the host time of its launch (the CUDA
    runtime call with its correlation id), because the backward runs on
    autograd's own thread, outside the spans the step opens, but inside the
    host window of train.backward;
  - the device time of every kernel by name, their sum, and the device's
    busy share of the step's host wall time;
  - one row for the step replayed as a CUDA graph (`make_train_step`, the
    port's one dispatch per step) on a second copy of the scene: device ms
    and wall ms, medians over REPS rounds, and from one profiled round the
    busy share and the kernels by name.
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

import chip_smoke  # noqa: E402  (the main path's config, views and trainer)

sys.path.insert(0, os.path.join(HERE, "scripts"))
import profile_torch_render  # noqa: E402  (the replay row)

REPS = 3  # timed rounds over the views, after one warm-up round


def is_kernel(e, spans) -> bool:
    """A device event that is work (kernel, memset, copy), not the device
    side of a user annotation (the step's spans, the optimizer's hooks)."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and e.name not in spans
            and not e.is_user_annotation)


def launch_attribution(events, spans):
    """Device ms of the kernels launched inside each span's host window,
    summed over the profile, or None when no kernel could be linked to its
    launch. `events` is `prof.events()`."""
    from torch.autograd import DeviceType

    windows = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == DeviceType.CPU and e.name in spans]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    us = dict.fromkeys(spans, 0.0)
    linked = 0
    for e in events:
        if not is_kernel(e, spans):
            continue
        t = launched.get(e.id)
        if t is None:
            continue
        linked += 1
        for lo, hi, name in windows:
            if lo <= t < hi:
                us[name] += e.device_time_total
    return ({name: v / 1e3 for name, v in us.items()} if linked else None,
            linked)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("random", "realistic"),
                    default="random")
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch import RenderConfig, random_scene, realistic_scene
    from gsplat_tpu_torch.ops.cuda import _build
    from gsplat_tpu_torch.render.pipeline import STAGES
    from gsplat_tpu_torch.train.loop import TRAIN_SPANS

    dev = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    _build.build_all()
    realistic = args.scene == "realistic"
    cfg = RenderConfig(**dict(chip_smoke.BENCH, **chip_smoke.EXACT,
                              **(chip_smoke.JUMBO if realistic else {})))
    scene = (realistic_scene if realistic else random_scene)(
        chip_smoke.NUM_GAUSSIANS, sh_degree=3,
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"[config] the {args.scene} scene: {cfg}", flush=True)
    cams = chip_smoke.views(cfg.width, cfg.height, dev)
    train, targets, step = chip_smoke.make_trainer(scene, cams, cfg, dev,
                                                   eager=True)

    def one(v):
        return step(train, [cams[v]], targets[v : v + 1])

    for v in range(len(cams)):  # warm-up round
        one(v)
    torch.cuda.synchronize()
    device_ms, host_ms = [], []
    for _ in range(REPS):
        for v in range(len(cams)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            _, aux, _ = one(v)
            end.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
            if bool(aux["overflow"]) or not bool(aux["grads_finite"]):
                raise SystemExit("profile_torch_train: a step overflowed or "
                                 "went non-finite")
    print(f"[step] median over {len(device_ms)} steps: device "
          f"{statistics.median(device_ms)} ms, host {statistics.median(host_ms)}"
          f" ms, {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for v in range(len(cams)):
            one(v)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    n = len(cams)
    events = prof.events()
    spans = TRAIN_SPANS + STAGES
    by_launch, linked = launch_attribution(events, spans)
    kernels: dict[str, list[float]] = {}
    for e in events:
        if is_kernel(e, spans):
            kernels.setdefault(e.name, []).append(e.device_time_total)
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / n
    print(f"[spans] per step, kernels placed by launch time, torch.profiler "
          f"over {n} steps ({linked} kernels linked to their launch):")
    for s in spans:
        print(f"  {s:16s} " + ("not measured: no kernel linked to its launch"
                               if by_launch is None
                               else f"{by_launch[s] / n:9.4f} ms"))
    # The profiler slows the host; the unprofiled step's host time is the
    # fairer denominator of the busy share.
    print(f"[profile] host wall {wall_ms} ms per step under the profiler, "
          f"device kernels {busy_ms} ms per step, busy share "
          f"{busy_ms / wall_ms} of the profiled step, "
          f"{busy_ms / statistics.median(host_ms)} of the unprofiled one")
    top = sorted(((name, sum(v) / 1e3 / n, len(v) / n)
                  for name, v in kernels.items()), key=lambda t: -t[1])
    for name, ms, calls in top[:20]:
        print(f"  {ms:9.4f} ms  x{calls:<5g} {name[:90]}")
    del train, step
    torch.cuda.empty_cache()
    graphed, _, gstep = chip_smoke.make_trainer(scene, cams, cfg, dev)
    replay = profile_torch_render.replay_row(
        lambda v: gstep(graphed, [cams[v]], targets[v:v + 1]), len(cams))
    print(f"[replay] make_train_step: device {replay['device_ms']} ms, wall "
          f"{replay['wall_ms']} ms per step; profiled wall "
          f"{replay['profiled_wall_ms']} ms, kernels {replay['kernel_ms']} "
          f"ms, busy share {replay['busy_share']}")
    for name, v in list(replay["kernels"].items())[:20]:
        print(f"  {v['ms']:9.4f} ms  x{v['calls']:<5g} {name[:90]}")
    out = dict(card=card, steps=len(device_ms), replay=replay,
               step_ms_device=statistics.median(device_ms),
               step_ms_host=statistics.median(host_ms),
               profile=dict(steps=n, wall_ms_per_step=wall_ms,
                            kernel_ms_per_step=busy_ms, linked=linked,
                            busy_share_unprofiled=busy_ms / statistics.median(
                                host_ms),
                            spans=None if by_launch is None else
                            {s: by_launch[s] / n for s in spans},
                            kernels={name: {"ms_per_step": ms,
                                            "calls_per_step": calls}
                                     for name, ms, calls in top}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
