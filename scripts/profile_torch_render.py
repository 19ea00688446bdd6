#!/usr/bin/env python3
"""Where the time of one forward frame goes on a CUDA card (PyTorch port).

    python3 scripts/profile_torch_render.py [--out F]

Renders the chip_smoke.py main path (1M-Gaussian SH-3 random scene, seed 0,
1920x1080, the bench config with the f32 stream, its four views) as users
run it: `render_jit`, one CUDA graph replayed per frame. It reports:
  - device ms (CUDA events) and wall ms (host clock to a synchronise) per
    frame, medians over REPS rounds of the views, after a warm-up round
    (whose first call captures);
  - from torch.profiler over one round: the busy share of the wall and the
    kernels by name; and, from the program's record of those replays
    (`gsplat_tpu_torch/utils/trace.py`), the card's ms per frame in each
    stage of `render.pipeline.STAGES` (from its mark to the next), in the
    copies in and out, and in the gaps between them, named by the host
    span each lies in.
With --out, writes the same numbers as JSON to that file.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the main path's config and views)

REPS = 5  # timed rounds over the views, after one warm-up round


def replay_row(call, n: int) -> dict:
    """The replayed call's row: call(v) for the views v < n, one warm-up
    round (the first call captures), then device and wall ms per call
    (medians over REPS rounds), and one profiled round's busy share,
    kernels by name and the record's stages, per call."""
    from gsplat_tpu_torch.utils import trace

    for v in range(n):
        call(v)
    timed = chip_smoke.timed_calls(lambda i: call(i % n), REPS * n)
    trace.drain()
    prof = chip_smoke.profile_window(lambda: [call(v) for v in range(n)], 1)
    rec = trace.drain()
    return dict(device_ms=timed["device_ms"], wall_ms=timed["host_ms"],
                calls=timed["n"], profiled_wall_ms=prof["wall_ms"] / n,
                kernel_ms=prof["kernel_ms"] / n,
                busy_share=prof["busy_share"],
                stages=per_call_ms(rec), marks_lost=rec["lost"],
                graph_nodes=rec["calls"][-1]["nodes"] if rec["calls"] else {},
                kernels={k: dict(ms=v["ms"] / n, calls=v["calls"] / n)
                         for k, v in prof["kernels"].items()})


def per_call_ms(rec: dict) -> dict:
    """The card's ms per replay in each row of the record's timeline
    (`trace.timeline`), by track and name: stages, copies, gaps."""
    from gsplat_tpu_torch.utils import trace

    calls = max(1, sum(1 for c in rec["calls"] if c.get("marks")))
    out: dict = {}
    for track, name, a, b in trace.timeline(rec):
        key = f"{track}:{name}"
        out[key] = out.get(key, 0.0) + (b - a) / 1e6 / calls
    return out


def print_row(what: str, row: dict, top: int) -> None:
    print(f"[replay] {what}: device {row['device_ms']} ms, wall "
          f"{row['wall_ms']} ms per call; profiled wall "
          f"{row['profiled_wall_ms']} ms, kernels {row['kernel_ms']} ms, "
          f"busy share {row['busy_share']}, graph nodes {row['graph_nodes']}")
    print(f"[stages] per call, from the record of the profiled replays "
          f"({row['marks_lost']} marks lost):")
    for name, ms in row["stages"].items():
        print(f"  {ms:9.4f} ms  {name}")
    for name, v in list(row["kernels"].items())[:top]:
        print(f"  {v['ms']:9.4f} ms  x{v['calls']:<5g} {name[:90]}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_render: needs a CUDA card", file=sys.stderr)
        return 1
    from gsplat_tpu_torch import RenderConfig, random_scene, render_jit
    from gsplat_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    _build.build_all()
    cfg = RenderConfig(**chip_smoke.BENCH)
    scene = random_scene(chip_smoke.NUM_GAUSSIANS, sh_degree=3,
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cams = chip_smoke.views(cfg.width, cfg.height, dev)
    replay = replay_row(lambda v: render_jit(scene, cams[v], cfg), len(cams))
    print_row(f"render_jit on {card}", replay, 15)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, replay=replay), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
