"""Command-line entry point of the port (port of `gsplat_tpu.cli`):

    python -m gsplat_tpu_torch.cli {render,info,bench,train,warmup} ...

Subcommands:
  render   PLY (+ optional cameras.json) -> PNG(s)
  info     print scene statistics
  bench    fwd / fwd+bwd timing (utils/bench.py::run_bench)
  train    fit a fresh scene to orbit renders of a target (train/loop.py)
  warmup   build the CUDA kernels, then render once per capacity bucket

The flags are the JAX command's, plus `--device` (default cuda; `--device
cpu` runs the kernels' plain versions; a bare cuda under torchrun is
cuda:LOCAL_RANK), `bench --dist-backend` (the sharded bench's backend,
launched as `torchrun --standalone --nproc-per-node D -m
gsplat_tpu_torch.cli bench --sharded-tiles D ...`), `--tier-spec` (the tiered ladder,
e.g. '4:0,8:2,16:6,32:25,64:50') and `train --retighten-capacity` (fit's
staged-capacity schedule). `--impl` is accepted so that a JAX command line
runs unchanged, and selects nothing: the port has one path. The JAX command
also turns on XLA's persistent compilation cache; the port has nothing to
cache there: `nvcc`'s output is kept under `build/` (ops/cuda/_build.py),
and `warmup` fills it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_cfg(args, width: int, height: int):
    from gsplat_tpu_torch.config import RenderConfig, parse_tier_spec

    if getattr(args, "viewer_preset", False):
        # The interactive-viewer configuration of the JAX command: tile 32,
        # the dual-distribution tier ladder, K_max 32 with jumbo tiers to
        # 1024, the packed4 stream.
        return RenderConfig(
            width=width, height=height, tile_size=32,
            max_intersections=args.max_intersections
            if args.max_intersections != (1 << 22) else 2_330_000,
            max_tiles_per_gaussian=32, block_size=32, max_per_tile=8192,
            sh_degree=args.sh_degree, binning="tiered",
            tier_spec=((4, 0), (8, 6), (16, 35), (32, 135)),
            pallas_block_size=128, stream_format="packed4",
            matmul_precision="high",
            max_tiles_jumbo=1024,
            jumbo_tier_spec=(
                (64, 11264), (128, 5120), (256, 1792), (512, 512),
                (1024, 64),
            ),
        )
    extra = {}
    if getattr(args, "tier_spec", None):
        extra["tier_spec"] = parse_tier_spec(args.tier_spec)
    return RenderConfig(
        width=width,
        height=height,
        tile_size=args.tile_size,
        max_intersections=args.max_intersections,
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        block_size=args.block_size,
        max_per_tile=args.max_per_tile,
        sh_degree=args.sh_degree,
        binning=args.binning,
        gather_backward=args.gather_backward,
        grad_readout=args.grad_readout,
        segment_sum=args.segment_sum,
        stream_format=args.stream_format,
        **extra,
    )


def _bucket(n: int) -> int:
    """Round a Gaussian count up to the nearest capacity bucket (1, 1.5,
    2, 3, 4, 6, 8 ... x 10^k). Scenes padded to a shared bucket share their
    tensor shapes; padding slots are transparent and culled."""
    k = 1
    while True:
        for m in (10, 15, 20, 30, 40, 60, 80):
            b = m * k // 10
            if n <= b:
                return b
        k *= 10


def _device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")


def _common_flags(p: argparse.ArgumentParser):
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--tile-size", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--max-intersections", type=int, default=1 << 22)
    p.add_argument("--max-tiles-per-gaussian", type=int, default=64)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--max-per-tile", type=int, default=4096)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--impl", default="jnp", choices=["jnp", "pallas"],
                   help="the JAX command's rasterizer choice; selects "
                        "nothing in the port")
    p.add_argument("--binning", default="sort",
                   choices=["sort", "scatter", "packed", "tiered"])
    p.add_argument("--tier-spec", default=None,
                   help="tiered ladder, e.g. '4:0,8:2,16:6,32:25,64:50'")
    p.add_argument("--gather-backward", default="variadic",
                   choices=["variadic", "permute", "c64", "bf16"],
                   help="slot-gradient reduction strategy (see RenderConfig)")
    p.add_argument("--grad-readout", default="f32", choices=["f32", "bf16"])
    p.add_argument("--segment-sum", default="doubling",
                   choices=["doubling", "pallas"])
    p.add_argument("--stream-format", default="f32",
                   choices=["f32", "packed16", "packed4"],
                   help="packed16 / packed4: int32 rows instead of 9 f32 "
                   "(quantized forward, straight-through grads)")
    _device_flag(p)


def _load_scene(args):
    import torch

    from gsplat_tpu_torch.io.ply import load_ply
    from gsplat_tpu_torch.models.gaussians import random_scene

    if args.ply == "synthetic":
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        return random_scene(args.synthetic_n, min(args.sh_degree, 3),
                            generator=gen, device=args.device)
    return load_ply(args.ply, device=args.device)


def _render_cameras(args, scene):
    """[(name, Camera)]: the cameras.json entries, an orbit, or the
    default camera."""
    import numpy as np

    from gsplat_tpu_torch.ops.camera import Camera, orbit_cameras

    if args.cameras:
        from gsplat_tpu_torch.io.cameras import load_cameras

        cams = load_cameras(args.cameras, width_override=args.width,
                            height_override=args.height, device=args.device)
        if args.camera_index is not None:
            cams = [cams[args.camera_index]]
        return cams
    if args.orbit:
        means = scene.means.cpu().numpy()
        center = means.mean(0)
        radius = float(np.percentile(
            np.linalg.norm(means - center, axis=-1), 90) * 2.0)
        return [
            (f"orbit_{i:03d}", c)
            for i, c in enumerate(orbit_cameras(
                center, radius, args.orbit, args.width, args.height,
                fx=float(args.width), fy=float(args.height),
                device=args.device))
        ]
    return [("default", Camera.default(args.width, args.height,
                                       device=args.device))]


def _prepare_render(args):
    """(scene, cfg, cameras) of `render`: the scene padded to its capacity
    bucket with --pad-bucket."""
    scene = _load_scene(args)
    print(f"scene: {scene.num_gaussians} gaussians, SH degree {scene.sh_degree}")
    if getattr(args, "pad_bucket", False):
        b = _bucket(scene.num_gaussians)
        if b > scene.num_gaussians:
            scene = scene.pad_to(b)
            print(f"padded to capacity bucket {b}")
    return scene, _build_cfg(args, args.width, args.height), \
        _render_cameras(args, scene)


def cmd_render(args) -> int:
    import torch

    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.utils.bench import synchronize
    from gsplat_tpu_torch.utils.image import write_png

    scene, cfg, cams = _prepare_render(args)
    for name, cam in cams:
        t0 = time.perf_counter()
        out = render_jit(scene, cam, cfg)
        synchronize(args.device)
        dt = time.perf_counter() - t0
        path = args.output.replace("{}", name)
        write_png(path, out.image.cpu().numpy())
        print(
            f"{name}: {dt * 1000:.1f} ms, {int(out.num_intersections)} intersections"
            f"{' [OVERFLOW]' if bool(out.overflow) else ''} -> {path}"
        )
    return 0


def cmd_info(args) -> int:
    import torch

    scene = _load_scene(args)
    means = scene.means.cpu().numpy()
    print(json.dumps({
        "num_gaussians": int(scene.num_gaussians),
        "sh_degree": int(scene.sh_degree),
        "bbox_min": means.min(0).tolist(),
        "bbox_max": means.max(0).tolist(),
        "mean_scale": float(torch.exp(scene.log_scales).mean()),
    }, indent=2))
    return 0


def cmd_bench(args) -> int:
    """A reproducible bench (utils/bench.py), and with --profile DIR a
    `torch.profiler` trace of it, written to DIR/trace.json (Chrome trace
    format: chrome://tracing or Perfetto), with the program's record of
    the replays inside it as rows of their own (`add_record_rows`): a
    replay shows its stages, not one cudaGraphLaunch. With --sharded-tiles every rank
    started by torchrun runs it, on the backend --dist-backend names, and
    rank 0 prints the line."""
    import os

    from gsplat_tpu_torch.parallel.multihost import is_primary
    from gsplat_tpu_torch.utils.bench import run_bench

    if not args.profile:
        result = _run_bench_args(args, run_bench)
        if is_primary():
            print(json.dumps(result))
        return 0
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    from gsplat_tpu_torch.utils import trace

    trace.drain()
    with profile(activities=acts) as prof:
        result = _run_bench_args(args, run_bench)
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(path)
    add_record_rows(path, trace.drain())
    if is_primary():
        print(json.dumps(result))
    return 0


# The process and threads of the record's rows in a Chrome trace.
RECORD_PID = 1 << 30
RECORD_TRACKS = ("stages", "gaps")


def add_record_rows(path: str, rec: dict) -> int:
    """Add the program's record of the profiled replays
    (`utils/trace.py::timeline`: each stage from its mark to the next, the
    copies, the card's gaps split by the host spans they overlap) to the
    Chrome trace at `path`, as rows of a process of their own on the
    profiler's timeline, placed by the replays' launch spans, which both
    hold. Returns the rows added (none without replays to place)."""
    import statistics

    from gsplat_tpu_torch.utils import trace

    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    # The host's spans only: the trace also draws a span's device side
    # ("gpu_user_annotation") under the same name.
    launch_ts = sorted(e["ts"] for e in events if e.get("ph") == "X"
                       and e.get("cat") != "gpu_user_annotation"
                       and e.get("name", "").startswith("graphs.")
                       and e["name"].endswith(".launch"))
    launch_ns = sorted(c["spans"]["launch"][0] for c in rec["calls"]
                       if "launch" in c["spans"])
    rows = trace.timeline(rec)
    if not rows or len(launch_ts) != len(launch_ns):
        return 0
    # The trace's clock (us) minus the host's monotonic clock (ns).
    shift = statistics.median(float(ts) * 1e3 - ns
                              for ts, ns in zip(launch_ts, launch_ns))
    events.append(dict(ph="M", name="process_name", pid=RECORD_PID,
                       args=dict(name="gsplat_tpu_torch record of replays")))
    events += [dict(ph="M", name="thread_name", pid=RECORD_PID, tid=i,
                    args=dict(name=t)) for i, t in enumerate(RECORD_TRACKS)]
    events += [dict(ph="X", name=name, cat="trace", pid=RECORD_PID,
                    tid=RECORD_TRACKS.index(track), ts=(a + shift) / 1e3,
                    dur=(b - a) / 1e3) for track, name, a, b in rows]
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(rows)


def _run_bench_args(args, run_bench):
    from gsplat_tpu_torch.config import parse_tier_spec
    from gsplat_tpu_torch.parallel.multihost import rank_device

    extra = {}
    if args.tier_spec:
        extra["tier_spec"] = parse_tier_spec(args.tier_spec)
    return run_bench(
        num_gaussians=args.synthetic_n,
        width=args.width,
        height=args.height,
        impl=args.impl,
        mode=args.mode,
        iters=args.iters,
        tile_size=args.tile_size,
        max_intersections=args.max_intersections,
        block_size=args.block_size,
        ply=None if args.ply == "synthetic" else args.ply,
        binning=args.binning,
        sharded_tiles=args.sharded_tiles or None,
        data_shards=args.data_shards,
        ssim_weight=args.ssim_weight,
        device=rank_device(args.device),
        dist_backend=args.dist_backend,
        **extra,
    )


def cmd_train(args) -> int:
    from gsplat_tpu_torch.train.loop import train_from_cli

    return train_from_cli(args)


def cmd_warmup(args) -> int:
    """Build every CUDA kernel into `build/` (one nvcc per source, all at
    once), then per capacity bucket build, capture and replay the viewer
    preset's frame (`render_jit`: compile once, serve every scene under the
    bucket) and print the first call's time (warm-up and capture) and the
    steady, replayed frame's. A later `render --viewer-preset
    --pad-bucket` then finds its kernels built."""
    import torch

    from gsplat_tpu_torch.models.gaussians import random_scene
    from gsplat_tpu_torch.ops.camera import Camera
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.utils.bench import synchronize

    if torch.device(args.device).type == "cuda":
        from gsplat_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        print(f"kernels built in {_build.build_all()} "
              f"({time.perf_counter() - t0:.1f} s)")
    buckets = [int(x) for x in args.buckets.split(",")]
    args.viewer_preset = True
    cfg = _build_cfg(args, args.width, args.height)
    cam = Camera.default(args.width, args.height, device=args.device)
    for b in buckets:
        gen = torch.Generator(device=args.device).manual_seed(0)
        scene = random_scene(b, min(args.sh_degree, 3), generator=gen,
                             device=args.device)
        synchronize(args.device)
        t0 = time.perf_counter()
        render_jit(scene, cam, cfg)
        synchronize(args.device)
        t1 = time.perf_counter()
        render_jit(scene, cam, cfg)
        synchronize(args.device)
        t2 = time.perf_counter()
        print(f"bucket {b}: first frame (warm-up and capture) "
              f"{t1 - t0:.1f} s, steady frame {(t2 - t1) * 1000:.1f} ms")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "gsplat_tpu_torch.cli",
        description="3D Gaussian Splatting on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render PLY to PNG")
    p.add_argument("ply", help="path to .ply, or 'synthetic'")
    p.add_argument("--cameras", help="cameras.json path")
    p.add_argument("--camera-index", type=int)
    p.add_argument("--orbit", type=int, help="render N orbit views")
    p.add_argument("--output", "-o", default="render_{}.png",
                   help="output path; '{}' is replaced by the camera name")
    p.add_argument("--synthetic-n", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viewer-preset", action="store_true",
                   help="the interactive config (tile 32, tiered ladder, "
                        "K_max 32 with jumbo tiers to 1024, packed4) "
                        "instead of the portable defaults")
    p.add_argument("--pad-bucket", action="store_true",
                   help="pad the scene to the nearest capacity bucket")
    _common_flags(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "warmup",
        help="build the CUDA kernels, then render the viewer preset once "
             "per capacity bucket")
    p.add_argument("--buckets", default="600000,800000,1000000",
                   help="comma-separated Gaussian capacity buckets")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--max-intersections", type=int, default=1 << 22)
    _device_flag(p)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("info", help="scene statistics")
    p.add_argument("ply")
    p.add_argument("--synthetic-n", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sh-degree", type=int, default=3)
    _device_flag(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="benchmark fwd / fwd+bwd throughput")
    p.add_argument("--ply", default="synthetic")
    p.add_argument("--synthetic-n", type=int, default=1_000_000)
    p.add_argument("--mode", default="fwd_bwd", choices=["fwd", "fwd_bwd"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")
    p.add_argument("--sharded-tiles", type=int, default=0,
                   help="bench the tile-sharded path on a data-shards x N "
                        "mesh, one process per rank started by torchrun "
                        "(max-intersections becomes the per-shard capacity)")
    p.add_argument("--data-shards", type=int, default=1)
    p.add_argument("--ssim-weight", type=float, default=0.0)
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of the sharded bench: "
                        "nccl with one card per rank, gloo on the CPU or "
                        "for ranks sharing one card (--device cuda:0)")
    _common_flags(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("train", help="fit a scene to target renders")
    p.add_argument("--ply", default="synthetic")
    p.add_argument("--synthetic-n", type=int, default=5000)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="trained.ply")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", help="checkpoint path to resume from")
    p.add_argument("--densify-every", type=int, default=0,
                   help="adaptive density control interval (0 = off); the "
                        "scene is padded to --capacity")
    p.add_argument("--capacity", type=int, default=0,
                   help="static Gaussian capacity for densification "
                        "(default 2x the initial count)")
    p.add_argument("--densify-grad-threshold", type=float, default=2e-4)
    p.add_argument("--densify-from", type=int, default=0,
                   help="first densification step (graphdeco: 500)")
    p.add_argument("--densify-until", type=int, default=None,
                   help="stop densifying after this step (default steps/2)")
    p.add_argument("--densify-max-scale", type=float, default=None,
                   help="prune splats whose world scale exceeds this "
                        "(3DGS 5.2 big-splat prune)")
    p.add_argument("--opacity-reset-every", type=int, default=0,
                   help="periodic opacity reset interval (3DGS 5.2)")
    p.add_argument("--overflow-policy", default="raise",
                   choices=["raise", "warn", "ignore"])
    p.add_argument("--ssim-weight", type=float, default=0.2,
                   help="loss = (1-w)*L1 + w*DSSIM (0 disables SSIM)")
    p.add_argument("--batch", type=int, default=1,
                   help="views per training step")
    p.add_argument("--sh-warmup-every", type=int, default=0,
                   help="activate one more SH band every N steps "
                        "(graphdeco oneupSHdegree; 0 = all bands from "
                        "step 0)")
    p.add_argument("--position-lr-final-ratio", type=float, default=None,
                   help="exponential position-lr decay to lr*ratio over "
                        "the run (graphdeco: 0.01)")
    p.add_argument("--holdout-views", type=int, default=0,
                   help="extra orbit views excluded from training, used "
                        "for held-out PSNR")
    p.add_argument("--eval-every", type=int, default=0,
                   help="held-out PSNR eval interval (needs "
                        "--holdout-views)")
    p.add_argument("--metrics-csv", default=None,
                   help="append per-step metrics rows to this CSV")
    p.add_argument("--retighten-capacity", type=float, default=0.0,
                   help="after densification, rebuild the step at this "
                        "multiple of the measured peak stream demand "
                        "(fit's staged-capacity schedule; 0 = off)")
    _common_flags(p)
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
