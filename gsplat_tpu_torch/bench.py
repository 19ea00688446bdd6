"""The headline bench of the port, the counterpart of the repo's root
`bench.py`, flag for flag:

    python -m gsplat_tpu_torch.bench [--scene random|realistic]
        [--exact-grads] [--mode fwd|fwd_bwd] [--viewer] [--kmax K]
        [--tier-spec SPEC] [--stream-format f32|packed16|packed4]
        [--gather-backward variadic|permute|c64|bf16]
        [--segment-sum doubling|pallas] [--slot-gather i32|c64]
        [--matmul-precision default|high|highest] [--ssim-weight W]
        [--device cuda|cpu]
    torchrun --standalone --nproc-per-node D -m gsplat_tpu_torch.bench \
        {--sharded-tiles D [--data-shards 1] | --gaussian-sharded D
        [--per-dest-capacity C]} [--ssim-weight W] --dist-backend nccl|gloo

prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} (with
"overflow" and its cause when a frame overflowed) and the details on
stderr. On the card: fwd+bwd it/s at 1920x1080 with 1M Gaussians, the
root bench's configuration (tile 32, the tiered ladder, packed4 stream and
bf16-pair gradients, or float32 throughout with --exact-grads). With no
flag, the realistic scene's run, with the jumbo tiers, rides in the same
line (`realistic_it_per_s`), as in the root bench; `--scene realistic`
runs that scene without them, as the root bench does. `--viewer` is the
viewer's frame: 800x800, forward only, 30 iterations, its ladder, K_max 32
and jumbo tiers to 1024 tiles. `--device cpu` runs a small configuration
(20k Gaussians, 256x256) through the kernels' plain versions: a smoke run,
not a measurement of the card; there `--viewer` is ignored with a warning,
as off the root bench's accelerator. `build_kwargs` makes `run_bench`'s
arguments in the root bench's order (bench.py:80-207).
`--segment-sum`, `--slot-gather` and `--matmul-precision` are passed on and
select nothing in the port (`config.py`).

The sharded benches run one process per rank (torchrun), with the root
bench's settings: --sharded-tiles D gives each shard the capacity
max(4.1M // D, 4096); --gaussian-sharded D exchanges the packed16 stream
(or --stream-format's) with fragment_format='bf16'. --dist-backend names
the backend (nccl with one card per rank; gloo for ranks sharing one card,
--device cuda:0), and rank 0 prints the line.
"""

from __future__ import annotations

import argparse
import json
import sys

from gsplat_tpu_torch.config import parse_tier_spec

# The root bench's configuration on the accelerator (bench.py:85-120), in
# its order.
CARD = dict(
    num_gaussians=1_000_000, width=1920, height=1080, impl="pallas",
    mode="fwd_bwd", iters=10, tile_size=32, max_intersections=4_100_000,
    block_size=32, max_per_tile=8192, binning="tiered",
    tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)),
    pallas_block_size=128,
)
# Its default: the packed4 stream, bf16-pair slot gradients; and
# --exact-grads: float32 end to end.
DEFAULT = dict(gather_backward="bf16", grad_readout="bf16",
               segment_sum="pallas", stream_format="packed4",
               matmul_precision="high")
EXACT = dict(gather_backward="c64", grad_readout="f32", segment_sum="pallas",
             stream_format="f32", matmul_precision="highest")
# The jumbo ladder of the default headline's realistic run
# (bench.py:246-253): its fat-splat tail projects rects up to about 2040
# tiles, enumerated in full.
JUMBO = dict(max_tiles_jumbo=2048, jumbo_tier_spec=(
    (128, 14848), (256, 7168), (512, 3072), (1024, 1024), (2048, 384)))
# --viewer (bench.py:150-160): the viewer's 800x800 forward frame.
VIEWER = dict(
    width=800, height=800, mode="fwd", iters=30,
    max_intersections=2_330_000,
    tier_spec=((4, 0), (8, 6), (16, 35), (32, 135)),
    max_tiles_per_gaussian=32,
    max_tiles_jumbo=1024,
    jumbo_tier_spec=((64, 11264), (128, 5120), (256, 1792), (512, 512),
                     (1024, 64)),
)
# The root bench's small configuration off the accelerator.
SMALL = dict(num_gaussians=20_000, width=256, height=256, impl="jnp",
             mode="fwd_bwd", iters=3, tile_size=16, max_intersections=1 << 16,
             block_size=16, max_per_tile=512)


def preset(scene: str = "random", exact_grads: bool = False,
           mode: str | None = None, device="cuda",
           jumbo: bool = False) -> dict:
    """run_bench's arguments for one run: on the card the root bench's
    configuration (with the jumbo ladder when `jumbo`, as the default
    headline's realistic run has it), else its small one, which has no
    scene."""
    if str(device).startswith("cuda"):
        kw = dict(CARD, **(EXACT if exact_grads else DEFAULT),
                  scene_kind=scene)
        if jumbo:
            kw.update(JUMBO)
    else:
        kw = dict(SMALL)
    if mode:
        kw["mode"] = mode
    kw["device"] = device
    return kw


def sharded(kw: dict, sharded_tiles: int = 0, data_shards: int = 1,
            gaussian_sharded: int = 0, per_dest_capacity: int | None = None,
            ssim_weight: float = 0.0,
            stream_format: str | None = None) -> dict:
    """run_bench's arguments of a sharded run on top of a preset, as the
    root bench sets them (bench.py:183-207)."""
    kw = dict(kw)
    if gaussian_sharded:
        # The packed16 stream doubles as the fragment exchange's wire format.
        kw.update(gaussian_shards=gaussian_sharded,
                  per_dest_capacity=per_dest_capacity,
                  ssim_weight=ssim_weight,
                  stream_format=stream_format or "packed16",
                  fragment_format="bf16")
    if sharded_tiles:
        # Per-shard capacity: each shard sorts and blends only its rows.
        kw.update(sharded_tiles=sharded_tiles, data_shards=data_shards,
                  ssim_weight=ssim_weight,
                  max_intersections=max(
                      kw["max_intersections"] // sharded_tiles, 1 << 12))
    return kw


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("gsplat_tpu_torch.bench")
    ap.add_argument("--sharded-tiles", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--gaussian-sharded", type=int, default=0)
    ap.add_argument("--per-dest-capacity", type=int, default=None)
    ap.add_argument("--mode", default=None, choices=["fwd", "fwd_bwd"])
    ap.add_argument("--ssim-weight", type=float, default=0.0)
    ap.add_argument("--scene", default="random",
                    choices=["random", "realistic"])
    ap.add_argument("--exact-grads", action="store_true",
                    help="float32 stream and gradients instead of the "
                         "packed4 / bf16 default")
    ap.add_argument("--tier-spec", default=None,
                    help="override, e.g. '4:0,8:2,16:6,32:25,64:50'")
    ap.add_argument("--gather-backward", default=None,
                    choices=["variadic", "permute", "c64", "bf16"])
    ap.add_argument("--segment-sum", default=None,
                    choices=["doubling", "pallas"])
    ap.add_argument("--stream-format", default=None,
                    choices=["f32", "packed16", "packed4"])
    ap.add_argument("--slot-gather", default=None, choices=["i32", "c64"])
    ap.add_argument("--matmul-precision", default=None,
                    choices=["default", "high", "highest"])
    ap.add_argument("--kmax", type=int, default=None,
                    help="max tiles per Gaussian")
    ap.add_argument("--viewer", action="store_true",
                    help="the viewer's frame: 800x800, forward only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"])
    return ap


def build_kwargs(args, device) -> dict:
    """run_bench's arguments for the parsed flags on `device` (a
    torch.device), set in the root bench's order: the configuration,
    --viewer, the ablation flags, then the Gaussian-sharded and the
    tile-sharded updates."""
    kwargs = preset(args.scene, args.exact_grads, device=device)
    on_card = device.type == "cuda"
    if args.viewer and not on_card:
        print(f"WARNING: --viewer is a GPU workload preset; ignored on "
              f"{device.type}", file=sys.stderr)
    if args.viewer and on_card:
        kwargs.update(VIEWER)
    if args.mode:
        kwargs["mode"] = args.mode
    if args.gather_backward:
        kwargs["gather_backward"] = args.gather_backward
        if args.gather_backward == "bf16":
            kwargs["grad_readout"] = "bf16"
            kwargs.setdefault("segment_sum", "pallas")
    for flag in ("segment_sum", "stream_format", "slot_gather",
                 "matmul_precision"):
        if getattr(args, flag):
            kwargs[flag] = getattr(args, flag)
    if args.kmax:
        kwargs["max_tiles_per_gaussian"] = args.kmax
    if args.tier_spec:
        kwargs["tier_spec"] = parse_tier_spec(args.tier_spec)
    return sharded(kwargs, args.sharded_tiles, args.data_shards,
                   args.gaussian_sharded, args.per_dest_capacity,
                   args.ssim_weight, args.stream_format)


def default_headline(args, device) -> bool:
    """Whether the realistic scene's run rides in the line: on the card,
    with no flag that alters the configuration (bench.py:238-243)."""
    return device.type == "cuda" and not (
        args.viewer or args.sharded_tiles or args.gaussian_sharded
        or args.mode or args.scene != "random" or args.exact_grads
        or args.slot_gather or args.gather_backward or args.segment_sum
        or args.stream_format or args.tier_spec or args.kmax
        or args.matmul_precision or args.ssim_weight)


def main(argv=None) -> int:
    from gsplat_tpu_torch.parallel.multihost import is_primary, rank_device
    from gsplat_tpu_torch.utils.bench import run_bench

    args = build_parser().parse_args(argv)
    device = rank_device(args.device)
    kwargs = build_kwargs(args, device)
    result = run_bench(**kwargs, dist_backend=args.dist_backend)
    line = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
    if result["details"].get("overflow"):
        line["overflow"] = True
        line["overflow_cause"] = result["details"].get("overflow_cause")
    if default_headline(args, device):
        r2 = run_bench(**{**kwargs, "scene_kind": "realistic", **JUMBO})
        line["realistic_it_per_s"] = r2["value"]
        line["realistic_vs_baseline"] = r2["vs_baseline"]
        if r2["details"].get("overflow"):
            line["realistic_overflow"] = True
            line["realistic_overflow_cause"] = r2["details"].get(
                "overflow_cause")
        result["details"]["realistic"] = r2["details"]
    if is_primary():
        print(json.dumps(line))
        print(json.dumps(result["details"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
