"""The headline bench of the port, the counterpart of the repo's root
`bench.py`:

    python -m gsplat_tpu_torch.bench [--scene random|realistic]
                                     [--exact-grads] [--mode fwd|fwd_bwd]
                                     [--device cuda|cpu]

prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} (with
"overflow" and its cause when a frame overflowed) and the details on
stderr. On the card: fwd+bwd it/s at 1920x1080 with 1M Gaussians, the
root bench's configuration (tile 32, the tiered ladder, packed4 stream and
bf16-pair gradients, or float32 throughout with --exact-grads); the
realistic scene adds the jumbo tiers. With no flag, the realistic scene's
run rides in the same line (`realistic_it_per_s`), as in the root bench.
`--device cpu` runs a small configuration (20k Gaussians, 256x256) through
the kernels' plain versions: a smoke run, not a measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

# The root bench's configuration on the accelerator (bench.py:85-120).
CARD = dict(
    num_gaussians=1_000_000, width=1920, height=1080, impl="pallas",
    mode="fwd_bwd", iters=10, tile_size=32, max_intersections=4_100_000,
    block_size=32, max_per_tile=8192, binning="tiered",
    tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)),
    pallas_block_size=128, segment_sum="pallas",
)
# Its default: the packed4 stream, bf16-pair slot gradients; and
# --exact-grads: float32 end to end.
DEFAULT = dict(gather_backward="bf16", grad_readout="bf16",
               stream_format="packed4", matmul_precision="high")
EXACT = dict(gather_backward="c64", grad_readout="f32", stream_format="f32",
             matmul_precision="highest")
# The jumbo ladder of the realistic scene (bench.py:246-253): its fat-splat
# tail projects rects up to about 2040 tiles, enumerated in full.
JUMBO = dict(max_tiles_jumbo=2048, jumbo_tier_spec=(
    (128, 14848), (256, 7168), (512, 3072), (1024, 1024), (2048, 384)))
# The root bench's small configuration off the accelerator.
SMALL = dict(num_gaussians=20_000, width=256, height=256, impl="jnp",
             mode="fwd_bwd", iters=3, tile_size=16, max_intersections=1 << 16,
             block_size=16, max_per_tile=512)


def preset(scene: str = "random", exact_grads: bool = False,
           mode: str | None = None, device="cuda") -> dict:
    """run_bench's arguments for one run of this bench."""
    if str(device).startswith("cuda"):
        kw = dict(CARD, **(EXACT if exact_grads else DEFAULT))
        if scene == "realistic":
            kw.update(JUMBO)
    else:
        kw = dict(SMALL)
    kw.update(scene_kind=scene, device=device)
    if mode:
        kw["mode"] = mode
    return kw


def main(argv=None) -> int:
    from gsplat_tpu_torch.utils.bench import run_bench

    ap = argparse.ArgumentParser("gsplat_tpu_torch.bench")
    ap.add_argument("--scene", default="random",
                    choices=["random", "realistic"])
    ap.add_argument("--exact-grads", action="store_true",
                    help="float32 stream and gradients instead of the "
                         "packed4 / bf16 default")
    ap.add_argument("--mode", default=None, choices=["fwd", "fwd_bwd"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kwargs = preset(args.scene, args.exact_grads, args.mode, args.device)
    result = run_bench(**kwargs)
    line = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
    if result["details"].get("overflow"):
        line["overflow"] = True
        line["overflow_cause"] = result["details"].get("overflow_cause")
    # With no flag on the card, the realistic scene's run rides in the same
    # line (the root bench's default headline).
    on_card = str(args.device).startswith("cuda")
    if on_card and not (args.mode or args.exact_grads
                        or args.scene != "random"):
        r2 = run_bench(**preset("realistic", device=args.device))
        line["realistic_it_per_s"] = r2["value"]
        line["realistic_vs_baseline"] = r2["vs_baseline"]
        if r2["details"].get("overflow"):
            line["realistic_overflow"] = True
            line["realistic_overflow_cause"] = r2["details"].get(
                "overflow_cause")
        result["details"]["realistic"] = r2["details"]
    print(json.dumps(line))
    print(json.dumps(result["details"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
