#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card.

    python3 splatbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults half,reorder] \
        [--program-fault stale_replays] [--seconds S] [--out F]

For each seed, in one process: the cell's set-up and a short window at its
own load (--seconds; long enough for the traffic's sampled requests), then
the numbers `correct` compares (the program against the reference); for
each control seed also the control's numbers (the reference in bfloat16
in the program's place) and each named fault's (planted in the
reference, or "reorder": the reference in another sound float32 order).
With --program-fault every seed runs the program with that fault planted
(`splatbench/faults.py`), and its line's "program" holds what the fault
reads. One JSON line per seed on standard output and in --out. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from splatbench import faults as program_faults
    from splatbench import frozen, run, tracing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--program-fault", choices=program_faults.PROGRAM_FAULTS)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    spec = run.load_json(ROOT / "BENCHMARK.json")
    cell = run.find_cell(spec, args.workload)
    config, traffic = run.load_cell(cell)
    kind = importlib.import_module(f"splatbench.kinds.{traffic['kind']}")
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    card = frozen.device_name(0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                    device=device)
        with program_faults.planted(args.program_fault):
            kind.setup(ctx)
            kind.window(ctx, args.seconds)
            kind.wind_down(ctx, False)
        line = {"workload": args.workload, "seed": seed, "card": card,
                "program_fault": args.program_fault,
                "attempted": ctx.attempted, "failed": ctx.failed}
        t1 = time.perf_counter()
        line["program"] = kind.numbers(ctx)
        line["reference_s"] = time.perf_counter() - t1
        line["detail"] = ctx.detail
        if seed in controls:
            line["control"] = kind.control(ctx)
            for fault in faults:
                line[f"fault_{fault}"] = kind.control(ctx, fault)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del ctx
        tracing.sync(device)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
