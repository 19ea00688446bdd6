#!/usr/bin/env python3
"""Run chip_smoke.py's `cli_train` recipe (1920x1080, the bench-default
config at K_max 128, a 1M random target, a fresh 1M init padded to 1.25M,
8 training and 2 held-out orbit views) under several opacity-reset
schedules on one CUDA card, with an eval every 20 steps, and print each
schedule's log rows (step, loss, held-out PSNR, view-0 PSNR, it/s).

    python3 scripts/cli_train_schedules.py [--out DIR] [STEPS:RESET_EVERY ...]

Default schedules: 180:90, 200:100, 240:120, 300:150 (one reset each). The
fit is deterministic, so a schedule's rows up to its reset are the same in
every schedule. Writes each run under DIR (default build/cli_train_schedules)
and one line per schedule, `RESULT name seconds rows`, on standard output.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("cli_train_schedules")
    ap.add_argument("schedules", nargs="*",
                    default=["180:90", "200:100", "240:120", "300:150"])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "cli_train_schedules"))
    args = ap.parse_args(argv)

    import torch

    from gsplat_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        print("cli_train_schedules: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    for schedule in args.schedules:
        steps, every = schedule.split(":")
        out = os.path.join(args.out, f"s{steps}_r{every}")
        os.makedirs(out, exist_ok=True)
        run = chip_smoke.cli_train_argv(out) + [
            "--steps", steps, "--opacity-reset-every", every,
            "--eval-every", "20", "--checkpoint-every", "0"]
        t0 = time.perf_counter()
        chip_smoke.cli_run(run)
        with open(os.path.join(out, "metrics.csv")) as f:
            rows = [(r["step"], r["loss"], r["holdout_psnr"], r["train_psnr"],
                     r["it_per_s"]) for r in csv.DictReader(f)]
        print(f"RESULT s{steps}_r{every} {time.perf_counter() - t0:.1f}s "
              f"{rows}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
