#!/usr/bin/env python3
"""Where the time of one bench-default training step goes on a CUDA card.

    python3 scripts/profile_torch_train_default.py [--scene random|realistic] [--out F]

`scripts/profile_torch_train.py`'s profile (the replayed step's device and
wall ms, the kernels by name, the busy share and the record's per-stage
ms), run on the training path of bench.py with no flags: the packed4
stream and bf16-pair gradients through K5 (chip_smoke.DEFAULT). --scene realistic profiles the
1M-Gaussian realistic scene with the jumbo ladder of bench.py:246-253
(chip_smoke.JUMBO) instead of the random scene. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
import profile_torch_train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("random", "realistic"),
                    default="random")
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    # profile_torch_train builds its config from BENCH updated by EXACT:
    # point it at the bench-default setting.
    chip_smoke.EXACT = dict(chip_smoke.DEFAULT)
    sys.argv = [sys.argv[0], "--scene", args.scene] + (
        ["--out", args.out] if args.out else [])
    print(f"[config] bench default: {chip_smoke.EXACT}", flush=True)
    return profile_torch_train.main()


if __name__ == "__main__":
    sys.exit(main())
