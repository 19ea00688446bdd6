#!/usr/bin/env python3
"""Registers, shared memory and SASS instruction counts of the probe kernels
(`gsplat_tpu_torch/csrc/probe_*.cu`).

    python3 scripts/probe_kernel_report.py [--sass-out DIR]

For each probe source: `nvcc` with the port's build flags plus `-Xptxas -v`
(each kernel's registers, shared memory and spills), then `cuobjdump -sass`
of the library and, per kernel, the count of each SASS opcode, its FP32
operations (FADD, FMUL, FMNMX, FRND, and FFMA counted as 2) and its MUFU
and HMMA instructions. P1's loop (`transc_kernel<mode>`) is unrolled over
four float4s, 16 elements, and has a one-element tail, so its operations
per element are the kernel's count over 17. With --sass-out, writes each
library's full SASS there. Needs the CUDA toolkit (nvcc, cuobjdump), not a
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from gsplat_tpu_torch.ops.cuda import _build  # noqa: E402

FP32 = {"FADD": 1, "FMUL": 1, "FFMA": 2, "FMNMX": 1, "FRND": 1}
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(
        os.path.dirname(_build.DEFAULT_NVCC), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (the CUDA toolkit)")
    return path


def sass_counts(sass: str) -> dict:
    """{kernel symbol: Counter of opcodes} from `cuobjdump -sass` output."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(),
                                 collections.Counter())
            continue
        m = INSN.search(line)
        if cur is not None and m:
            cur[m.group(1).removesuffix("32I")] += 1  # FADD32I is an FADD
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-out", help="directory for the full SASS")
    args = ap.parse_args()
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    sources = [s for s in _build._sources() if s.stem.startswith("probe_")]
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            lib = os.path.join(tmp, f"lib{src.stem}.so")
            build = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                 str(src)], capture_output=True, text=True, check=True)
            print(f"== {src.name}: ptxas")
            for line in (build.stdout + build.stderr).splitlines():
                print("  " + line.strip())
            sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                                  text=True, check=True).stdout
            if args.sass_out:
                os.makedirs(args.sass_out, exist_ok=True)
                with open(os.path.join(args.sass_out, f"{src.stem}.sass"),
                          "w") as f:
                    f.write(sass)
            for name, ops in sass_counts(sass).items():
                fp32 = sum(n * ops[op] for op, n in FP32.items())
                per = (f", per element {fp32 / 17:.1f} FP32 ops, "
                       f"{ops['MUFU'] / 17:.2f} MUFU"
                       if "transc_kernel" in name else "")
                print(f"  {name}: {sum(ops.values())} instructions, FP32 "
                      f"operations {fp32}, MUFU {ops['MUFU']}, HMMA "
                      f"{ops['HMMA']}{per}")
                print(f"    {dict(ops.most_common())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
