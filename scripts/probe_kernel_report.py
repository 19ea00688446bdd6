#!/usr/bin/env python3
"""Registers, shared memory and SASS instruction counts of the port's CUDA
kernels: the probes (`gsplat_tpu_torch/csrc/probe_*.cu`), the blend
kernels K1 and K2 (`raster_fwd.cu`, `raster_bwd.cu`), the cull K3
(`cull.cu`) and the suffix sums K4 and K5 (`segsum.cu`, `segsum_packed.cu`,
one scan in `segscan.cuh`).

    python3 scripts/probe_kernel_report.py [SOURCE ...] [--csrc DIR ...]
        [--sass-out DIR]

SOURCE names csrc/<SOURCE>.cu (default: every probe). For each source:
`nvcc` with the port's build flags plus `-Xptxas -v` (each kernel's
registers, shared memory and spills), then `cuobjdump -sass` of the library
and, per kernel, the count of each SASS opcode, its FP32 operations (FADD,
FMUL, FMNMX, FRND, and FFMA counted as 2) and its MUFU and HMMA
instructions. P1's loop (`transc_kernel<mode>`) is unrolled over four
float4s, 16 elements, and has a one-element tail, so its operations per
element are the kernel's count over 17. For a blend kernel it also counts
the pair loop: the shortest backward branch whose body holds an exp
(`MUFU.EX2`), with LDS, SHFL, FFMA/FMUL/FADD, MUFU and BAR in that body,
total and per evaluated pair (over its EX2 count: one exp per pair a pixel
evaluates; a static count, as if every branch in the body were taken).
For K3, K4 and K5 it counts their inner loop the same way: K3's chunk of
32 lanes (the shortest loop holding an FMNMX, the lane test's minima) and
K4's and K5's round of 256 positions (the shortest loop holding a SHFL,
the warp scan), with every opcode of the body. Each --csrc DIR reports the same
sources from another checkout after the package's own (a parent's, to
compare). With --sass-out, writes each library's full SASS there, and each
inner loop's SASS beside it (<source>.<kernel index>.loop.sass, under a
subdirectory per --csrc). Needs the CUDA toolkit (nvcc, cuobjdump), not a
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
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from gsplat_tpu_torch.ops.cuda import _build  # noqa: E402

FP32 = {"FADD": 1, "FMUL": 1, "FFMA": 2, "FMNMX": 1, "FRND": 1}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
BRANCH = re.compile(
    r"\bBRA(?:\.[A-Z0-9_]+)*\s+(?:!?U?P[T0-9]+,\s*)?(?:`\()?0x([0-9a-f]+)")
LOOP_OPS = ("LDS", "SHFL", "FFMA", "FMUL", "FADD", "MUFU", "BAR")
# The instruction that marks each source's inner loop.
LOOP_MARK = {"raster": "MUFU.EX2", "cull": "FMNMX", "segsum": "SHFL"}


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(
        os.path.dirname(_build.DEFAULT_NVCC), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (the CUDA toolkit)")
    return path


def sass_kernels(sass: str) -> dict:
    """{kernel symbol: [(address, opcode, line)]} from `cuobjdump -sass`."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = INSN.search(line)
        if cur is not None and m:
            # FADD32I is an FADD.
            cur.append((int(m.group(1), 16), m.group(2).removesuffix("32I"),
                        line))
    return out


def sass_counts(sass: str) -> dict:
    """{kernel symbol: Counter of opcodes} from `cuobjdump -sass` output."""
    return {k: collections.Counter(op for _, op, _ in insns)
            for k, insns in sass_kernels(sass).items()}


def inner_loop(insns: list, mark: str) -> tuple[list, int] | None:
    """(body as [(opcode, line)], count of `mark`) of the shortest loop
    (backward branch to its target) whose body holds an instruction line
    containing `mark`, or None."""
    best = None
    for addr, op, line in insns:
        m = BRANCH.search(line) if op == "BRA" else None
        if not m or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        body = [(o, ln) for a, o, ln in insns if lo <= a <= addr]
        marks = sum(mark in ln for _, ln in body)
        if marks and (best is None or len(body) < len(best[0])):
            best = (body, marks)
    return best


def report(src: Path, tmp: str, nvcc: str, cuobjdump: str,
           sass_out: str | None) -> None:
    """Print the ptxas report and SASS counts of one source; write its SASS
    and inner loops under sass_out if given."""
    lib = os.path.join(tmp, f"lib{src.stem}.so")
    build = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, str(src)],
        capture_output=True, text=True, check=True)
    print(f"== {src}: ptxas")
    for line in (build.stdout + build.stderr).splitlines():
        print("  " + line.strip())
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    if sass_out:
        os.makedirs(sass_out, exist_ok=True)
        with open(os.path.join(sass_out, f"{src.stem}.sass"), "w") as f:
            f.write(sass)
    mark = next((v for k, v in LOOP_MARK.items() if src.stem.startswith(k)),
                None)
    for i, (name, insns) in enumerate(sass_kernels(sass).items()):
        ops = collections.Counter(op for _, op, _ in insns)
        fp32 = sum(n * ops[op] for op, n in FP32.items())
        per = (f", per element {fp32 / 17:.1f} FP32 ops, "
               f"{ops['MUFU'] / 17:.2f} MUFU"
               if "transc_kernel" in name else "")
        print(f"  {name}: {sum(ops.values())} instructions, FP32 operations "
              f"{fp32}, MUFU {ops['MUFU']}, HMMA {ops['HMMA']}, BAR "
              f"{ops['BAR']}{per}")
        print(f"    {dict(ops.most_common())}")
        loop = inner_loop(insns, mark) if mark else None
        if loop is None:
            continue
        lines, marks = loop
        body = collections.Counter(o for o, _ in lines)
        n = len(lines)
        if mark == "MUFU.EX2":
            counts = ", ".join(f"{op} {body[op]} ({body[op] / marks:.2f})"
                               for op in LOOP_OPS)
            print(f"    pair loop: {n} instructions, {marks} EX2, "
                  f"{n / marks:.1f} per pair; {counts}")
        else:
            print(f"    inner loop ({mark}): {n} instructions; "
                  f"{dict(body.most_common())}")
        if sass_out:
            with open(os.path.join(sass_out, f"{src.stem}.{i}.loop.sass"),
                      "w") as f:
                f.write(f"// {name}\n")
                f.writelines(ln + "\n" for _, ln in lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="csrc/<SOURCE>.cu to report (default: the probes)")
    ap.add_argument("--csrc", action="append", default=[],
                    help="another directory of the same sources")
    ap.add_argument("--sass-out", help="directory for the full SASS")
    args = ap.parse_args()
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    dirs = [_build.CSRC, *map(Path, args.csrc)]
    with tempfile.TemporaryDirectory() as tmp:
        for d, csrc in enumerate(dirs):
            sources = ([csrc / f"{name}.cu" for name in args.sources]
                       if args.sources else sorted(csrc.glob("probe_*.cu")))
            sass_out = args.sass_out and (
                os.path.join(args.sass_out, f"csrc{d}") if d else
                args.sass_out)
            for src in sources:
                report(src, tmp, nvcc, cuobjdump, sass_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
