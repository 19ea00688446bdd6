"""Build and load the hand-written CUDA kernels of `gsplat_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by its own
`nvcc` into `build/gsplat_tpu_torch/<hash>/lib<name>.so` (for `sm_90a`), all
sources at once in parallel, then loaded with `ctypes`. The directory is keyed
by a hash of the sources and flags, so an edited source rebuilds. Nothing is
built at import: the first launch builds, so a machine without `nvcc` can
import every module and run the plain versions.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises if that is not `cudaSuccess`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "gsplat_tpu_torch"
# No --use_fast_math and no -ftz=true: a bf16 pair whose high half is zero is
# an f32 denormal bit pattern (K2's and K5's opacity lanes), and the kernels'
# unpacked bf16 halves may be denormal; flushing would zero them.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# Where the CUDA toolkit puts nvcc when it is not on PATH.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(DEFAULT_NVCC):
        nvcc = DEFAULT_NVCC
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of gsplat_tpu_torch need the "
            "CUDA toolkit on PATH (or /usr/local/cuda) to build"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every csrc/*.cu not yet built, all nvcc processes at once.
    Returns the build directory."""
    out_dir = _build_dir()
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")
