"""Build and load the hand-written CUDA kernels of `gsplat_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by its own
`nvcc` into `build/gsplat_tpu_torch/<hash>/lib<name>.so` (for `sm_90a`), all
sources at once in parallel, then loaded with `ctypes`. The directory is keyed
by a hash of the sources and flags, so an edited source rebuilds. Nothing is
built at import: the first launch builds, so a machine without `nvcc` can
import every module and run the plain versions.

Every C entry point is bound here once, by `kernel` (a launch: the current
stream appended, the returned `cudaGetLastError()` checked, the launch
counted in `counters.py`) or `query` (a number read from the build, no
stream); `expect` is the wrappers' one check of a tensor they hand to a
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from gsplat_tpu_torch.ops.cuda import counters

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

# The C argument types of the entry points.
PTR, INT, INT64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float)

_libs: dict[str, ctypes.CDLL] = {}
# Every bound C entry point: symbol -> (the library that exports it, its
# argument types).
bound: dict[str, tuple[str, list]] = {}


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


def _bind(lib: str, symbol: str, argtypes: list):
    """A getter of the C function `symbol` of csrc/<lib>.cu, its argument
    types and int result set once per loaded library (the first call builds
    and loads it; a library put in its place later is bound anew)."""
    if symbol in bound:
        raise ValueError(f"{symbol} is bound already")
    bound[symbol] = (lib, argtypes)
    fn = cdll = None

    def get():
        nonlocal fn, cdll
        if load(lib) is not cdll:
            cdll = load(lib)
            fn = getattr(cdll, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return fn

    return get


def kernel(lib: str, symbol: str, argtypes: list, name: str | None):
    """`launch(device, *args, count=name)`: calls the entry point `symbol`
    of csrc/<lib>.cu (arguments `argtypes`, then the stream) with args and
    `device`'s current stream, inside `device`, raises if it returns an
    error and then adds one launch to `count` in the table (None counts
    nothing)."""
    get = _bind(lib, symbol, [*argtypes, PTR])

    def launch(device, *args, count: str | None = name) -> None:
        with torch.cuda.device(device):
            err = get()(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {symbol} failed to launch: "
                               f"cudaError {err}")
        if count is not None:
            counters.bump(count)

    return launch


def query(lib: str, symbol: str):
    """The int that the entry point `symbol` of csrc/<lib>.cu returns,
    taking no argument and no stream, as a function."""
    get = _bind(lib, symbol, [])
    return lambda: get()()


def expect(t: torch.Tensor, what: str, *, dtype: torch.dtype,
           shape: tuple | None = None, device=None) -> None:
    """Raise a ValueError naming `what` unless t is a contiguous tensor of
    `dtype` and `shape` (None entries match any size) on `device`, or on
    any CUDA device where `device` is None."""
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            want not in (None, got) for got, want in zip(t.shape, shape))):
        raise ValueError(f"{what} must have shape {shape} (None: any "
                         f"size), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous, got strides "
                         f"{t.stride()}")
    if device is None and t.device.type != "cuda":
        raise ValueError(f"{what} must be on a CUDA device (the kernel's), "
                         f"got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what} must be on {device}, got {t.device}")
