"""K4, the segmented suffix sum: CUDA kernel `csrc/segsum.cu` and its plain
PyTorch version.

Replaces `gsplat_tpu/ops/pallas/segsum.py::_kernel` (`segmented_suffix_sum`
with `packed=False`). The plain version is the doubling loop of
`gsplat_tpu.ops.binning._gather_slots_bwd` (`segment_sum='doubling'`).

Contract: x is (F, M) float32 in gid-major run order and rows (M,) int32
run ids sorted ascending, each run at most kmax long; out[:, j] = sum over
k >= j with rows[k] == rows[j] of x[:, k], an (F, M) result. It is the JAX
`segmented_suffix_sum` cut to its first M lanes: the TPU kernel pads M to
its block size, which the CUDA kernel has no use for. A run longer than
kmax is summed only as deep as the doubling reaches (kmax rounded up to a
power of two); the pipeline's one long run, the invalid-slot tail, carries
zeros.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.ops.cuda import _build

# Kernel launches: segmented_suffix_sum_cuda adds one per launch, nowhere else.
launches = 0


def doubling_depth(kmax: int) -> int:
    """Slots a position reaches: the doubling's shifts 1, 2, 4, ... below
    kmax sum kmax rounded up to a power of two."""
    return 1 << max(kmax - 1, 0).bit_length()


def segmented_suffix_sum_plain(x, rows, kmax: int):
    """The doubling: ceil(log2 kmax) shift-and-add passes over the stream.
    `torch.where` and not a product with the run mask, so that a non-finite
    value never leaks across a run boundary (NaN * 0 = NaN)."""
    m = x.shape[1]
    s = 1
    while s < kmax and s < m:
        same = (rows[s:] == rows[:-s])[None, :]
        x_sh = torch.where(same, x[:, s:], 0.0)
        x = x + torch.cat([x_sh, x.new_zeros((x.shape[0], s))], 1)
        s <<= 1
    return x


def segmented_suffix_sum_cuda(x, rows, kmax: int):
    """Launch the kernel: (F, M) float32, (M,) int32 -> (F, M)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"segsum: the kernel needs a CUDA device, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segsum: x must be a contiguous (F, M) float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if rows.dtype != torch.int32 or rows.shape != (x.shape[1],) or \
            not rows.is_contiguous() or rows.device != x.device:
        raise ValueError("segsum: rows must be a contiguous (M,) int32 "
                         "tensor on x's device")
    f, m = x.shape
    out = torch.empty((f, m), dtype=torch.float32, device=x.device)
    fn = _build.load("segsum").gsplat_segsum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), rows.data_ptr(), m, f, doubling_depth(kmax),
                 out.data_ptr(), stream)
    _build.check(err, "gsplat_segsum")
    launches += 1
    return out


def segmented_suffix_sum(x, rows, kmax: int):
    """(F, M) gradient rows, (M,) sorted run ids -> (F, M) suffix sums: the
    CUDA kernel for CUDA tensors, the plain doubling for CPU tensors."""
    if x.device.type == "cpu":
        return segmented_suffix_sum_plain(x, rows, kmax)
    if x.device.type == "cuda":
        return segmented_suffix_sum_cuda(x, rows, kmax)
    raise ValueError(f"segsum: unsupported device {x.device}")
