"""K4 and K5, the segmented suffix sums of the gather backward: CUDA kernels
`csrc/segsum.cu` (float32 rows) and `csrc/segsum_packed.cu` (bf16-pair
rows), and their plain PyTorch versions.

K4 replaces `gsplat_tpu/ops/pallas/segsum.py::_kernel` (`segmented_suffix_sum`
with `packed=False`); its plain version is the doubling loop of
`gsplat_tpu.ops.binning._gather_slots_bwd` (`segment_sum='doubling'`). K5
replaces `segsum.py::_kernel_packed` (`packed=True`): the same sum over
int32 lanes that each hold two bf16 values (`ops/bf16_pairs.py`), summed in
float32 and rounded back to bf16 to nearest even; its plain version unpacks,
runs the doubling and repacks. Both kernels are one linear-time reverse
segmented scan (`csrc/segscan.cuh`) over two lane codecs: F float32 rows
(F at most 16) and P bf16 pairs (P at most 8); any other row count raises.

Contract: x is (F, M) float32, or (P, M) int32 pairs, in gid-major run order
and rows (M,) int32 run ids sorted ascending, each run at most kmax long;
out[:, j] = sum over k >= j with rows[k] == rows[j] of x[:, k], of x's shape
and type. It is the JAX `segmented_suffix_sum` cut to its first M lanes: the
TPU kernel pads M to its block size, which the CUDA kernels have no use for.
Both kernels sum every run of at most `doubling_depth(kmax)` slots (kmax
rounded up to a power of two, the doubling's reach) whole, as the doubling
does. The one longer run is the pipeline's invalid-slot tail, whose values
are zero: its sums are zero whatever the reach, though on a longer run of
other values the doubling, which sums only that deep, and the scan would
differ.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
from gsplat_tpu_torch.ops.cuda import _build, counters

# K4 launches: segmented_suffix_sum_cuda adds one per launch, nowhere else.
launches = 0
# K5 launches: segmented_suffix_sum_packed_cuda adds one per launch, nowhere
# else.
packed_launches = 0
counters.register(__name__, "launches", "packed_launches")


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


def segmented_suffix_sum_packed_plain(x, rows, kmax: int):
    """K5's plain version: unpack the pairs to float32, the doubling, and
    repack rounding to nearest even. Sums in the order of the TPU kernel's
    in-block doubling."""
    f = 2 * x.shape[0]
    return pack_bf16_pairs(
        segmented_suffix_sum_plain(unpack_bf16_pairs(x, f), rows, kmax))


def _check(x, rows, dtype, what: str) -> None:
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous 2-D {dtype} "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs a CUDA device, got "
                         f"{x.device}")
    if rows.dtype != torch.int32 or rows.shape != (x.shape[1],) or \
            not rows.is_contiguous() or rows.device != x.device:
        raise ValueError(f"{what}: rows must be a contiguous (M,) int32 "
                         "tensor on x's device")


def _launch(lib: str, x, rows, kmax: int):
    f, m = x.shape
    out = torch.empty_like(x)
    fn = getattr(_build.load(lib), f"gsplat_{lib}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), rows.data_ptr(), m, f, doubling_depth(kmax),
                 out.data_ptr(), stream)
    _build.check(err, f"gsplat_{lib}")
    return out


def segmented_suffix_sum_cuda(x, rows, kmax: int):
    """Launch K4: (F, M) float32, (M,) int32 -> (F, M) float32."""
    global launches
    _check(x, rows, torch.float32, "segsum")
    out = _launch("segsum", x, rows, kmax)
    launches += 1
    return out


def segmented_suffix_sum_packed_cuda(x, rows, kmax: int):
    """Launch K5: (P, M) int32 bf16 pairs, (M,) int32 -> (P, M) int32."""
    global packed_launches
    _check(x, rows, torch.int32, "segsum_packed")
    out = _launch("segsum_packed", x, rows, kmax)
    packed_launches += 1
    return out


def segmented_suffix_sum(x, rows, kmax: int):
    """Gradient rows (F, M) float32 or bf16 pairs (P, M) int32, (M,) sorted
    run ids -> suffix sums of x's shape and type: K4 or K5 for CUDA
    tensors, the plain versions for CPU tensors."""
    packed = x.dtype == torch.int32
    if x.device.type == "cpu":
        plain = (segmented_suffix_sum_packed_plain if packed
                 else segmented_suffix_sum_plain)
        return plain(x, rows, kmax)
    if x.device.type == "cuda":
        launch = (segmented_suffix_sum_packed_cuda if packed
                  else segmented_suffix_sum_cuda)
        return launch(x, rows, kmax)
    raise ValueError(f"segsum: unsupported device {x.device}")
