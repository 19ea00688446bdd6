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

import torch

from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import INT, INT64, PTR

# K4 (float32 rows) and K5 (bf16 pairs): x, rows, M, F, the reach, out.
_ARGS = [PTR, PTR, INT64, INT, INT, PTR]
_K4 = _build.kernel("segsum", "gsplat_segsum", _ARGS, "K4")
_K5 = _build.kernel("segsum_packed", "gsplat_segsum_packed", _ARGS, "K5")


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


def _launch(launch, what: str, x, rows, kmax: int, dtype):
    _build.expect(x, f"{what}: x", dtype=dtype, shape=(None, None))
    _build.expect(rows, f"{what}: rows (M,)", dtype=torch.int32,
                  shape=(x.shape[1],), device=x.device)
    f, m = x.shape
    out = torch.empty_like(x)
    launch(x.device, x.data_ptr(), rows.data_ptr(), m, f,
           doubling_depth(kmax), out.data_ptr())
    return out


def segmented_suffix_sum_cuda(x, rows, kmax: int):
    """Launch K4: (F, M) float32, (M,) int32 -> (F, M) float32."""
    return _launch(_K4, "segsum", x, rows, kmax, torch.float32)


def segmented_suffix_sum_packed_cuda(x, rows, kmax: int):
    """Launch K5: (P, M) int32 bf16 pairs, (M,) int32 -> (P, M) int32."""
    return _launch(_K5, "segsum_packed", x, rows, kmax, torch.int32)


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
