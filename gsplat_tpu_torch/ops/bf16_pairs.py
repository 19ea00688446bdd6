"""bf16 pairs: two bf16-rounded float32 rows in one int32 lane (port of
`gsplat_tpu.ops.binning._pack_bf16_pairs` / `_unpack_bf16_pairs`).

Layout contract, shared with the JAX package and with the CUDA kernels that
read or write pairs (K2's packed output in `csrc/raster_bwd.cu`, K5 in
`csrc/segsum_packed.cu`, the packed streams of `ops/stream16.py`): pair i
holds row 2i in the LOW 16 bits and row 2i+1 in the HIGH 16 bits, each
rounded to nearest even; an odd row count is padded with a zero row.

A packed tensor is typed `torch.int32`, never float32: a pair whose high
half is zero (the opacity row, paired with the zero pad row) is the bit
pattern of an f32 denormal, which any float path that flushes denormals
would zero. Only the unpacked halves are ever floats.
"""

from __future__ import annotations

import torch


def pack_bf16_pairs(x: torch.Tensor) -> torch.Tensor:
    """(F, M) float32 -> (ceil(F / 2), M) int32 pairs."""
    f, m = x.shape
    if f % 2:
        x = torch.cat([x, x.new_zeros((1, m))])
    # (P, M, 2) bf16, low half first; viewing the last two bytes pairs as one
    # little-endian int32 puts row 2i in the low 16 bits.
    b = x.to(torch.bfloat16).reshape(-1, 2, m).transpose(1, 2).contiguous()
    return b.view(torch.int32)[..., 0]


def unpack_bf16_pairs(p: torch.Tensor, f: int) -> torch.Tensor:
    """(P, M) int32 pairs -> the first f of their 2P float32 rows."""
    if p.dtype != torch.int32:
        raise ValueError(f"bf16 pairs must be typed int32, got {p.dtype}")
    n_pairs, m = p.shape
    b = p.contiguous().view(torch.bfloat16).reshape(n_pairs, m, 2)
    return b.permute(0, 2, 1).reshape(2 * n_pairs, m)[:f].float()
