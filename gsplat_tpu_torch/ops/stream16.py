"""Packed forward feature streams (`cfg.stream_format` 'packed16' and
'packed4'): port of the formats of `gsplat_tpu.ops.stream16`.

The 9 float32 feature rows of a Gaussian are quantised into int32 rows:

    row 0: gx | gy << 16     u16 fixed point over 1.1x the image extent
    'packed16' rows 1-4:     bf16 pairs (ca|cb), (cc|r), (g|b), (op|0)
    'packed4'  rows 1-2:     bf16 pairs (ca|cb), (cc|op)
               row 3:        r | g << 11 | b << 22, 11/11/10-bit fixed
                             point over [0, PACKED4_COLOR_RANGE)

in the pair layout of `ops/bf16_pairs.py`. The packed stream is typed int32
end to end (a zero-high pair is an f32 denormal bit pattern). Kernel K1
reads it and unpacks each slot as `unpack_block` does (`csrc/blend.cuh`,
`load_slot`), and so does K2. Gradients are straight-through onto the
float32 features; the fused VJP is `ops/cuda/raster.py::rasterize_packed16`.

`pack_stream` gives the JAX package's int32 words bit for bit on the same
input: `torch.round` rounds half to even like `jnp.round`, and the constants
are the same Python doubles, rounded to float32 at the multiply in both.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs
from gsplat_tpu_torch.ops.binning import NUM_FEATURES

# Colour fixed-point range of the 'packed4' stream: SH colours are clamped
# >= 0 and stay below 4 in practice; 11/11/10 bits give steps of 4/2047
# (r, g) and 4/1023 (b).
PACKED4_COLOR_RANGE = 4.0
# int32 rows of each packed stream.
STREAM_ROWS = {"packed16": 5, "packed4": 4}
# int32 with only the high 16 bits set (0xFFFF0000).
_HIGH_HALF = -65536


def quant_params(cfg: RenderConfig) -> tuple[float, float, float, float]:
    """(lox, sx, loy, sy): q = round((v - lo) * s) in [0, 65535], v = q / s
    + lo, over uv in [(1 - l) / 2, (1 + l) / 2] of the image extent (the
    frustum cull admits |ndc| < l = cfg.frustum_ndc_limit).
    cfg.quant_ranges overrides the derivation."""
    if cfg.quant_ranges is not None:
        return cfg.quant_ranges
    lim = float(cfg.frustum_ndc_limit)
    lox = (1.0 - lim) / 2.0 * cfg.width
    loy = (1.0 - lim) / 2.0 * cfg.height
    sx = 65535.0 / (lim * cfg.width)
    sy = 65535.0 / (lim * cfg.height)
    return lox, sx, loy, sy


def _fixed(v: torch.Tensor, scale: float, top: float) -> torch.Tensor:
    """clip(round(v * scale), 0, top) as int32."""
    return torch.clamp(torch.round(v * scale), 0.0, top).to(torch.int32)


def pack_stream(feats: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(NUM_FEATURES, N) float32 -> (STREAM_ROWS[format], N) int32."""
    lox, sx, loy, sy = quant_params(cfg)
    row0 = (_fixed(feats[0] - lox, sx, 65535.0)
            | (_fixed(feats[1] - loy, sy, 65535.0) << 16))
    if cfg.stream_format == "packed4":
        pairs = pack_bf16_pairs(feats[[2, 3, 4, 8]])  # (ca|cb), (cc|op)
        s = PACKED4_COLOR_RANGE
        row3 = (_fixed(feats[5], 2047.0 / s, 2047.0)
                | (_fixed(feats[6], 2047.0 / s, 2047.0) << 11)
                | (_fixed(feats[7], 1023.0 / s, 1023.0) << 22))
        return torch.cat([row0[None], pairs, row3[None]], 0)
    # (ca|cb), (cc|r), (g|b), (op|0)
    return torch.cat([row0[None], pack_bf16_pairs(feats[2:NUM_FEATURES])], 0)


def _lo(w: torch.Tensor) -> torch.Tensor:
    return (w << 16).view(torch.float32)


def _hi(w: torch.Tensor) -> torch.Tensor:
    return (w & _HIGH_HALF).view(torch.float32)


def unpack_block(feat_i32: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(rows, G) int32 packed stream -> (NUM_FEATURES, G) float32: the values
    the kernels blend (product, then sum, each rounded to float32)."""
    if feat_i32.dtype != torch.int32:
        raise ValueError(f"a packed stream must be typed int32, got "
                         f"{feat_i32.dtype}")
    lox, sx, loy, sy = quant_params(cfg)
    w = feat_i32
    gx = (w[0] & 0xFFFF).float() * (1.0 / sx) + lox
    gy = ((w[0] >> 16) & 0xFFFF).float() * (1.0 / sy) + loy
    if cfg.stream_format == "packed4":
        s = PACKED4_COLOR_RANGE
        r = (w[3] & 0x7FF).float() * (s / 2047.0)
        g = ((w[3] >> 11) & 0x7FF).float() * (s / 2047.0)
        b = ((w[3] >> 22) & 0x3FF).float() * (s / 1023.0)
        rows = [gx, gy, _lo(w[1]), _hi(w[1]), _lo(w[2]), r, g, b, _hi(w[2])]
    else:
        rows = [gx, gy, _lo(w[1]), _hi(w[1]), _lo(w[2]), _hi(w[2]),
                _lo(w[3]), _hi(w[3]), _lo(w[4])]
    return torch.stack(rows, 0)


def gather_packed(feats: torch.Tensor, sorted_gid: torch.Tensor,
                  cfg: RenderConfig) -> torch.Tensor:
    """Pack the per-Gaussian features and gather them into slot order: one
    int32 `index_select`. Slots with gid -1 read an appended zero column,
    which unpacks to zero opacity. The JAX package's slot_gather='c64'
    (the rows paired into complex64 for the TPU gather) moves the same bits
    (`tests/test_stream16.py:100-130`), so here it is this one path."""
    packed = pack_stream(feats, cfg)
    packed_pad = torch.cat([packed, packed.new_zeros((packed.shape[0], 1))], 1)
    g = torch.where(sorted_gid < 0, feats.shape[1], sorted_gid).to(torch.int64)
    return packed_pad.index_select(1, g).contiguous()
