"""Front-to-back alpha blending of one depth-ordered block of G Gaussians into
P pixels: the block math of `gsplat_tpu.ops.blend` (forward and the
hand-derived backward), in plain torch.

Rules: power = -0.5*(A*dx^2 + C*dy^2) - B*dx*dy from the conic, alpha =
min(0.99, opacity * exp(min(power, 0))), skip when power > 0 or alpha <
1/255, terminate a pixel for good when its transmittance would drop below
1e-4 (that Gaussian excluded), color += c * alpha * T, T *= (1 - alpha).

Within a block the serial recurrence T_{i+1} = T_i (1 - a_i) is evaluated as
T_in * exp(exclusive cumsum(log1p(-a))), with `torch.cumsum` in place of the
TPU's triangular matmul and every contraction in full float32 (the TPU
kernels' bf16-pass matmul emulation has no counterpart here). The color sum
over the block is an elementwise product and a sum, not a matmul, so TF32
never enters the plain path. The backward's contractions (the JAX package's
`mm_einsum`s and its moments matmul) are sums over the pixel or colour axis
for the same reason.

The backward needs no stored per-Gaussian state: sum_j w_j (c_j . g) is the
final colour's gradient product, so the suffix sums behind d L / d a_i are
recovered in one forward re-walk as b_total - cumsum(b) (see
`blend_block_bwd`).

Shapes: any leading batch dims (...), e.g. one entry per tile:
  feat: (..., NUM_FEATURES, G) Gaussian block, depth-ordered along the last
  px, py: (..., P, 1) pixel centres; in_range: (..., 1, G) bool
  carry: color (..., 3, P), trans (..., P, 1), done (..., P, 1) 0/1 float
  backward: g_color (..., 3, P), b_total and accum_b (..., P, 1)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.binning import (
    FEAT_CA,
    FEAT_CB,
    FEAT_CC,
    FEAT_GX,
    FEAT_GY,
    FEAT_OPACITY,
    FEAT_R,
)


class BlendCarry(NamedTuple):
    color: torch.Tensor  # (..., 3, P)
    trans: torch.Tensor  # (..., P, 1) current transmittance T
    done: torch.Tensor   # (..., P, 1) float32 0/1 permanent-termination flag


def init_carry(num_pixels: int, batch: tuple = (), device="cpu") -> BlendCarry:
    kw = dict(dtype=torch.float32, device=device)
    return BlendCarry(
        color=torch.zeros(batch + (3, num_pixels), **kw),
        trans=torch.ones(batch + (num_pixels, 1), **kw),
        done=torch.zeros(batch + (num_pixels, 1), **kw),
    )


def _block_weights(carry: BlendCarry, feat, px, py, in_range,
                   cfg: RenderConfig):
    """Per-(pixel, Gaussian) contribution weight w = a * T_before, the
    updated (trans, done) carries, the lanes each pixel had to evaluate
    (in range, pixel not yet done, up to and including the Gaussian that
    terminates it), and the terms the backward re-uses (`aux`)."""
    def row(i):  # (..., 1, G)
        return feat[..., i : i + 1, :]

    ca, cb, cc, op = row(FEAT_CA), row(FEAT_CB), row(FEAT_CC), row(FEAT_OPACITY)
    # Tile-relative coordinates, as the JAX package evaluates them.
    ox = px[..., 0:1, 0:1]
    oy = py[..., 0:1, 0:1]
    gxr = row(FEAT_GX) - ox
    gyr = row(FEAT_GY) - oy
    dx = (px - ox) - gxr
    dy = (py - oy) - gyr
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    # exp of the non-positive part only: cancellation can leave power
    # spuriously positive on tiny splats, and exp would overflow to inf.
    e = torch.exp(torch.clamp_max(power, 0.0))
    alpha_u = op * e
    alpha = torch.clamp_max(alpha_u, cfg.alpha_clamp)
    ok = (
        (power <= 0.0)
        & (alpha >= cfg.alpha_min)
        & in_range
        & (carry.done < 0.5)
    )
    a = torch.where(ok, alpha, 0.0)

    l1 = torch.log1p(-a)
    t_before = carry.trans * torch.exp(torch.cumsum(l1, dim=-1) - l1)
    p_incl = t_before * (1.0 - a)  # transmittance AFTER this Gaussian
    valid = p_incl >= cfg.transmittance_min
    w = torch.where(valid, a * t_before, 0.0)

    trigger = (a > 0.0) & ~valid
    new_trans = torch.minimum(
        carry.trans,
        torch.where(valid, p_incl, float("inf")).amin(dim=-1, keepdim=True),
    )
    new_done = torch.maximum(
        carry.done, trigger.any(dim=-1, keepdim=True).to(carry.done.dtype)
    )
    t = trigger.to(torch.int32)
    walked = in_range & (carry.done < 0.5) & (torch.cumsum(t, dim=-1) - t == 0)
    aux = dict(dx=dx, dy=dy, e=e, alpha_u=alpha_u, a=a, valid=valid,
               t_before=t_before)
    return w, new_trans, new_done, walked, aux


def blend_block(carry: BlendCarry, feat, px, py, in_range, cfg: RenderConfig):
    """Blend one depth-ordered block of G Gaussians into P pixels. Returns
    (new carry, walked (..., P) int64): the (pixel, Gaussian) pairs each
    pixel had to evaluate in the block."""
    w, new_trans, new_done, walked, _ = _block_weights(
        carry, feat, px, py, in_range, cfg
    )
    colors = feat[..., FEAT_R : FEAT_R + 3, :]  # (..., 3, G)
    # sum_g colors[c, g] * w[p, g] -> (..., 3, P), elementwise in f32.
    new_color = carry.color + (colors[..., :, None, :] * w[..., None, :, :]).sum(-1)
    return BlendCarry(new_color, new_trans, new_done), walked.sum(-1)


def blend_block_bwd(carry: BlendCarry, feat, px, py, in_range, g_color,
                    b_total, accum_b, cfg: RenderConfig):
    """One backward block, in the forward walk's order. Returns
    (dfeat (..., NUM_FEATURES, G), new carry, new accum_b, applied): applied
    is the () count of (pixel, Gaussian) pairs with a nonzero weight, whose
    gradient terms the block computes.

    b_total = sum_c g_color * final_color + g_trans * final_trans per pixel:
    the final-transmittance path has the same -1/(1 - a_i) suffix structure
    as the colour path and folds into the same suffix sum. accum_b is the
    running prefix of b = dL/dw * w over the blocks already walked."""
    w, new_trans, new_done, _, aux = _block_weights(
        carry, feat, px, py, in_range, cfg
    )

    def row(i):  # (..., 1, G)
        return feat[..., i : i + 1, :]

    # dL/dw[p, g] = sum_c colors[c, g] * g_color[c, p]
    dw = sum(row(FEAT_R + c) * g_color[..., c, :, None] for c in range(3))
    b = dw * w
    cum_b = accum_b + torch.cumsum(b, dim=-1)  # inclusive, past blocks too
    suffix = b_total - cum_b                   # over strictly-later Gaussians
    a = aux["a"]
    da = torch.where(a > 0.0, dw * aux["t_before"] - suffix / (1.0 - a), 0.0)
    # Lanes past a pixel's termination have w = 0 and no gradient.
    da = torch.where(aux["valid"], da, 0.0)
    # Selects, not products with the clamp mask: a skipped pair of a NaN
    # opacity has da = 0 and alpha_u = NaN, and 0 * NaN would be NaN where
    # the JAX package gives 0 (its VJPs, run on the CPU, return 0 there).
    not_clamped = aux["alpha_u"] < cfg.alpha_clamp
    dpower = torch.where(not_clamped, da * aux["alpha_u"], 0.0)  # (..., P, G)

    dx, dy = aux["dx"], aux["dy"]
    sdx = (dpower * dx).sum(-2)  # (..., G)
    sdy = (dpower * dy).sum(-2)
    ca, cb, cc = (feat[..., i, :] for i in (FEAT_CA, FEAT_CB, FEAT_CC))
    # d power / d gx = ca dx + cb dy (d dx / d gx = -1 on both factors).
    d_gx = ca * sdx + cb * sdy
    d_gy = cc * sdy + cb * sdx
    d_ca = -0.5 * (dpower * dx * dx).sum(-2)
    d_cc = -0.5 * (dpower * dy * dy).sum(-2)
    d_cb = -(dpower * dx * dy).sum(-2)
    # d alpha_u / d opacity = e: the JAX package's m[0] / opacity without
    # the divide, so a zero-feature lane (zero opacity) gives 0, not 0/0.
    d_op = torch.where(not_clamped, da * aux["e"], 0.0).sum(-2)
    # dL/dcolor[c, g] = sum_p g_color[c, p] * w[p, g]
    d_colors = [(g_color[..., c, :, None] * w).sum(-2) for c in range(3)]
    dfeat = torch.stack([d_gx, d_gy, d_ca, d_cb, d_cc, *d_colors, d_op], -2)
    applied = (aux["valid"] & (a > 0.0)).sum()
    return (dfeat, BlendCarry(carry.color, new_trans, new_done),
            cum_b[..., -1:], applied)


def tile_pixel_coords(tile_idx: torch.Tensor, cfg: RenderConfig):
    """Pixel centres of tiles `tile_idx` (..., ) (row-major tiles, row-major
    pixels within a tile): px, py of shape (..., P, 1), float32."""
    ts = cfg.tile_size
    tile_idx = tile_idx[..., None, None]
    tx = tile_idx % cfg.tiles_x
    ty = tile_idx // cfg.tiles_x
    p = torch.arange(cfg.pixels_per_tile, device=tile_idx.device)[:, None]
    px = (tx * ts + p % ts).float()
    py = (ty * ts + p // ts).float()
    return px, py
