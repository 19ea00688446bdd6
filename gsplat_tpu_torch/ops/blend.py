"""Front-to-back alpha blending of one depth-ordered block of G Gaussians into
P pixels: the block math of `gsplat_tpu.ops.blend` (forward), in plain torch.

Rules: power = -0.5*(A*dx^2 + C*dy^2) - B*dx*dy from the conic, alpha =
min(0.99, opacity * exp(min(power, 0))), skip when power > 0 or alpha <
1/255, terminate a pixel for good when its transmittance would drop below
1e-4 (that Gaussian excluded), color += c * alpha * T, T *= (1 - alpha).

Within a block the serial recurrence T_{i+1} = T_i (1 - a_i) is evaluated as
T_in * exp(exclusive cumsum(log1p(-a))), with `torch.cumsum` in place of the
TPU's triangular matmul and every contraction in full float32 (the TPU
kernels' bf16-pass matmul emulation has no counterpart here). The color sum
over the block is an elementwise product and a sum, not a matmul, so TF32
never enters the plain path.

Shapes: any leading batch dims (...), e.g. one entry per tile:
  feat: (..., NUM_FEATURES, G) Gaussian block, depth-ordered along the last
  px, py: (..., P, 1) pixel centres; in_range: (..., 1, G) bool
  carry: color (..., 3, P), trans (..., P, 1), done (..., P, 1) 0/1 float
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
    updated (trans, done) carries, and the lanes each pixel had to evaluate
    (in range, pixel not yet done, up to and including the Gaussian that
    terminates it)."""
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
    alpha_u = op * torch.exp(torch.clamp_max(power, 0.0))
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
    return w, new_trans, new_done, walked


def blend_block(carry: BlendCarry, feat, px, py, in_range, cfg: RenderConfig):
    """Blend one depth-ordered block of G Gaussians into P pixels. Returns
    (new carry, number of (pixel, Gaussian) pairs the block had to
    evaluate)."""
    w, new_trans, new_done, walked = _block_weights(
        carry, feat, px, py, in_range, cfg
    )
    colors = feat[..., FEAT_R : FEAT_R + 3, :]  # (..., 3, G)
    # sum_g colors[c, g] * w[p, g] -> (..., 3, P), elementwise in f32.
    new_color = carry.color + (colors[..., :, None, :] * w[..., None, :, :]).sum(-1)
    return BlendCarry(new_color, new_trans, new_done), walked.sum()


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
