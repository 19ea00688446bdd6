"""Plain PyTorch rasterizers, the port of `gsplat_tpu.ops.raster_jnp`.

  - `_raster_tiles`: the tiled walk of the sorted stream, all tiles at once
    as a batch dimension, one block of cfg.block_size Gaussians per step.
    It is the plain version of kernel K1 (`ops/cuda/raster.py`). Unlike the
    JAX walk, which stops at cfg.max_per_tile, it walks to the longest
    segment actually present (a host read of `ranges`): the kernel has no
    per-tile cap either. It also returns each pixel's walk length, which
    `walked_pairs` sums at the granularity of a warp or a tile.
  - `power_floor`: the plain copy of the kernels' per-Gaussian power floor,
    below which no pair reaches alpha_min, so that a warp skips the exp
    (`csrc/blend.cuh::power_floor`).
  - `_raster_tiles_bwd_walk`: the analytic backward, a forward re-walk with
    the suffix-sum identity (`ops/blend.py::blend_block_bwd`), batched over
    tiles like the forward. It is the plain version of kernel K2
    (`ops/cuda/raster.py`) and walks as far as the forward does.
  - `rasterize_dense_oracle`: per-pixel walk over all depth-sorted Gaussians
    with each Gaussian restricted to the tiles of its rect. O(N * H * W);
    tests only.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.config import RenderConfig, cdiv
from gsplat_tpu_torch.ops.binning import NUM_FEATURES
from gsplat_tpu_torch.ops.blend import (
    blend_block,
    blend_block_bwd,
    init_carry,
    tile_pixel_coords,
)


def _tiles_to_image(tile_colors: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(T, 3, P) per-tile pixels -> (H, W, 3) image."""
    ts = cfg.tile_size
    x = tile_colors.reshape(cfg.tiles_y, cfg.tiles_x, 3, ts, ts)
    x = x.permute(0, 3, 1, 4, 2)  # (ty, py, tx, px, c)
    x = x.reshape(cfg.padded_height, cfg.padded_width, 3)
    return x[: cfg.height, : cfg.width]


def _tiles_to_scalar_image(tile_vals: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(T, P) per-tile scalars -> (H, W)."""
    ts = cfg.tile_size
    x = tile_vals.reshape(cfg.tiles_y, cfg.tiles_x, ts, ts)
    x = x.permute(0, 2, 1, 3).reshape(cfg.padded_height, cfg.padded_width)
    return x[: cfg.height, : cfg.width]


def _image_to_tiles(img: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W, C) -> (T, C, P): the inverse of _tiles_to_image, zero on the
    ragged edge tiles' padding."""
    ts = cfg.tile_size
    c = img.shape[-1]
    padded = img.new_zeros((cfg.padded_height, cfg.padded_width, c))
    padded[: cfg.height, : cfg.width] = img
    x = padded.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts, c)
    x = x.permute(0, 2, 4, 1, 3)  # (ty, tx, c, py, px)
    return x.reshape(cfg.num_tiles, c, cfg.pixels_per_tile).contiguous()


def _raster_tiles(features, ranges, tile_offset, cfg: RenderConfig):
    """Forward walk -> (tile_colors (T, 3, P), tile_trans (T, P), walk):
    `walk` (T, P) int64 is each pixel's walk length, the (pixel, Gaussian)
    evaluations the data needs (a pixel walks its tile's segment until it
    terminates, that Gaussian included); its sum is the pairs that size the
    kernels' bounds."""
    dev = features.device
    max_i = features.shape[1]
    num_tiles = ranges.shape[0] - 1
    g = cfg.block_size
    start = ranges[:-1].long()[:, None]
    end = ranges[1:].long()[:, None]
    longest = int((end - start).max()) if num_tiles else 0
    px, py = tile_pixel_coords(
        torch.arange(num_tiles, device=dev) + tile_offset, cfg
    )
    carry = init_carry(cfg.pixels_per_tile, (num_tiles,), dev)
    walk = torch.zeros((num_tiles, cfg.pixels_per_tile), dtype=torch.int64,
                       device=dev)
    lane = torch.arange(g, device=dev)[None, :]
    for i in range(cdiv(longest, g)):
        idx = start + i * g + lane                      # (T, G)
        in_range = (idx < end)[:, None, :]              # (T, 1, G)
        feat = features[:, idx.clamp(0, max_i - 1)]     # (F, T, G)
        carry, walked = blend_block(
            carry, feat.permute(1, 0, 2), px, py, in_range, cfg
        )
        walk += walked
    return carry.color, carry.trans[..., 0], walk


def walked_pairs(walk: torch.Tensor, group: int) -> int:
    """The pairs walked when each run of `group` consecutive pixels of a
    tile (row-major) walks as far as its longest-walking pixel, as the
    threads of one warp or one CTA do: walk (T, P) from `_raster_tiles`.
    group 1 is the pairs the data needs, P the pairs of a tile-wide walk."""
    t, p = walk.shape
    if p % group:
        raise ValueError(f"walked_pairs: group {group} does not divide P {p}")
    return int(walk.reshape(t, p // group, group).amax(-1).sum()) * group


def power_floor(op, cfg: RenderConfig):
    """The kernels' power floor of Gaussians of opacity `op` (float32), the
    plain copy of `csrc/blend.cuh::power_floor`: no pair whose power lies
    below it reaches alpha >= alpha_min. It is -tau, tau = log(op /
    alpha_min) + 1e-3 (a margin for the log, exp and product roundings);
    +inf for op < alpha_min (nothing reaches), -inf where tau is not
    finite."""
    tau = torch.log(op / cfg.alpha_min) + 1e-3
    floor = torch.where(tau < float("inf"), -tau, -float("inf"))
    return torch.where(op < cfg.alpha_min, float("inf"), floor)


def _raster_tiles_bwd_walk(features, ranges, tile_offset, g_color_tiles,
                           b_total_tiles, cfg: RenderConfig):
    """Analytic backward of `_raster_tiles`: g_color_tiles (T, 3, P) and
    b_total_tiles (T, P, 1) -> (dfeat (NUM_FEATURES, max_I), applied).
    Slots outside every tile's segment, and slots no pixel reached, get
    exactly 0. `applied` is the () int64 count of (pixel, Gaussian) pairs
    with a nonzero weight: the pairs whose gradient terms the data needs."""
    dev = features.device
    max_i = features.shape[1]
    num_tiles = ranges.shape[0] - 1
    g = cfg.block_size
    start = ranges[:-1].long()[:, None]
    end = ranges[1:].long()[:, None]
    longest = int((end - start).max()) if num_tiles else 0
    px, py = tile_pixel_coords(
        torch.arange(num_tiles, device=dev) + tile_offset, cfg
    )
    carry = init_carry(cfg.pixels_per_tile, (num_tiles,), dev)
    accum_b = torch.zeros((num_tiles, cfg.pixels_per_tile, 1), device=dev)
    # Column max_i takes the out-of-range lanes and is dropped.
    dfeat = torch.zeros((NUM_FEATURES, max_i + 1), device=dev)
    applied = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(g, device=dev)[None, :]
    for i in range(cdiv(longest, g)):
        idx = start + i * g + lane                      # (T, G)
        in_range = idx < end
        feat = features[:, idx.clamp(0, max_i - 1)]     # (F, T, G)
        d, carry, accum_b, n = blend_block_bwd(
            carry, feat.permute(1, 0, 2), px, py, in_range[:, None, :],
            g_color_tiles, b_total_tiles, accum_b, cfg,
        )
        applied += n
        # Tile segments are disjoint: one scatter-set per block.
        slot = torch.where(in_range, idx, max_i).reshape(-1)
        dfeat[:, slot] = d.permute(1, 0, 2).reshape(NUM_FEATURES, -1)
    return dfeat[:, :max_i], applied


def rasterize_dense_oracle(proj, cfg: RenderConfig):
    """Reference-semantics oracle: a serial walk over globally depth-sorted
    Gaussians, blending into the full image, each Gaussian restricted to the
    pixels whose tile lies inside its rect. Small scenes only. Returns
    (image (H, W, 3), final_transmittance (H, W))."""
    dev = proj.uv.device
    order = torch.argsort(
        torch.where(proj.mask, proj.depth, float("inf")), stable=True
    )
    uv, conic, color, opacity, rect, mask = (
        x[order] for x in
        (proj.uv, proj.conic, proj.color, proj.opacity, proj.rect, proj.mask)
    )
    gx = uv[:, 0] * cfg.width
    gy = uv[:, 1] * cfg.height

    ys = torch.arange(cfg.height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(cfg.width, dtype=torch.float32, device=dev)[None, :]
    tile_x = (xs / cfg.tile_size).to(torch.int32)
    tile_y = (ys / cfg.tile_size).to(torch.int32)

    img = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    trans = torch.ones((cfg.height, cfg.width), device=dev)
    done = torch.zeros((cfg.height, cfg.width), device=dev)
    for i in range(order.shape[0]):
        covered = (
            (tile_x >= rect[i, 0])
            & (tile_x < rect[i, 2])
            & (tile_y >= rect[i, 1])
            & (tile_y < rect[i, 3])
            & mask[i]
        )
        dx = xs - gx[i]
        dy = ys - gy[i]
        power = (
            -0.5 * (conic[i, 0] * dx * dx + conic[i, 2] * dy * dy)
            - conic[i, 1] * dx * dy
        )
        alpha = torch.clamp_max(opacity[i] * torch.exp(power), cfg.alpha_clamp)
        ok = covered & (power <= 0.0) & (alpha >= cfg.alpha_min) & (done < 0.5)
        test_t = trans * (1.0 - alpha)
        terminate = ok & (test_t < cfg.transmittance_min)
        apply = ok & ~terminate
        a = torch.where(apply, alpha, 0.0)
        img = img + a[..., None] * trans[..., None] * color[i]
        trans = torch.where(apply, test_t, trans)
        done = torch.maximum(done, terminate.float())
    return img, trans
