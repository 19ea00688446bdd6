"""The tiered binning as lane grids: every tier's (rows, width) keys and
gidk values, concatenated in emission order, and one stable sort of all of
them -- the route as it was before it compacted before its sort. Torch
only (it imports no JAX), so that the card tests hold the card's route to
it too."""

import torch

from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.cuda.cull import (
    cull_params,
    cull_rank_from_params,
    rank_from_mask,
)


def tiered_lanes(proj, cfg, n_local, tile_start=None):
    """Every tier's lanes, concatenated: (key (M,) int64, SENTINEL_KEY where
    invalid; gidk (M,) int32; total () int32; pool_overflow () bool; counts
    (N,) int32 within the tile range)."""
    n = proj.mask.shape[0]
    dev = proj.mask.device
    kmax = cfg.max_tiles_per_gaussian
    kb = tbin._kbits(tbin.kmax_eff(cfg))
    depth_bits = tbin._check_depth_bits(cfg.num_tiles)

    rect_w = torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 1)
    compact_k, counts = tbin._compact_candidates(proj, cfg)
    if cfg.max_tiles_jumbo:
        area_raw = (torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 0)
                    * torch.clamp_min(proj.rect[:, 3] - proj.rect[:, 1], 0))
        area_raw = torch.where(proj.mask, area_raw, 0)
        is_jumbo = area_raw > kmax
        counts = torch.where(is_jumbo, 0, counts)

    tiers = tbin._normalize_tier_plan(cfg.tier_spec, kmax, n)
    if tile_start is None:
        gcounts = counts
    else:
        cky, ckx = tbin._rect_divmod(torch.clamp_max(compact_k, kmax - 1),
                                     rect_w[:, None])
        tile_all = ((proj.rect[:, 1:2] + cky) * cfg.tiles_x
                    + (proj.rect[:, 0:1] + ckx))
        k_all = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]
        gcounts = ((k_all < counts[:, None]) & (tile_all >= tile_start)
                   & (tile_all < tile_start + n_local)).sum(
                       dim=1, dtype=torch.int32)

    pool_budgets = [b for _, _, b in tiers if b is not None]
    depth_q = tbin._depth_q(proj.depth, depth_bits)
    if pool_budgets:
        ids_pool = torch.sort(-counts, stable=False).indices[
            : max(pool_budgets)]
        pool_rows = torch.stack(
            [rect_w, proj.rect[:, 0], proj.rect[:, 1], counts], 1
        )[ids_pool]
        pool_dq = depth_q[ids_pool]

    key_l, gidk_l = [], []
    total = torch.zeros((), dtype=torch.int32, device=dev)
    pool_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for k_lo, k_hi, budget in tiers:
        kk = torch.arange(k_lo, k_hi, dtype=torch.int32, device=dev)[None, :]
        if budget is None:
            ids_c = torch.arange(n, dtype=torch.int64, device=dev)
            ck = compact_k[:, k_lo:k_hi]
            row_w = rect_w[:, None]
            row_x0, row_y0 = proj.rect[:, 0:1], proj.rect[:, 1:2]
            row_dq = depth_q[:, None]
            row_counts = counts[:, None]
        else:
            pool_overflow = pool_overflow | ((counts > k_lo).sum() > budget)
            ids_c = ids_pool[:budget]
            ck = compact_k[ids_c, k_lo:k_hi]
            row_w = pool_rows[:budget, 0:1]
            row_x0 = pool_rows[:budget, 1:2]
            row_y0 = pool_rows[:budget, 2:3]
            row_dq = pool_dq[:budget, None]
            row_counts = pool_rows[:budget, 3:4]
        cky, ckx = tbin._rect_divmod(ck, row_w)
        tile = (row_y0 + cky) * cfg.tiles_x + (row_x0 + ckx)
        valid = kk < row_counts
        if tile_start is not None:
            valid = valid & (tile >= tile_start) & (tile < tile_start + n_local)
            tile = tile - tile_start
        key = (tile.to(torch.int64) << depth_bits) | row_dq
        key = torch.where(valid, key, torch.full_like(key, tbin.SENTINEL_KEY))
        gidk = ((ids_c[:, None] << kb) | kk).to(torch.int32)
        total = total + valid.sum(dtype=torch.int32)
        key_l.append(key.reshape(-1))
        gidk_l.append(gidk.expand(key.shape).reshape(-1))

    if cfg.max_tiles_jumbo:
        jkey_l, jgidk_l, jtotal, jovf, gcounts = _jumbo_lanes(
            proj, cfg, rect_w, area_raw, is_jumbo, gcounts, depth_bits, kb,
            n_local, tile_start)
        key_l += jkey_l
        gidk_l += jgidk_l
        total = total + jtotal
        pool_overflow = pool_overflow | jovf

    return torch.cat(key_l), torch.cat(gidk_l), total, pool_overflow, gcounts


def _jumbo_lanes(proj, cfg, rect_w, area_raw, is_jumbo, counts,
                 depth_bits, kb, n_local, tile_start=None):
    """The jumbo tiers' lanes: (key chunks, gidk chunks, total, overflow,
    counts with the jumbo splats' culled counts added)."""
    jumbo = cfg.max_tiles_jumbo
    jspec = list(cfg.jumbo_tier_spec)
    budgets = [b for _, b in jspec]
    dev = area_raw.device
    overflow = (is_jumbo.sum() > budgets[0]) | (area_raw > jumbo).any()
    ids_r = torch.sort(-area_raw, stable=False).indices[: budgets[0]]

    bound = torch.where(is_jumbo, torch.clamp_max(area_raw, jumbo), 0)
    kj = torch.arange(jumbo, dtype=torch.int32, device=dev)[None, :]
    ky_r, kx_r = tbin._rect_divmod(kj, rect_w[ids_r][:, None])
    if cfg.tile_culling:
        params = cull_params(proj, cfg, counts=bound)[:, ids_r].contiguous()
        maskj, krank, jcounts = cull_rank_from_params(params, jumbo,
                                                      cfg.tile_size)
    else:
        maskj, krank, jcounts = rank_from_mask(kj < bound[ids_r][:, None])
    tile_j = ((proj.rect[ids_r, 1:2] + ky_r) * cfg.tiles_x
              + (proj.rect[ids_r, 0:1] + kx_r))
    if tile_start is not None:
        maskj = maskj & (tile_j >= tile_start) & (tile_j < tile_start + n_local)
        jcounts = maskj.sum(dim=1, dtype=torch.int32)
        tile_j = tile_j - tile_start
    counts = counts.index_add(0, ids_r, jcounts)
    key_j = ((tile_j.to(torch.int64) << depth_bits)
             | tbin._depth_q(proj.depth[ids_r], depth_bits)[:, None])
    gidk_j = ((ids_r[:, None] << kb) | krank).to(torch.int32)

    key_l, gidk_l = [], []
    total = torch.zeros((), dtype=torch.int32, device=dev)
    k_lo = 0
    for k_hi, budget in jspec:
        overflow = overflow | ((is_jumbo & (area_raw > k_lo)).sum() > budget)
        valid = maskj[:budget, k_lo:k_hi]
        key = torch.where(valid, key_j[:budget, k_lo:k_hi], tbin.SENTINEL_KEY)
        total = total + valid.sum(dtype=torch.int32)
        key_l.append(key.reshape(-1))
        gidk_l.append(gidk_j[:budget, k_lo:k_hi].reshape(-1))
        k_lo = k_hi
    return key_l, gidk_l, total, overflow, counts


def dense_tiered(proj, cfg, tile_start=None, n_local=None):
    """The tiered route as one stable sort of every tier lane, its first
    max_intersections kept: (BinnedGaussians, the lanes' keys (M,) int64,
    their gidk (M,) int32)."""
    max_i = cfg.max_intersections
    n_tiles = cfg.num_tiles if n_local is None else n_local
    kb = tbin._kbits(tbin.kmax_eff(cfg))
    key, gidk, total, pool_ovf, counts = tiered_lanes(proj, cfg, n_tiles,
                                                      tile_start)
    rect_ovf = (torch.zeros((), dtype=torch.bool, device=key.device)
                if cfg.max_tiles_jumbo else proj.overflow)
    order = torch.sort(key, stable=True).indices[:max_i]
    s_tile = torch.clamp_max(key[order] >> tbin.depth_bits_for(cfg.num_tiles),
                             n_tiles).to(torch.int32)
    s_gidk = gidk[order]
    pad = max_i - order.shape[0]
    if pad > 0:
        s_tile = torch.cat([s_tile, s_tile.new_full((pad,), n_tiles)])
        s_gidk = torch.cat([s_gidk, s_gidk.new_full((pad,), -1)])
    s_gidk = torch.where(s_tile < n_tiles, s_gidk, -1)
    return tbin.BinnedGaussians(
        sorted_tile=s_tile,
        sorted_gid=torch.where(s_gidk >= 0, s_gidk >> kb, 0),
        ranges=tbin._tile_ranges(s_tile, n_tiles),
        num_intersections=total,
        overflow=rect_ovf | pool_ovf | (total > max_i),
        sorted_gidk=s_gidk,
        gauss_counts=counts,
        gauss_offsets=(torch.cumsum(counts, 0) - counts).to(torch.int32),
        keys_sorted=key.numel(),
    ), key, gidk
