"""Tile binning: duplicate Gaussians per covered tile, order by (tile,
depth), compute per-tile ranges, gather the sorted feature stream, and the
gather's scatter-free backward.

Port of `gsplat_tpu.ops.binning` for `binning='tiered'` (the production
mode, with the jumbo tiers of `max_tiles_jumbo`), with `'packed'` and
`'sort'` as oracles, the single-device `'scatter'` mode, and the
host-side capacity reports `tier_occupancy` and `diagnose_overflow`. The
exact ellipse-tile cull runs through kernel K3
(`ops/cuda/cull.py`), which also compacts each row of the tiers' walk and
writes the kept candidates of both compacting routes, the
backward's segmented suffix sum through kernel K4 (`ops/cuda/segsum.py`),
or K5 over bf16 pairs on the `gather_backward='bf16'` path. Differences
from the JAX package:

  - Keys are int64 with the values of the JAX u32 keys
    (`tile << depth_bits | depth_q`, sentinel 0xFFFFFFFF), because PyTorch's
    uint32 sort support on CUDA is not to be relied on.
  - Sorts are `torch.sort` and ranges `torch.searchsorted`: plain XLA ops
    in the JAX package, library calls here. The key sort is stable, so that
    ties keep the candidates' order.
  - `'packed'` compacts before it sorts: K3's count stage counts each
    Gaussian's surviving candidates, an exclusive scan gives their offsets,
    and its emit stage writes the (key, gidk) pairs in candidate order
    (Gaussian-major, k ascending) into the max_intersections slots, so the
    stable sort orders max_intersections keys where the JAX package sorts
    the whole (N, K_max) lane grid. Without capacity overflow the stream is
    the JAX package's, tie for tie. On overflow the flag and the total are
    the same, but the slots kept are the first max_intersections
    candidates in Gaussian order, where the JAX package keeps the lowest
    keys.
  - `'tiered'` compacts before it sorts too: its tiers' rows, in the order
    the JAX package concatenates their (rows, width) lane grids (the base
    tiers in ladder order, a dense tier's rows by Gaussian, a pool's by the
    shared count ranking, then the jumbo tiers' rows by the area ranking;
    a row's candidates k ascending), are counted by K3's tier count, an
    exclusive scan gives each row its offset, and K3's tier emit writes
    the kept candidates there, so the stable sort orders max_intersections
    keys where the JAX package sorts every tier lane. Without capacity
    overflow the stream is the JAX package's, tie for tie; on overflow the
    slots kept are the first max_intersections candidates in that order,
    where the JAX package keeps the lowest keys.
  - The gather backward's strategies 'variadic', 'permute' and 'c64' are
    one code path here (see `_GatherSlots`), and so are its segment sums
    'doubling' and 'pallas' (see `gather_slots_bwd`).
  - `grad_readout='bf16'` rounds the run totals it reads out to bf16, the
    bits of the JAX package's pack, take and unpack, without the pack.
  - `'scatter'` writes each valid candidate into its slot of a buffer with
    one extra trash row (the JAX `.at[slot].set(..., mode="drop")` into
    max_I + 1 rows), then orders the buffer by two stable sorts; its gather
    is a plain differentiable `index_select`, whose backward is a
    scatter-add (`gather_features`).
  - `bin_gaussians(..., tile_start, num_local_tiles)` is the shard-local
    binning of the sharded paths (`parallel/`): every route bins only the
    tiles [tile_start, tile_start + num_local_tiles) of the global grid,
    with local tile ids, after the global cull (K3 is unchanged), and
    counts each Gaussian's candidates within the range for the gather
    backward. tile_start is a Python int (one process per shard). Its keys
    pack the global grid's depth bits (the JAX package packs the band's,
    one more bit at 2 bands), and the key sort is stable: a band's stream
    is then the single-device stream's, tie for tie, and the tile-sharded
    render equals the single-device one bit for bit. With the band's bits,
    the extra bit reorders Gaussians whose depths tie in the global key.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gsplat_tpu_torch.config import RenderConfig, _normalize_tier_plan
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
from gsplat_tpu_torch.ops.cuda.cull import (
    TIER_DENSE,
    TIER_JUMBO,
    TIER_POOL,
    TierRows,
    cull_compact_from_params,
    cull_count_from_params,
    cull_emit_from_params,
    cull_params,
    cull_rank_from_params,
    cull_tier_count,
    cull_tier_emit,
    rank_from_mask,
    tile_cull_mask,
)
from gsplat_tpu_torch.ops.cuda.segsum import segmented_suffix_sum
from gsplat_tpu_torch.ops.projection import ProjectedGaussians

# Feature-row indices of the gathered sorted stream (F, max_intersections).
FEAT_GX = 0      # gaussian center x in pixels
FEAT_GY = 1
FEAT_CA = 2      # conic A
FEAT_CB = 3      # conic B
FEAT_CC = 4      # conic C
FEAT_R = 5
FEAT_G = 6
FEAT_B = 7
FEAT_OPACITY = 8
NUM_FEATURES = 9

# Low bits of the (gid << KBITS | k) sort value holding the candidate index.
KBITS = 7
SENTINEL_KEY = 0xFFFFFFFF


def kmax_eff(cfg: RenderConfig) -> int:
    """Largest candidate count any single Gaussian can emit."""
    return cfg.max_tiles_jumbo or cfg.max_tiles_per_gaussian


# The stream's slot ids, ranges and counts are int32, as the JAX package's:
# a stream holds at most this many slots.
MAX_STREAM_SLOTS = (1 << 31) - 1


def check_stream_slots(n: int, what: str) -> None:
    """Refuse a stream of n slots, before anything is allocated, where int32
    cannot hold its positions."""
    if n > MAX_STREAM_SLOTS:
        raise ValueError(f"{what}: {n} slots; the stream's ranges and slot "
                         f"ids are int32 (at most {MAX_STREAM_SLOTS})")


def _kbits(kmax: int) -> int:
    """k-field width of the gidk packing for a given effective K."""
    return max(KBITS, (kmax - 1).bit_length())


@dataclasses.dataclass
class BinnedGaussians:
    sorted_tile: torch.Tensor   # (max_I,) int32, sentinel = num_tiles
    sorted_gid: torch.Tensor    # (max_I,) int32 gaussian index per slot
    ranges: torch.Tensor        # (num_tiles + 1,) int32; tile t spans
    #                           #   [ranges[t], ranges[t+1])
    num_intersections: torch.Tensor  # () int32 true total (may exceed capacity)
    overflow: torch.Tensor      # () bool: capacity, K_max or a pool exceeded
    # The gather backward's inputs; None with 'scatter' binning.
    sorted_gidk: torch.Tensor | None   # (max_I,) int32 gid << kbits | k
    #                                  #   (-1 = padding)
    gauss_counts: torch.Tensor | None  # (N,) int32 surviving candidates per
    #                                  #   Gaussian
    gauss_offsets: torch.Tensor | None  # (N,) int32 exclusive cumsum of
    #                                   #   gauss_counts: where each
    #                                   #   Gaussian's run starts in the
    #                                   #   gid-major order of the backward
    keys_sorted: int = 0  # the key sort's length: the keys it orders, of
    #                     #   which num_intersections are candidates


def _rect_divmod(k: torch.Tensor, w: torch.Tensor):
    """(k // w, k % w) via f32 division, exactly as the JAX package does it
    ((k + 0.5) / w is never within f32 rounding of an integer)."""
    q = torch.floor((k.float() + 0.5) / w.float()).to(torch.int32)
    return q, k - q * w


def depth_bits_for(n_tiles: int) -> int:
    """Depth bits left in a 32-bit key after the tile id of an n_tiles grid."""
    tile_bits = max(int(n_tiles + 1).bit_length(), 1)
    return 32 - tile_bits


def _check_depth_bits(n_tiles: int) -> int:
    depth_bits = depth_bits_for(n_tiles)
    if depth_bits < 12:
        raise ValueError(
            f"{n_tiles} tiles leave only {depth_bits} depth bits in a u32 key"
        )
    return depth_bits


def _depth_q(depth: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Top depth_bits of the float bits of depth (monotone for positive
    depth), as int64: the logical right shift of the JAX u32 key."""
    bits = depth.float().contiguous().view(torch.int32).to(torch.int64)
    return (bits & 0xFFFFFFFF) >> (31 - depth_bits)


def pack_tile_depth_key(tile, depth, n_tiles: int) -> torch.Tensor:
    """int64 key = tile << depth_bits | quantized depth bits: the value of
    the JAX package's u32 key."""
    depth_bits = _check_depth_bits(n_tiles)
    return (tile.to(torch.int64) << depth_bits) | _depth_q(depth, depth_bits)


def _rect_cull_mask(proj, cfg: RenderConfig):
    """(N, K_max) validity of the rect walk: k < counts, intersected with
    the exact ellipse-tile cull (kernel K3) when enabled."""
    if cfg.tile_culling:
        return tile_cull_mask(proj, cfg)
    k = torch.arange(cfg.max_tiles_per_gaussian, dtype=torch.int32,
                     device=proj.counts.device)[None, :]
    return k < proj.counts[:, None]


def _compact_candidates(proj, cfg: RenderConfig, params=None):
    """(compact_k (N, K_max) int32: each Gaussian's surviving rect-walk k in
    ascending order, then K_max; counts (N,) int32 of them): one K3 launch
    (its compact stage, on `params`, else `cull_params`' rows) when the
    cull is enabled. Without the cull the survivors are k < counts, already
    in order, so nothing is sorted."""
    kmax = cfg.max_tiles_per_gaussian
    if cfg.tile_culling:
        if params is None:
            params = cull_params(proj, cfg)
        return cull_compact_from_params(params, kmax, cfg.tile_size)
    k = torch.arange(kmax, dtype=torch.int32, device=proj.counts.device)
    counts = torch.clamp(proj.counts, 0, kmax).to(torch.int32)
    return torch.where(k[None, :] < counts[:, None], k, kmax), counts


def _tier_rows(proj: ProjectedGaussians, cfg: RenderConfig, n_local: int,
               tile_start: int | None = None):
    """The tiered route's rows, in the order their candidates are emitted,
    and what the candidates are made of (`cull.TierRows`): every Gaussian
    gets a dense tier of candidate slots; Gaussians with more surviving
    tiles take rows in budgeted pools (prefixes of one shared
    count-descending ranking). Tiers enumerate only the tiles that survive
    the cull (K3's compaction of each row). With tile_start, only the tiles
    [tile_start, tile_start + n_local) are kept, re-based to local ids; tier
    membership and pool budgets still follow the global culled counts, as
    in the JAX package.

    K3's parameter rows (`cull_params`) are built whether or not the cull
    runs: the tier stages read the walk's origin and width from them.

    Returns (rows, pool_overflow () bool, counts (N,) int32 of candidates
    within the tile range: the gather backward's run lengths)."""
    n = proj.mask.shape[0]
    dev = proj.mask.device
    kmax = cfg.max_tiles_per_gaussian
    depth_bits = _check_depth_bits(cfg.num_tiles)

    rect_w = torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 1)
    # K3's parameter rows, built without the cull too: the tier stages read
    # each row's walk origin and width (x0, y0, w) from them.
    params = cull_params(proj, cfg)
    # (N, kmax): surviving k ascending, then kmax; culled counts.
    compact_k, counts = _compact_candidates(proj, cfg, params)
    if cfg.max_tiles_jumbo:
        # Splats whose raw rect exceeds the base walk go to the jumbo tiers
        # (`_jumbo_rows`); zeroing their base counts takes them out of every
        # base tier and pool, so nothing is emitted twice.
        area_raw = (torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 0)
                    * torch.clamp_min(proj.rect[:, 3] - proj.rect[:, 1], 0))
        area_raw = torch.where(proj.mask, area_raw, 0)
        is_jumbo = area_raw > kmax
        counts = torch.where(is_jumbo, 0, counts)

    plan = _normalize_tier_plan(cfg.tier_spec, kmax, n)
    if tile_start is None:
        gcounts = counts
    else:
        # Shard-local candidate counts for the gather backward (the global
        # culled counts over-count the lanes outside the tile range), on the
        # compact (N, K_max) grid.
        cky, ckx = _rect_divmod(torch.clamp_max(compact_k, kmax - 1),
                                rect_w[:, None])
        tile_all = ((proj.rect[:, 1:2] + cky) * cfg.tiles_x
                    + (proj.rect[:, 0:1] + ckx))
        k_all = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]
        gcounts = ((k_all < counts[:, None]) & (tile_all >= tile_start)
                   & (tile_all < tile_start + n_local)).sum(
                       dim=1, dtype=torch.int32)

    # One count-descending ranking shared by every pool tier: memberships
    # are nested, so the members of any pool tier are a prefix of it. Rows
    # past a tier's true member count have counts <= k_lo and keep nothing;
    # members ranked past the budget are dropped and flagged.
    pool_budgets = [b for _, _, b in plan if b is not None]
    ids_pool = None
    if pool_budgets:
        ids_pool = torch.sort(-counts, stable=False).indices[: max(pool_budgets)]
    tiers = []
    pool_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for k_lo, k_hi, budget in plan:
        if budget is None:
            tiers.append((TIER_DENSE, k_lo, k_hi, n))
        else:
            pool_overflow = pool_overflow | ((counts > k_lo).sum() > budget)
            tiers.append((TIER_POOL, k_lo, k_hi, min(budget, n)))

    ids_r = maskj = krank = None
    if cfg.max_tiles_jumbo:
        ids_r, maskj, krank, jtiers, jovf, gcounts = _jumbo_rows(
            proj, cfg, rect_w, area_raw, is_jumbo, gcounts, n_local,
            tile_start)
        tiers += jtiers
        pool_overflow = pool_overflow | jovf

    rows = TierRows(
        tiers=tuple(tiers), params=params,
        depth_q=_depth_q(proj.depth, depth_bits), counts=counts,
        compact_k=compact_k, ids_pool=ids_pool, ids_r=ids_r, maskj=maskj,
        krank=krank, tiles_x=cfg.tiles_x,
        band=None if tile_start is None else (tile_start,
                                              tile_start + n_local),
        depth_bits=depth_bits, kb=_kbits(kmax_eff(cfg)))
    return rows, pool_overflow, gcounts


def _jumbo_rows(proj: ProjectedGaussians, cfg: RenderConfig, rect_w,
                area_raw, is_jumbo, counts, n_local: int,
                tile_start: int | None = None):
    """The jumbo tiers (`cfg.max_tiles_jumbo`, port of
    `gsplat_tpu.ops.binning._jumbo_candidates`): full enumeration of the
    raw rect walk, up to max_tiles_jumbo tiles, for the splats whose rect
    exceeds the base K_max, on their own (rows, max_tiles_jumbo) grid culled
    by K3. Rows are the top of a raw-area ranking (area >= culled count);
    tier [k_lo, k_hi) takes the prefix of that ranking whose area exceeds
    k_lo, within its row budget. Membership past a budget, or a rect past
    max_tiles_jumbo, sets the overflow flag.

    Returns (ids_r (J,) int64 ranking, maskj (J, max_tiles_jumbo) bool,
    krank (J, max_tiles_jumbo) int32 (each kept lane's rank in its row: the
    gidk candidate index, so keys stay unique and below the suffix sum's
    depth), the tiers (TIER_JUMBO, k_lo, k_hi, rows), overflow, counts with
    the jumbo splats' culled counts within the tile range added)."""
    jumbo = cfg.max_tiles_jumbo
    jspec = list(cfg.jumbo_tier_spec)
    budgets = [b for _, b in jspec]
    if budgets != sorted(budgets, reverse=True):
        raise ValueError(
            "jumbo_tier_spec row budgets must descend (tiers take nested "
            f"prefixes of the area ranking); got {budgets}"
        )
    dev = area_raw.device
    overflow = (is_jumbo.sum() > budgets[0]) | (area_raw > jumbo).any()
    ids_r = torch.sort(-area_raw, stable=False).indices[: budgets[0]]

    # The walk bound of each row is its whole raw rect (up to
    # max_tiles_jumbo), and 0 for the budget-padding rows (area <= K_max),
    # which live in the base tiers.
    bound = torch.where(is_jumbo, torch.clamp_max(area_raw, jumbo), 0)
    kj = torch.arange(jumbo, dtype=torch.int32, device=dev)[None, :]
    # The mask, the ranks and the culled counts: one K3 launch (its rank
    # stage).
    if cfg.tile_culling:
        params = cull_params(proj, cfg, counts=bound)[:, ids_r].contiguous()
        maskj, krank, jcounts = cull_rank_from_params(params, jumbo,
                                                      cfg.tile_size)
    else:
        maskj, krank, jcounts = rank_from_mask(kj < bound[ids_r][:, None])
    if tile_start is not None:
        ky_r, kx_r = _rect_divmod(kj, rect_w[ids_r][:, None])
        tile_j = ((proj.rect[ids_r, 1:2] + ky_r) * cfg.tiles_x
                  + (proj.rect[ids_r, 0:1] + kx_r))
        jcounts = (maskj & (tile_j >= tile_start)
                   & (tile_j < tile_start + n_local)).sum(
                       dim=1, dtype=torch.int32)
    counts = counts.index_add(0, ids_r, jcounts)

    tiers = []
    k_lo = 0
    for k_hi, budget in jspec:
        # Membership in [k_lo, k_hi) is area > k_lo, over all jumbo splats.
        overflow = overflow | ((is_jumbo & (area_raw > k_lo)).sum() > budget)
        tiers.append((TIER_JUMBO, k_lo, k_hi, min(budget, ids_r.numel())))
        k_lo = k_hi
    return ids_r, maskj, krank, tiers, overflow, counts


def _tiered_candidates(proj: ProjectedGaussians, cfg: RenderConfig,
                       n_local: int, tile_start: int | None = None):
    """binning='tiered': the candidates of every tier row (`_tier_rows`),
    compacted before the sort. K3's tier count counts each row's kept
    candidates, an exclusive scan gives each row its offset, and K3's tier
    emit writes them in emission order (the tiers in order, a row's
    candidates k ascending) into the first of cfg.max_intersections slots:
    key = local tile << depth_bits | depth_q, gidk = gid << kbits | k (a
    jumbo candidate's k its rank among the splat's surviving tiles); the
    rest SENTINEL_KEY and -1, and candidates past the slots dropped.

    Returns (key (max_I,) int64, gidk (max_I,) int32, total () int32
    candidate count, pool_overflow () bool, counts (N,) int32 of candidates
    within the tile range)."""
    rows, pool_overflow, gcounts = _tier_rows(proj, cfg, n_local, tile_start)
    row_counts = cull_tier_count(rows)
    offsets = (torch.cumsum(row_counts, 0) - row_counts).to(torch.int32)
    key, gidk = cull_tier_emit(rows, offsets, cfg.max_intersections,
                               SENTINEL_KEY)
    return (key, gidk, row_counts.sum(dtype=torch.int32), pool_overflow,
            gcounts)


def _packed_candidates(proj: ProjectedGaussians, cfg: RenderConfig,
                       n_local: int, tile_start: int | None = None):
    """binning='packed': the surviving candidates, compacted before the
    sort. K3's count stage counts each Gaussian's candidates (the exact cull
    when enabled, else k < counts; with tile_start only the tiles
    [tile_start, tile_start + n_local)), an exclusive scan gives each its
    offset, and K3's emit stage writes them in candidate order into the
    first of cfg.max_intersections slots: key = local tile << depth_bits |
    depth_q, gidk = gid << kbits | k; the rest SENTINEL_KEY and -1, and
    candidates past the slots dropped.

    Returns (key (max_I,) int64, gidk (max_I,) int32, counts (N,) int32,
    offsets (N,) int32)."""
    kmax = cfg.max_tiles_per_gaussian
    depth_bits = _check_depth_bits(cfg.num_tiles)
    t0 = tile_start or 0
    params = cull_params(proj, cfg)
    ballots, counts = cull_count_from_params(
        params, kmax, cfg.tile_size, cfg.tile_culling, cfg.tiles_x, t0,
        t0 + n_local)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    key, gidk = cull_emit_from_params(
        params, ballots, offsets, _depth_q(proj.depth, depth_bits), kmax,
        cfg.tiles_x, t0, depth_bits, _kbits(kmax_eff(cfg)),
        cfg.max_intersections, SENTINEL_KEY)
    return key, gidk, counts, offsets


def _candidate_tiles(proj: ProjectedGaussians, cfg: RenderConfig,
                     n_local: int, tile_start: int | None = None):
    """Every Gaussian's K_max candidate (tile, gid << kbits | k), row-major
    walk of its rect, with the cull/walk validity mask: (N, K_max) each.
    With tile_start, only the tiles [tile_start, tile_start + n_local) stay
    valid, re-based to local ids."""
    n = proj.mask.shape[0]
    dev = proj.mask.device
    kmax = cfg.max_tiles_per_gaussian
    kb = _kbits(kmax_eff(cfg))
    k = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]
    rect_w = torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 1)
    ky, kx = _rect_divmod(k, rect_w[:, None])
    tile = (proj.rect[:, 1:2] + ky) * cfg.tiles_x + (proj.rect[:, 0:1] + kx)
    valid = _rect_cull_mask(proj, cfg)
    if tile_start is not None:
        valid = valid & (tile >= tile_start) & (tile < tile_start + n_local)
        tile = tile - tile_start
    gid = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    gidk = ((gid << kb) | k).expand(tile.shape)
    return tile, gidk, valid


def _tile_ranges(s_tile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(n_tiles + 1,) int32 segment starts of the tile-sorted stream."""
    return torch.searchsorted(
        s_tile, torch.arange(n_tiles + 1, dtype=torch.int32,
                             device=s_tile.device), side="left",
    ).to(torch.int32)


def _align_stream(s_tile, s_gid, ranges, max_i: int, n_local: int,
                  align: int, s_cand=None):
    """Re-space the sorted stream so that every tile's segment length is a
    multiple of `align` (port of `gsplat_tpu.ops.binning._align_stream`).
    Padding slots get gid -1, which gathers to an all-zero column (zero
    opacity: no contribution, no gradient); s_cand, when given, is re-spaced
    alongside (-1 on padding). Returns (tile, gid, ranges, total_padded[,
    cand]); a total_padded above max_i means the stream was cut."""
    dev = s_tile.device
    counts = ranges[1:] - ranges[:-1]
    padded = (counts + align - 1) // align * align
    pstart = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(padded, 0).to(torch.int32)])
    total_padded = pstart[-1]
    new_ranges = torch.clamp_max(pstart, max_i).to(torch.int32)

    # Every per-slot quantity needed (tile index, padding shift before it,
    # segment end) is monotone over the slots: written at the segment
    # starts (max over empty tiles sharing a start), then a running max.
    s = torch.arange(max_i, dtype=torch.int32, device=dev)
    pos = torch.clamp_max(pstart[:-1], max_i).to(torch.int64)

    def seg_broadcast(values):
        m = torch.zeros((max_i + 1,), dtype=torch.int32, device=dev)
        m = m.scatter_reduce(0, pos, values.to(torch.int32), "amax")
        return torch.cummax(m[:max_i], 0).values

    shift_of_s = seg_broadcast(pstart[:-1] - ranges[:-1])
    end_of_s = seg_broadcast(ranges[1:])
    t_of_s = seg_broadcast(torch.arange(n_local, dtype=torch.int32,
                                        device=dev))
    orig = s - shift_of_s
    valid = (orig < end_of_s) & (s < total_padded)
    orig_c = torch.clamp(orig, 0, max_i - 1).to(torch.int64)
    new_gid = torch.where(valid, s_gid[orig_c], -1).to(torch.int32)
    new_tile = torch.where(valid, t_of_s, n_local).to(torch.int32)
    if s_cand is None:
        return new_tile, new_gid, new_ranges, total_padded
    new_cand = torch.where(valid, s_cand[orig_c], -1).to(torch.int32)
    return new_tile, new_gid, new_ranges, total_padded, new_cand


def bin_gaussians(proj: ProjectedGaussians, cfg: RenderConfig,
                  tile_start: int | None = None,
                  num_local_tiles: int | None = None) -> BinnedGaussians:
    """Bin into the (tile, depth)-sorted stream of cfg.max_intersections
    slots. No host synchronisation: overflow is reported as a flag.

    tile_start / num_local_tiles restrict the binning to the global tiles
    [tile_start, tile_start + num_local_tiles) with local tile ids: the
    per-shard binning of the sharded paths, where cfg.max_intersections is
    the per-shard capacity and the per-Gaussian counts are those within the
    range. cfg.stream_align > 1 pads every tile's segment to a multiple of
    it (`_align_stream`)."""
    max_i = cfg.max_intersections
    n = proj.mask.shape[0]
    dev = proj.mask.device
    kmax = cfg.max_tiles_per_gaussian
    kb = _kbits(kmax_eff(cfg))
    n_tiles = cfg.num_tiles if num_local_tiles is None else num_local_tiles
    if (tile_start is None) != (num_local_tiles is None):
        raise ValueError("bin_gaussians: tile_start and num_local_tiles go "
                         "together")
    check_stream_slots(max_i, "max_intersections")
    if cfg.binning == "scatter":
        return _bin_scatter(proj, cfg, n_tiles, tile_start)
    n_cap = min((1 << 24) - 1, 1 << (31 - kb))
    if kmax > (1 << kb) or n >= n_cap:
        raise ValueError(
            f"gid<<{kb}|k packing needs max_tiles_per_gaussian <= "
            f"{1 << kb} and N < {n_cap} (got K_max {kmax}, N {n})"
        )

    pool_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    offsets = None
    if cfg.binning == "tiered":
        key, gidk, total, pool_ovf, gcounts = _tiered_candidates(
            proj, cfg, n_tiles, tile_start)
    elif cfg.binning == "packed":
        key, gidk, gcounts, offsets = _packed_candidates(
            proj, cfg, n_tiles, tile_start)
        total = gcounts.sum(dtype=torch.int32)
    else:
        tile, gidk, valid = _candidate_tiles(proj, cfg, n_tiles, tile_start)
        gcounts = valid.sum(dim=1, dtype=torch.int32)
        total = gcounts.sum(dtype=torch.int32)
        gidk = gidk.reshape(-1)
    # With jumbo tiers a rect past K_max is covered, not truncated; the
    # jumbo tiers flag what they drop (row budgets, area > max_tiles_jumbo).
    rect_ovf = (torch.zeros((), dtype=torch.bool, device=dev)
                if cfg.max_tiles_jumbo else proj.overflow)
    overflow = rect_ovf | pool_ovf | (total > max_i)

    if cfg.binning == "sort":
        # Exact (tile, f32 depth) order: two stable sorts, depth then tile.
        depth = torch.where(valid, proj.depth[:, None], float("inf")).reshape(-1)
        tile = torch.where(valid, tile, n_tiles).reshape(-1)
        order = torch.sort(depth, stable=True).indices
        order = order[torch.sort(tile[order], stable=True).indices][:max_i]
        s_tile = tile[order]
        keys_sorted = depth.numel()
    else:
        order = torch.sort(key, stable=True).indices[:max_i]
        keys_sorted = key.numel()
        s_tile = torch.clamp_max(
            key[order] >> depth_bits_for(cfg.num_tiles), n_tiles
        ).to(torch.int32)
    s_gidk = gidk[order]
    if order.shape[0] < max_i:
        pad = max_i - order.shape[0]
        s_tile = torch.cat([s_tile, s_tile.new_full((pad,), n_tiles)])
        s_gidk = torch.cat([s_gidk, s_gidk.new_full((pad,), -1)])
    # Invalid candidates sort to the sentinel tile; mark them out.
    s_gidk = torch.where(s_tile < n_tiles, s_gidk, -1)
    s_gid = torch.where(s_gidk >= 0, s_gidk >> kb, 0)
    ranges = _tile_ranges(s_tile, n_tiles)
    if (cfg.stream_align or 1) > 1:
        s_tile, s_gid, ranges, total_padded, s_gidk = _align_stream(
            s_tile, s_gid, ranges, max_i, n_tiles, cfg.stream_align, s_gidk)
        overflow = overflow | (total_padded > max_i)

    if offsets is None:
        offsets = (torch.cumsum(gcounts, 0) - gcounts).to(torch.int32)
    return BinnedGaussians(
        sorted_tile=s_tile,
        sorted_gid=s_gid,
        ranges=ranges,
        num_intersections=total,
        overflow=overflow,
        sorted_gidk=s_gidk,
        gauss_counts=gcounts,
        gauss_offsets=offsets,
        keys_sorted=keys_sorted,
    )


def _bin_scatter(proj: ProjectedGaussians, cfg: RenderConfig, n_tiles: int,
                 tile_start: int | None = None) -> BinnedGaussians:
    """binning='scatter': each valid candidate goes to the slot offsets[g] +
    its rank among g's valid candidates; slots past max_I and invalid lanes
    go to the trash row max_I, which is sliced off. The buffer is then
    ordered by (tile, depth), depth first, both sorts stable. No gidk
    stream: the gather backward is a scatter-add."""
    max_i = cfg.max_intersections
    n = proj.mask.shape[0]
    dev = proj.mask.device
    tile, _, valid = _candidate_tiles(proj, cfg, n_tiles, tile_start)
    counts = valid.sum(dim=1, dtype=torch.int32)
    total = counts.sum(dtype=torch.int32)
    overflow = proj.overflow | (total > max_i)

    offsets = torch.cumsum(counts, 0) - counts
    local_rank = torch.cumsum(valid, dim=1) - 1
    slot = offsets[:, None] + local_rank
    slot = torch.where(valid & (slot < max_i), slot, max_i).reshape(-1)
    tile_f = torch.where(valid, tile, n_tiles).reshape(-1)
    depth_f = torch.where(valid, proj.depth[:, None], math.inf).reshape(-1)
    gid_f = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(
        tile.shape).reshape(-1)

    def scatter(fill, vals):
        buf = torch.full((max_i + 1,), fill, dtype=vals.dtype, device=dev)
        buf[slot] = vals
        return buf[:max_i]

    tile_buf = scatter(n_tiles, tile_f.to(torch.int32))
    depth_buf = scatter(math.inf, depth_f.to(torch.float32))
    gid_buf = scatter(0, gid_f)
    order = torch.sort(depth_buf, stable=True).indices
    order = order[torch.sort(tile_buf[order], stable=True).indices]
    s_tile = tile_buf[order]
    s_gid = gid_buf[order]
    ranges = _tile_ranges(s_tile, n_tiles)
    if (cfg.stream_align or 1) > 1:
        s_tile, s_gid, ranges, total_padded = _align_stream(
            s_tile, s_gid, ranges, max_i, n_tiles, cfg.stream_align)
        overflow = overflow | (total_padded > max_i)
    return BinnedGaussians(
        sorted_tile=s_tile,
        sorted_gid=s_gid,
        ranges=ranges,
        num_intersections=total,
        overflow=overflow,
        sorted_gidk=None,
        gauss_counts=None,
        gauss_offsets=None,
        keys_sorted=depth_buf.numel(),
    )


def tier_occupancy(proj: ProjectedGaussians, cfg: RenderConfig) -> dict:
    """Capacity report of tiered binning for one scene and camera: per-tier
    membership against budget, the post-cull intersection total, and K_max
    pressure. A host-side diagnostic (it reads the device), not part of the
    render path.

    Returns {"tiers": [{k_lo, k_hi, budget, members, occupancy}...],
             "num_intersections", "suggested_max_intersections",
             "rect_overflow" (some rect exceeded K_max, or K_jumbo with the
             jumbo tiers), "count_quantiles" (post-cull tiles per Gaussian),
             and with the jumbo tiers "jumbo" (their budgets, by raw rect
             area: an upper bound on the culled counts)}."""
    import numpy as np

    n = proj.mask.shape[0]
    kmax = cfg.max_tiles_per_gaussian
    with torch.no_grad():
        counts = _rect_cull_mask(proj, cfg).sum(dim=1, dtype=torch.int32)
    counts = counts.cpu().numpy()
    jumbo_report = None
    if cfg.max_tiles_jumbo and cfg.binning == "tiered":
        rect = proj.rect.cpu().numpy()
        area = np.maximum(rect[:, 2] - rect[:, 0], 0) * np.maximum(
            rect[:, 3] - rect[:, 1], 0
        )
        area = np.where(proj.mask.cpu().numpy(), area, 0)
        isj = area > kmax
        counts = np.where(isj, 0, counts)
        jrows = []
        k_lo = 0
        for k_hi, budget in cfg.jumbo_tier_spec:
            members = int((isj & (np.minimum(area, cfg.max_tiles_jumbo)
                                  > k_lo)).sum())
            jrows.append(dict(k_lo=k_lo, k_hi=k_hi, budget=budget,
                              members_upper=members,
                              occupancy_upper=round(members / budget, 4)))
            k_lo = k_hi
        jumbo_report = {
            "rows_budget": cfg.jumbo_tier_spec[0][1],
            "jumbo_splats": int(isj.sum()),
            "max_raw_rect": int(area.max()),
            "over_k_jumbo": int((area > cfg.max_tiles_jumbo).sum()),
            "tiers": jrows,
        }
    rows = []
    for k_lo, k_hi, budget in _normalize_tier_plan(cfg.tier_spec, kmax, n):
        members = int((counts > k_lo).sum()) if budget is not None else n
        rows.append(dict(
            k_lo=k_lo,
            k_hi=k_hi,
            budget=budget if budget is not None else n,
            members=members,
            occupancy=round(members / (budget if budget is not None else n),
                            4),
        ))
    total = int(counts.sum())
    out = {
        "tiers": rows,
        "num_intersections": total,
        "suggested_max_intersections": int(total * 1.15),
        "rect_overflow": bool(proj.overflow) if jumbo_report is None
        else jumbo_report["over_k_jumbo"] > 0,
        "count_quantiles": {
            str(q): int(np.quantile(counts, q))
            for q in (0.5, 0.9, 0.99, 0.999, 1.0)
        },
    }
    if jumbo_report is not None:
        out["jumbo"] = jumbo_report
    return out


def diagnose_overflow(proj: ProjectedGaussians, cfg: RenderConfig) -> dict:
    """Why a frame's overflow flag is set (host-side; wraps tier_occupancy).
    Returns {"causes": [...], "occupancy": tier_occupancy dict}; causes are
    'rect>K_max' ('rect>K_jumbo' with the jumbo tiers), 'pool' (a tier
    budget saturated), 'jumbo-budget(upper-bound)' and 'stream' (live
    intersections past max_intersections)."""
    occ = tier_occupancy(proj, cfg)
    causes = []
    if occ["rect_overflow"]:
        causes.append(
            "rect>K_jumbo" if cfg.max_tiles_jumbo else "rect>K_max"
        )
    if any(t["occupancy"] > 1.0 for t in occ["tiers"]):
        causes.append("pool")
    j = occ.get("jumbo")
    if j and (
        j["jumbo_splats"] > j["rows_budget"]
        or any(t["occupancy_upper"] > 1.0 for t in j["tiers"])
    ):
        causes.append("jumbo-budget(upper-bound)")
    if occ["num_intersections"] > cfg.max_intersections:
        causes.append("stream")
    return {"causes": causes, "occupancy": occ}


def features_f32(proj: ProjectedGaussians, cfg: RenderConfig) -> torch.Tensor:
    """The (NUM_FEATURES, N) float32 per-Gaussian feature table, FEAT_* rows."""
    return torch.stack(
        [
            proj.uv[:, 0] * cfg.width,
            proj.uv[:, 1] * cfg.height,
            proj.conic[:, 0],
            proj.conic[:, 1],
            proj.conic[:, 2],
            proj.color[:, 0],
            proj.color[:, 1],
            proj.color[:, 2],
            proj.opacity,
        ],
        0,
    )


def gather_features(proj: ProjectedGaussians, binned: BinnedGaussians,
                    cfg: RenderConfig) -> torch.Tensor:
    """(NUM_FEATURES, max_intersections) float32 features in sorted-stream
    order. Slots with gid -1 read an appended zero column. Differentiable:
    the backward is `_GatherSlots`'s sort and segmented suffix sum, not a
    scatter-add; with 'scatter' binning (no gidk stream) it is the plain
    gather, whose backward is a scatter-add."""
    return gather_stream(features_f32(proj, cfg), binned, cfg)


def gather_stream(feats: torch.Tensor, binned: BinnedGaussians,
                  cfg: RenderConfig) -> torch.Tensor:
    """`gather_features` from the feature table `features_f32` made."""
    if binned.sorted_gidk is None:
        n = feats.shape[1]
        feats_pad = torch.cat([feats, feats.new_zeros((feats.shape[0], 1))], 1)
        gid = torch.where(binned.sorted_gid < 0, n, binned.sorted_gid)
        return feats_pad.index_select(1, gid.to(torch.int64))
    return _GatherSlots.apply(
        feats, binned.sorted_gid, binned.sorted_gidk,
        binned.gauss_offsets, binned.gauss_counts, kmax_eff(cfg),
        cfg.gather_backward, cfg.grad_readout,
    )


def packed_grad_reduce(xp, key, offsets, counts, kmax: int, f: int):
    """Slot gradients as (P, M) int32 bf16 pairs -> per-Gaussian (f, N)
    float32 gradients (port of `gsplat_tpu.ops.binning.packed_grad_reduce`):
    the key sort, one `index_select` of the pair rows into gid-major runs,
    the packed segmented suffix sum (K5 on the card), the pairs at the run
    starts unpacked, and zero for Gaussians with no slot. key is gidk with
    invalid slots as 2**31 - 1. The pairs stay int32 throughout."""
    m = key.shape[0]
    s_key, perm = torch.sort(key, stable=False)
    xp = xp.index_select(1, perm).contiguous()
    rows = (s_key >> _kbits(kmax)).to(torch.int32)
    xsum = segmented_suffix_sum(xp, rows, kmax)
    offs = torch.clamp(offsets, 0, m - 1).to(torch.int64)
    dgauss = unpack_bf16_pairs(xsum.index_select(1, offs), f)
    return dgauss * (counts > 0)[None, :].to(dgauss.dtype)


def gather_slots_bwd(dslot, gidk, offsets, counts, kmax: int,
                     strategy: str = "variadic",
                     readout: str = "f32") -> torch.Tensor:
    """Slot gradients (F, M) -> per-Gaussian gradients (F, N), with no
    scatter (port of `gsplat_tpu.ops.binning._gather_slots_bwd`):
      1. sort the keys gidk (invalid slots last, as 2**31 - 1) and carry the
         slot gradients along, so each Gaussian's slots form one run;
      2. segmented suffix sum, so every run's total lands on its first
         slot: kernel K4 for a CUDA tensor, the plain doubling for a CPU
         one. The JAX package's segment_sum 'doubling' and 'pallas' sum
         the same slots (K4, like the doubling, sums every run of at most
         the doubling's reach whole; the one longer run, the invalid tail,
         is all zeros), so here they are one path and `cfg.segment_sum`
         selects nothing;
      3. read the run starts at gauss_offsets, zero for Gaussians with no
         slot; with readout 'bf16' the totals read are rounded to bf16.
    strategy 'bf16' instead rounds the slot gradients to bf16 pairs first
    (unless dslot already holds the NUM_FEATURES gradients as (P, M) int32
    pairs, as K2 writes them on a packed stream) and reduces them with
    `packed_grad_reduce` (K5). The float32 strategies 'variadic', 'permute'
    and 'c64' compute the same numbers and are one path here. Needs every
    valid candidate in the stream, which holds whenever the overflow flag
    is clear."""
    m = gidk.shape[0]
    key = torch.where(gidk >= 0, gidk, 2**31 - 1)
    if strategy == "bf16":
        if dslot.dtype == torch.int32:
            return packed_grad_reduce(dslot, key, offsets, counts, kmax,
                                      NUM_FEATURES)
        return packed_grad_reduce(pack_bf16_pairs(dslot), key, offsets,
                                  counts, kmax, dslot.shape[0])
    # Valid keys are unique, so an unstable sort gives the same runs.
    s_key, perm = torch.sort(key, stable=False)
    x = dslot.index_select(1, perm).contiguous()
    rows = (s_key >> _kbits(kmax)).to(torch.int32)
    x = segmented_suffix_sum(x, rows, kmax)
    offs = torch.clamp(offsets, 0, m - 1).to(torch.int64)
    dgauss = x.index_select(1, offs)
    if readout == "bf16":
        # The JAX package packs the sums to bf16 pairs, takes the run starts
        # and unpacks: the same bits as rounding the run starts.
        dgauss = dgauss.to(torch.bfloat16).to(torch.float32)
    return dgauss * (counts > 0)[None, :].to(dgauss.dtype)


class _GatherSlots(torch.autograd.Function):
    """Gather per-Gaussian features into slot order; its backward is
    `gather_slots_bwd` with the config's strategy and read-out. The JAX
    package's gather_backward strategies 'variadic' (one variadic sort
    carrying the rows), 'permute' (sort, then one 2-D take) and 'c64' (rows
    paired into complex sort values) differ only in how XLA moves the rows
    through its sort; all three compute the same f32 numbers, and here they
    are one path: a key sort, then one permutation gather."""

    @staticmethod
    def forward(ctx, feats, gid, gidk, offsets, counts, kmax, strategy,
                readout):
        n = feats.shape[1]
        feats_pad = torch.cat([feats, feats.new_zeros((feats.shape[0], 1))], 1)
        g = torch.where(gid < 0, n, gid).to(torch.int64)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(gidk, offsets, counts)
            ctx.opts = (kmax, strategy, readout)
        return feats_pad.index_select(1, g).contiguous()

    @staticmethod
    def backward(ctx, dslot):
        gidk, offsets, counts = ctx.saved_tensors
        dgauss = gather_slots_bwd(dslot.contiguous(), gidk, offsets, counts,
                                  *ctx.opts)
        return dgauss, None, None, None, None, None, None, None
