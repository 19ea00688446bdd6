"""K3, the exact ellipse-tile cull: CUDA kernel `csrc/cull.cu` and its plain
PyTorch versions, for each of the kernel's output stages.

Replaces `gsplat_tpu/ops/pallas/cull.py::_cull_kernel` and, in the compact
stage, the row sort of the JAX package's tiered binning
(`compact_k = jnp.sort(jnp.where(valid_all, k, kmax), axis=1)`,
`gsplat_tpu/ops/binning.py:359`). `cull_params` packs the per-Gaussian rows
every version reads, in plain torch on every device, so the kernel and the
plain versions see identical inputs. `cull_mask_plain` is the port of
`gsplat_tpu.ops.binning._precise_tile_valid` on those rows, with its
arithmetic in the same order as the kernel's; the kernel never contracts
into FMAs, so the two agree bit for bit. The stages:

  - mask: the (R, kmax) bool mask (`cull_mask_*`);
  - compact: each row's kept k ascending padded with kmax, (R, kmax) int32,
    and the kept counts (R,) int32 (`cull_compact_*`: the base tiers);
  - rank: the mask, krank = cumsum(mask, 1) - 1 (R, kmax) int32, and the
    counts (`cull_rank_*`: the jumbo grid);
  - count: each row's kept lanes as ballot words (R, ceil(kmax / 32)) int32
    (bit k % 32 of word k // 32) and the counts (`cull_count_*`: the first
    half of the 'packed' binning), with or without the cull, keeping only
    the lanes whose tile lies in [tile_lo, tile_hi);
  - emit: from those ballots and the rows' exclusive offsets, each kept
    lane's (tile, depth) key and gid << kb | k at slot offset + rank of a
    stream of max_slots, the rest the sentinel key and -1 (`cull_emit_*`:
    the second half; no cull, no walk past the kept lanes);
  - tier count and tier emit: the same two halves for the tiered route,
    over the rows of its tiers (`TierRows`) and from what the compact and
    rank stages wrote (`cull_tier_count_*`, `cull_tier_emit_*`).

The plain compact and rank versions are the mask followed by the torch ops
the kernel's stage replaces (`compact_from_mask`, `rank_from_mask`); the
plain count and emit are the mask, the band and the scatter written out
(`ballots_from_mask`, `mask_from_ballots`, `walk_tiles`); the plain tier
count and emit build every tier's lane grid, as the tiered route did before
it compacted (`tier_lanes`), and count or scatter its kept lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gsplat_tpu_torch.config import MAX_TIERS, RenderConfig
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import FLOAT, INT, INT64, PTR

# Parameter rows of the (NUM_ROWS, N) input.
R_GX, R_GY, R_A, R_B, R_C, R_TAU, R_X0, R_Y0, R_W, R_COUNT = range(10)
NUM_ROWS = 10

# The kernel's `stage` argument (csrc/cull.cu, Stage).
STAGES = {"mask": 0, "compact": 1, "rank": 2}

# The entry points; each launch counts under "K3.<stage>".
_CULL = _build.kernel("cull", "gsplat_cull",
                      [PTR, INT64, INT, FLOAT, INT, PTR, PTR, PTR], None)
_COUNT = _build.kernel(
    "cull", "gsplat_cull_count",
    [PTR, INT64, INT, FLOAT, INT, INT, INT, INT, PTR, PTR], "K3.count")
_EMIT = _build.kernel(
    "cull", "gsplat_cull_emit",
    [PTR, PTR, PTR, PTR, INT64, INT, INT, INT, INT, INT, INT64, PTR, PTR],
    "K3.emit")
# Counts under "K3.tier_count" or "K3.tier_emit", by its mode.
_TIER = _build.kernel(
    "cull", "gsplat_cull_tier",
    [PTR, INT, INT, PTR, INT64, PTR, PTR, PTR, INT, PTR, PTR, PTR, PTR, INT,
     INT, INT, INT, INT, INT, INT, PTR, PTR, INT64, PTR, PTR], None)

# The kinds of the tiered route's tiers (csrc/cull.cu, TierKind).
TIER_DENSE, TIER_POOL, TIER_JUMBO = 0, 1, 2


def cull_params(proj, cfg: RenderConfig, counts=None) -> torch.Tensor:
    """(10, N) float32 parameter rows; tau = -1 culls every lane of a
    Gaussian with opacity <= alpha_min. `counts` overrides proj.counts as
    the walk bound (the jumbo tiers pass the raw rect area, clipped to
    max_tiles_jumbo, where proj.counts clips to K_max, and 0 for the rows
    that are not jumbo)."""
    if counts is None:
        counts = proj.counts
    rect_w = torch.clamp_min(proj.rect[:, 2] - proj.rect[:, 0], 1)
    tau = 2.0 * torch.log(torch.clamp_min(proj.opacity / cfg.alpha_min, 1e-12))
    tau = torch.where(proj.opacity > cfg.alpha_min, tau,
                      torch.full_like(tau, -1.0))
    rows = [
        proj.uv[:, 0] * cfg.width,
        proj.uv[:, 1] * cfg.height,
        proj.conic[:, 0],
        proj.conic[:, 1],
        proj.conic[:, 2],
        tau,
        proj.rect[:, 0].float(),
        proj.rect[:, 1].float(),
        rect_w.float(),
        counts.float(),
    ]
    return torch.stack(rows, 0).detach()


def cull_mask_plain(params: torch.Tensor, kmax: int, tile_size: int) -> torch.Tensor:
    """(10, R) rows -> (R, kmax) bool survival mask, in plain torch."""
    ts = float(tile_size)

    def row(i):  # (R, 1)
        return params[i][:, None]

    k = torch.arange(kmax, dtype=torch.float32, device=params.device)[None, :]
    w = row(R_W)
    ky = torch.floor((k + 0.5) / w)
    kx = k - ky * w
    tx = row(R_X0) + kx
    ty = row(R_Y0) + ky

    # Tile pixel-centre range [t*ts, t*ts + ts - 1], as deltas from centre.
    dx0 = tx * ts - row(R_GX)
    dx1 = dx0 + (ts - 1.0)
    dy0 = ty * ts - row(R_GY)
    dy1 = dy0 + (ts - 1.0)
    inside = (dx0 <= 0.0) & (0.0 <= dx1) & (dy0 <= 0.0) & (0.0 <= dy1)

    a, b, c = row(R_A), row(R_B), row(R_C)
    neg_b_over_a = -b / torch.clamp_min(a, 1e-12)
    neg_b_over_c = -b / torch.clamp_min(c, 1e-12)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(d):  # dx = d fixed, minimise over dy
        return q(d, torch.clamp(neg_b_over_c * d, dy0, dy1))

    def edge_y(d):  # dy = d fixed, minimise over dx
        return q(torch.clamp(neg_b_over_a * d, dx0, dx1), d)

    qmin = torch.minimum(
        torch.minimum(edge_x(dx0), edge_x(dx1)),
        torch.minimum(edge_y(dy0), edge_y(dy1)),
    )
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    return (qmin <= row(R_TAU)) & (k < row(R_COUNT))


def compact_from_mask(mask: torch.Tensor):
    """(R, kmax) bool -> (each row's kept k ascending then kmax, (R, kmax)
    int32; kept counts (R,) int32): the where, row sort and sum that the
    compact stage replaces."""
    kmax = mask.shape[1]
    k = torch.arange(kmax, dtype=torch.int32, device=mask.device)[None, :]
    compact = torch.sort(torch.where(mask, k, torch.full_like(k, kmax)),
                         dim=1, stable=False).values
    return compact, mask.sum(dim=1, dtype=torch.int32)


def rank_from_mask(mask: torch.Tensor):
    """(R, kmax) bool -> (mask; krank = cumsum(mask, 1) - 1, (R, kmax)
    int32; kept counts (R,) int32): the ops that the rank stage replaces."""
    krank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    return mask, krank, mask.sum(dim=1, dtype=torch.int32)


def cull_compact_plain(params: torch.Tensor, kmax: int, tile_size: int):
    """(10, R) rows -> (compact_k (R, kmax) int32, counts (R,) int32)."""
    return compact_from_mask(cull_mask_plain(params, kmax, tile_size))


def cull_rank_plain(params: torch.Tensor, kmax: int, tile_size: int):
    """(10, R) rows -> (mask, krank (R, kmax) int32, counts (R,) int32)."""
    return rank_from_mask(cull_mask_plain(params, kmax, tile_size))


def walk_tiles(params: torch.Tensor, kmax: int, tiles_x: int) -> torch.Tensor:
    """(10, R) rows -> (R, kmax) int32 tile id y * tiles_x + x of every lane
    of the rect walk (meaningful where the lane is within the walk)."""
    k = torch.arange(kmax, dtype=torch.float32, device=params.device)[None, :]
    return tiles_at(params, k, tiles_x)


def tiles_at(params: torch.Tensor, k: torch.Tensor,
             tiles_x: int) -> torch.Tensor:
    """(10, R) rows and rect-walk indices k, (R, W) or (1, W) -> (R, W)
    int32 tile ids y * tiles_x + x of those lanes."""
    k = k.to(torch.float32)
    w = params[R_W][:, None]
    ky = torch.floor((k + 0.5) / w)
    kx = k - ky * w
    return ((params[R_Y0][:, None] + ky).to(torch.int32) * tiles_x
            + (params[R_X0][:, None] + kx).to(torch.int32))


def ballots_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(R, kmax) bool -> (R, ceil(kmax / 32)) int32 ballot words, bit k % 32
    of word k // 32."""
    r, kmax = mask.shape
    chunks = (kmax + 31) // 32
    bits = torch.nn.functional.pad(mask, (0, 32 * chunks - kmax)).view(
        r, chunks, 32).to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits << shift).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def mask_from_ballots(ballots: torch.Tensor, kmax: int) -> torch.Tensor:
    """The inverse of `ballots_from_mask`: (R, kmax) bool."""
    shift = torch.arange(32, dtype=torch.int32, device=ballots.device)
    bits = (ballots[:, :, None] >> shift) & 1
    return bits.reshape(ballots.shape[0], -1)[:, :kmax].bool()


def cull_count_plain(params: torch.Tensor, kmax: int, tile_size: int,
                     cull: bool, tiles_x: int, tile_lo: int, tile_hi: int):
    """(10, R) rows -> (ballots (R, ceil(kmax / 32)) int32, counts (R,)
    int32) of the lanes kept by the cull (or, without it, k < count) whose
    tile lies in [tile_lo, tile_hi)."""
    if cull:
        mask = cull_mask_plain(params, kmax, tile_size)
    else:
        k = torch.arange(kmax, dtype=torch.float32, device=params.device)
        mask = k[None, :] < params[R_COUNT][:, None]
    tile = walk_tiles(params, kmax, tiles_x)
    mask = mask & (tile >= tile_lo) & (tile < tile_hi)
    return ballots_from_mask(mask), mask.sum(dim=1, dtype=torch.int32)


def cull_emit_plain(params: torch.Tensor, ballots: torch.Tensor,
                    offsets: torch.Tensor, depth_q: torch.Tensor, kmax: int,
                    tiles_x: int, tile_lo: int, depth_bits: int, kb: int,
                    max_slots: int, sentinel: int):
    """The kept lanes of `ballots` at slots offsets + rank (those below
    max_slots): (keys (max_slots,) int64 = (tile - tile_lo) << depth_bits |
    depth_q, gidk (max_slots,) int32 = row << kb | k); the sentinel and -1
    elsewhere."""
    r, dev = params.shape[1], params.device
    mask = mask_from_ballots(ballots, kmax)
    slot = (offsets.to(torch.int64)[:, None]
            + torch.cumsum(mask, dim=1, dtype=torch.int64) - 1)
    mask = mask & (slot < max_slots)
    tile = (walk_tiles(params, kmax, tiles_x) - tile_lo).to(torch.int64)
    key = (tile << depth_bits) | depth_q[:, None]
    gidk = ((torch.arange(r, dtype=torch.int64, device=dev)[:, None] << kb)
            | torch.arange(kmax, dtype=torch.int64, device=dev)).to(torch.int32)
    keys = torch.full((max_slots,), sentinel, dtype=torch.int64, device=dev)
    out_gidk = torch.full((max_slots,), -1, dtype=torch.int32, device=dev)
    keys[slot[mask]] = key[mask]
    out_gidk[slot[mask]] = gidk[mask]
    return keys, out_gidk


@dataclasses.dataclass
class TierRows:
    """The tiered route's rows and what their lanes are made of
    (`ops/binning.py::_tier_rows`). `tiers` holds (kind, k_lo, k_hi, rows)
    in the order the rows are emitted: the base tiers in ladder order
    (TIER_DENSE: row i is Gaussian i; TIER_POOL: row i is Gaussian
    ids_pool[i]), then the jumbo tiers (row j is Gaussian ids_r[j] and row
    j of maskj and krank). A row's lanes are k in [k_lo, k_hi)."""

    tiers: tuple
    params: torch.Tensor     # (10, N) `cull_params` rows: x0, y0, w read
    depth_q: torch.Tensor    # (N,) int64 depth bits of the keys
    counts: torch.Tensor     # (N,) int32 base-tier candidates (jumbo: 0)
    compact_k: torch.Tensor  # (N, kmax) int32, the compact stage's
    ids_pool: torch.Tensor | None  # (P,) int64, the pools' ranking
    ids_r: torch.Tensor | None     # (J,) int64, the jumbo tiers' ranking
    maskj: torch.Tensor | None     # (J, jumbo) bool, the rank stage's mask
    krank: torch.Tensor | None     # (J, jumbo) int32, its ranks
    tiles_x: int
    band: tuple | None       # (tile_lo, tile_hi) kept, or None: every tile
    depth_bits: int
    kb: int

    @property
    def device(self) -> torch.device:
        return self.params.device


def tier_lanes(rows: TierRows):
    """Each tier's (key (R, W) int64, gidk (R, W) int32, valid (R, W) bool)
    lane grid, in emission order. A base lane k of Gaussian g walks to
    compact_k[g, k] and has gidk g << kb | k, valid where k < counts[g]; a
    jumbo lane k of row j walks to k and has gidk g << kb | krank[j, k],
    valid where maskj[j, k]; with a band, valid only on its tiles. key =
    (tile - tile_lo) << depth_bits | depth_q[g]."""
    dev = rows.device
    tile_lo = 0 if rows.band is None else rows.band[0]
    for kind, k_lo, k_hi, n_rows in rows.tiers:
        kk = torch.arange(k_lo, k_hi, dtype=torch.int64, device=dev)[None, :]
        if kind == TIER_JUMBO:
            gid = rows.ids_r[:n_rows]
            walk = kk
            valid = rows.maskj[:n_rows, k_lo:k_hi]
            cand = rows.krank[:n_rows, k_lo:k_hi].to(torch.int64)
        else:
            gid = (torch.arange(n_rows, device=dev) if kind == TIER_DENSE
                   else rows.ids_pool[:n_rows])
            walk = rows.compact_k[gid, k_lo:k_hi]
            valid = kk < rows.counts[gid][:, None]
            cand = kk
        tile = tiles_at(rows.params[:, gid], walk, rows.tiles_x).to(
            torch.int64)
        if rows.band is not None:
            valid = valid & (tile >= rows.band[0]) & (tile < rows.band[1])
        key = (((tile - tile_lo) << rows.depth_bits)
               | rows.depth_q[gid][:, None])
        gidk = ((gid[:, None] << rows.kb) | cand).to(torch.int32)
        yield key, gidk.expand(key.shape), valid


def cull_tier_count_plain(rows: TierRows) -> torch.Tensor:
    """(rows,) int32: each tier row's kept lanes, in emission order."""
    return torch.cat([valid.sum(dim=1, dtype=torch.int32)
                      for _, _, valid in tier_lanes(rows)])


def cull_tier_emit_plain(rows: TierRows, offsets: torch.Tensor,
                         max_slots: int, sentinel: int):
    """Each row's kept lanes at slots offsets[row] + their rank in the row
    (those below max_slots): (keys (max_slots,) int64, gidk (max_slots,)
    int32); the sentinel and -1 elsewhere."""
    dev = rows.device
    keys = torch.full((max_slots,), sentinel, dtype=torch.int64, device=dev)
    out_gidk = torch.full((max_slots,), -1, dtype=torch.int32, device=dev)
    start = 0
    for (key, gidk, valid), tier in zip(tier_lanes(rows), rows.tiers):
        slot = (offsets[start:start + tier[3]].to(torch.int64)[:, None]
                + torch.cumsum(valid, dim=1, dtype=torch.int64) - 1)
        kept = valid & (slot < max_slots)
        keys[slot[kept]] = key[kept]
        out_gidk[slot[kept]] = gidk[kept]
        start += tier[3]
    return keys, out_gidk


def _check_params(params: torch.Tensor) -> None:
    _build.expect(params, "cull: params", dtype=torch.float32,
                  shape=(NUM_ROWS, None))


def _launch(params: torch.Tensor, kmax: int, tile_size: int, stage: str):
    """Launch the kernel's `stage` on (10, R) rows: its outputs as the
    plain version of that stage returns them."""
    _check_params(params)
    r, dev = params.shape[1], params.device
    mask = idx = counts = None
    if stage != "compact":
        mask = torch.empty((r, kmax), dtype=torch.bool, device=dev)
    if stage != "mask":
        idx = torch.empty((r, kmax), dtype=torch.int32, device=dev)
        counts = torch.empty((r,), dtype=torch.int32, device=dev)
    _CULL(dev, params.data_ptr(), r, kmax, float(tile_size), STAGES[stage],
          *(0 if t is None else t.data_ptr() for t in (mask, idx, counts)),
          count=f"K3.{stage}")
    return {"mask": mask, "compact": (idx, counts),
            "rank": (mask, idx, counts)}[stage]


def cull_mask_cuda(params: torch.Tensor, kmax: int,
                   tile_size: int) -> torch.Tensor:
    """The mask stage: (10, R) rows -> (R, kmax) bool mask."""
    return _launch(params, kmax, tile_size, "mask")


def cull_compact_cuda(params: torch.Tensor, kmax: int, tile_size: int):
    """The compact stage: (10, R) rows -> (compact_k, counts)."""
    return _launch(params, kmax, tile_size, "compact")


def cull_rank_cuda(params: torch.Tensor, kmax: int, tile_size: int):
    """The rank stage: (10, R) rows -> (mask, krank, counts)."""
    return _launch(params, kmax, tile_size, "rank")


def cull_count_cuda(params: torch.Tensor, kmax: int, tile_size: int,
                    cull: bool, tiles_x: int, tile_lo: int, tile_hi: int):
    """The count stage: (10, R) rows -> (ballots, counts)."""
    _check_params(params)
    r, dev = params.shape[1], params.device
    ballots = torch.empty((r, (kmax + 31) // 32), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((r,), dtype=torch.int32, device=dev)
    _COUNT(dev, params.data_ptr(), r, kmax, float(tile_size), int(cull),
           tiles_x, tile_lo, tile_hi, ballots.data_ptr(), counts.data_ptr())
    return ballots, counts


def cull_emit_cuda(params: torch.Tensor, ballots: torch.Tensor,
                   offsets: torch.Tensor, depth_q: torch.Tensor, kmax: int,
                   tiles_x: int, tile_lo: int, depth_bits: int, kb: int,
                   max_slots: int, sentinel: int):
    """The emit stage: the count stage's ballots -> (keys, gidk)."""
    _check_params(params)
    r, dev = params.shape[1], params.device
    for name, t, dtype, shape in (
            ("ballots", ballots, torch.int32, (r, (kmax + 31) // 32)),
            ("offsets", offsets, torch.int32, (r,)),
            ("depth_q", depth_q, torch.int64, (r,))):
        _build.expect(t, f"cull emit: {name}", dtype=dtype, shape=shape,
                      device=dev)
    keys = torch.full((max_slots,), sentinel, dtype=torch.int64, device=dev)
    gidk = torch.full((max_slots,), -1, dtype=torch.int32, device=dev)
    _EMIT(dev, params.data_ptr(), ballots.data_ptr(), offsets.data_ptr(),
          depth_q.data_ptr(), r, kmax, tiles_x, tile_lo, depth_bits, kb,
          max_slots, keys.data_ptr(), gidk.data_ptr())
    return keys, gidk


def _tier_launch(rows: TierRows, row_counts, offsets, max_slots: int,
                 keys, gidk) -> None:
    """One launch of the tier stage: the count into row_counts, or (None)
    the emit into keys and gidk."""
    params, tiers = rows.params, rows.tiers
    _check_params(params)
    n, dev = params.shape[1], params.device
    kinds = [t[0] for t in tiers]
    num_base = sum(k != TIER_JUMBO for k in kinds)
    if not 1 <= len(tiers) <= MAX_TIERS or TIER_JUMBO in kinds[:num_base]:
        raise ValueError(f"cull tier: 1 to {MAX_TIERS} tiers, the jumbo "
                         f"tiers last; got kinds {kinds}")
    kmax = rows.compact_k.shape[1]
    checks = [("depth_q", rows.depth_q, torch.int64, (n,)),
              ("counts", rows.counts, torch.int32, (n,)),
              ("compact_k", rows.compact_k, torch.int32, (n, kmax))]
    ranked = {TIER_DENSE: n, TIER_POOL: 0, TIER_JUMBO: 0}
    if rows.ids_pool is not None:
        checks.append(("ids_pool", rows.ids_pool, torch.int64, (None,)))
        ranked[TIER_POOL] = rows.ids_pool.numel()
    jumbo = 0
    if rows.ids_r is not None:
        j, jumbo = rows.maskj.shape
        checks += [("ids_r", rows.ids_r, torch.int64, (j,)),
                   ("maskj", rows.maskj, torch.bool, (j, jumbo)),
                   ("krank", rows.krank, torch.int32, (j, jumbo))]
        ranked[TIER_JUMBO] = j
    if offsets is not None:
        checks.append(("offsets", offsets, torch.int32,
                       (sum(t[3] for t in tiers),)))
    for name, t, dtype, shape in checks:
        _build.expect(t, f"cull tier: {name}", dtype=dtype, shape=shape,
                      device=dev)
    for kind, _, _, n_rows in tiers:
        if n_rows > ranked[kind]:
            raise ValueError(f"cull tier: a tier of kind {kind} has {n_rows} "
                             f"rows, its ranking {ranked[kind]}")
    starts = [0]
    for t in tiers:
        starts.append(starts[-1] + t[3])
    table = (ctypes.c_int64 * (4 * len(tiers) + 1))(
        *starts, *(t[1] for t in tiers), *(t[2] for t in tiers), *kinds)
    tile_lo, tile_hi = rows.band or (0, 0)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    _TIER(dev, ctypes.addressof(table), len(tiers), num_base,
          params.data_ptr(), n, rows.depth_q.data_ptr(),
          rows.counts.data_ptr(), rows.compact_k.data_ptr(), kmax,
          ptr(rows.ids_pool), ptr(rows.ids_r), ptr(rows.maskj),
          ptr(rows.krank), jumbo, rows.tiles_x, int(rows.band is not None),
          tile_lo, tile_hi, rows.depth_bits, rows.kb, ptr(row_counts),
          ptr(offsets), max_slots, ptr(keys), ptr(gidk),
          count="K3.tier_count" if row_counts is not None else "K3.tier_emit")


def cull_tier_count_cuda(rows: TierRows) -> torch.Tensor:
    """The tier count stage: (rows,) int32 kept lanes a row."""
    row_counts = torch.empty((sum(t[3] for t in rows.tiers),),
                             dtype=torch.int32, device=rows.device)
    _tier_launch(rows, row_counts, None, 0, None, None)
    return row_counts


def cull_tier_emit_cuda(rows: TierRows, offsets: torch.Tensor,
                        max_slots: int, sentinel: int):
    """The tier emit stage: the rows' offsets -> (keys, gidk)."""
    dev = rows.device
    keys = torch.full((max_slots,), sentinel, dtype=torch.int64, device=dev)
    gidk = torch.full((max_slots,), -1, dtype=torch.int32, device=dev)
    _tier_launch(rows, None, offsets, max_slots, keys, gidk)
    return keys, gidk


def _dispatch(plain, cuda, params, *args):
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor (params: the rows of parameters, or a `TierRows`)."""
    if params.device.type == "cpu":
        return plain(params, *args)
    if params.device.type == "cuda":
        return cuda(params, *args)
    raise ValueError(f"cull: unsupported device {params.device}")


def cull_mask_from_params(params: torch.Tensor, kmax: int,
                          tile_size: int) -> torch.Tensor:
    """(10, R) rows -> (R, kmax) bool mask."""
    return _dispatch(cull_mask_plain, cull_mask_cuda, params, kmax, tile_size)


def cull_compact_from_params(params: torch.Tensor, kmax: int, tile_size: int):
    """(10, R) rows -> (compact_k (R, kmax) int32, counts (R,) int32)."""
    return _dispatch(cull_compact_plain, cull_compact_cuda, params, kmax,
                     tile_size)


def cull_rank_from_params(params: torch.Tensor, kmax: int, tile_size: int):
    """(10, R) rows -> (mask, krank (R, kmax) int32, counts (R,) int32)."""
    return _dispatch(cull_rank_plain, cull_rank_cuda, params, kmax, tile_size)


def cull_count_from_params(params: torch.Tensor, kmax: int, tile_size: int,
                           cull: bool, tiles_x: int, tile_lo: int,
                           tile_hi: int):
    """(10, R) rows -> (ballots (R, ceil(kmax / 32)) int32, counts (R,)
    int32): the count stage."""
    return _dispatch(cull_count_plain, cull_count_cuda, params, kmax,
                     tile_size, cull, tiles_x, tile_lo, tile_hi)


def cull_emit_from_params(params: torch.Tensor, ballots: torch.Tensor,
                          offsets: torch.Tensor, depth_q: torch.Tensor,
                          kmax: int, tiles_x: int, tile_lo: int,
                          depth_bits: int, kb: int, max_slots: int,
                          sentinel: int):
    """The count stage's ballots -> (keys (max_slots,) int64, gidk
    (max_slots,) int32): the emit stage."""
    return _dispatch(cull_emit_plain, cull_emit_cuda, params, ballots,
                     offsets, depth_q, kmax, tiles_x, tile_lo, depth_bits,
                     kb, max_slots, sentinel)


def cull_tier_count(rows: TierRows) -> torch.Tensor:
    """(rows,) int32 kept lanes of each tier row: the tier count stage."""
    return _dispatch(cull_tier_count_plain, cull_tier_count_cuda, rows)


def cull_tier_emit(rows: TierRows, offsets: torch.Tensor, max_slots: int,
                   sentinel: int):
    """The rows' exclusive offsets -> (keys (max_slots,) int64, gidk
    (max_slots,) int32): the tier emit stage."""
    return _dispatch(cull_tier_emit_plain, cull_tier_emit_cuda, rows,
                     offsets, max_slots, sentinel)


def tile_cull_mask(proj, cfg: RenderConfig) -> torch.Tensor:
    """(N, K_max) bool mask of candidates surviving the exact cull AND the
    rect walk bound (k < counts)."""
    return cull_mask_from_params(
        cull_params(proj, cfg), cfg.max_tiles_per_gaussian, cfg.tile_size
    )
