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
    the second half; no cull, no walk past the kept lanes).

The plain compact and rank versions are the mask followed by the torch ops
the kernel's stage replaces (`compact_from_mask`, `rank_from_mask`); the
plain count and emit are the mask, the band and the scatter written out
(`ballots_from_mask`, `mask_from_ballots`, `walk_tiles`).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.config import RenderConfig
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


def _dispatch(plain, cuda, params, *args):
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
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


def tile_cull_mask(proj, cfg: RenderConfig) -> torch.Tensor:
    """(N, K_max) bool mask of candidates surviving the exact cull AND the
    rect walk bound (k < counts)."""
    return cull_mask_from_params(
        cull_params(proj, cfg), cfg.max_tiles_per_gaussian, cfg.tile_size
    )
