"""K3, the exact ellipse-tile cull: CUDA kernel `csrc/cull.cu` and its plain
PyTorch versions, for each of the kernel's three output stages.

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
    counts (`cull_rank_*`: the jumbo grid).

The plain compact and rank versions are the mask followed by the torch ops
the kernel's stage replaces (`compact_from_mask`, `rank_from_mask`).
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.cuda import _build, counters

# Parameter rows of the (NUM_ROWS, N) input.
R_GX, R_GY, R_A, R_B, R_C, R_TAU, R_X0, R_Y0, R_W, R_COUNT = range(10)
NUM_ROWS = 10

# The kernel's `stage` argument (csrc/cull.cu, Stage).
STAGES = {"mask": 0, "compact": 1, "rank": 2}

# Kernel launches, every stage: `_launch` adds one per launch, nowhere else;
# `rank_launches` the same for the rank stage alone (the jumbo grid).
launches = 0
rank_launches = 0
counters.register(__name__, "launches", "rank_launches")


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


def _launch(params: torch.Tensor, kmax: int, tile_size: int, stage: str):
    """Launch the kernel's `stage` on (10, R) rows: its outputs as the
    plain version of that stage returns them."""
    global launches, rank_launches
    if params.device.type != "cuda":
        raise ValueError(f"cull: the kernel needs a CUDA device, got "
                         f"{params.device}")
    if params.dtype != torch.float32 or params.dim() != 2 or \
            params.shape[0] != NUM_ROWS or not params.is_contiguous():
        raise ValueError(
            "cull: params must be a contiguous (10, R) float32 tensor, got "
            f"{tuple(params.shape)} {params.dtype}"
        )
    r, dev = params.shape[1], params.device
    mask = idx = counts = None
    if stage != "compact":
        mask = torch.empty((r, kmax), dtype=torch.bool, device=dev)
    if stage != "mask":
        idx = torch.empty((r, kmax), dtype=torch.int32, device=dev)
        counts = torch.empty((r,), dtype=torch.int32, device=dev)
    lib = _build.load("cull")
    fn = lib.gsplat_cull
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(params.data_ptr(), r, kmax, float(tile_size), STAGES[stage],
                 *(0 if t is None else t.data_ptr()
                   for t in (mask, idx, counts)), stream)
    _build.check(err, "gsplat_cull")
    launches += 1
    rank_launches += stage == "rank"
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


def _dispatch(plain, cuda, params, kmax, tile_size):
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if params.device.type == "cpu":
        return plain(params, kmax, tile_size)
    if params.device.type == "cuda":
        return cuda(params, kmax, tile_size)
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


def tile_cull_mask(proj, cfg: RenderConfig) -> torch.Tensor:
    """(N, K_max) bool mask of candidates surviving the exact cull AND the
    rect walk bound (k < counts)."""
    return cull_mask_from_params(
        cull_params(proj, cfg), cfg.max_tiles_per_gaussian, cfg.tile_size
    )
