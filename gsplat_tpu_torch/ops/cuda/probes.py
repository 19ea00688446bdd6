"""The four cost probes of `scripts/micro_kernel_costs.py` as CUDA kernels,
with their plain PyTorch versions (launches counted as "P1".."P4"):

- P1 `csrc/probe_transc.cu` replaces `_transc_kernel` (`:37`): an
  elementwise pass shaped like the blend's inner loop, with exact
  exp / log1p, multiplies only, or the bit-trick polynomials `fast_exp` and
  `fast_log1p_neg` (`:62`, `:76`);
- P2 `csrc/probe_tricumsum.cu` replaces `_cumsum_kernel` (`:117`): the
  running sum x @ tri along a 128-wide last axis (tri = `make_triangular`),
  on the tensor cores in 1, 3 or 6 bf16 passes, the TPU's DEFAULT, HIGH and
  HIGHEST precisions;
- P3 `csrc/probe_gather.cu` replaces the lane gather `k` of `bench_gather`
  (`:156`): take_along_axis from a table held in fast memory;
- P4 `csrc/probe_coldma.cu` replaces `percol_kernel_wrap` of `bench_dma`
  (`:213`): one copy per column, out[i, :, j] = table[:, idx[i, j]].

P3 and P4 take any int32 index and give what the TPU kernels give for it
(Pallas in interpret mode, `tests/test_torch_probes.py`), in both routes:
- P3 (`jnp.take_along_axis`): an index j in [-C, 0) reads column j + C, one
  in [0, C) column j, and any other gives NaN (the quiet NaN 0x7fc00000);
- P4 (`pl.ds(idx, 1)`): a negative index wraps once, to idx + n (in 64
  bits), and is then clamped into [0, n - 1]; no index gives NaN.

Each dispatcher (`transc`, `tri_cumsum`, `lane_gather`, `column_copy`) runs
the plain version for a CPU tensor and launches the kernel for a CUDA
tensor; the `*_cuda` wrappers take CUDA tensors only.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import INT, INT64, PTR

# P1's modes, in the order of the TPU script; the value is the kernel's
# `mode` argument (csrc/probe_transc.cu, Mode).
TRANSC_MODES = {"mults": 0, "exact": 1, "exact3": 2, "fast3": 3}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# P2: the bf16 passes of each precision as (x part, tri part) indices into
# the split (0 hi, 1 mid, 2 lo; `high` splits two ways, so its part 1 is
# the rounded rest x - hi), smallest terms first. csrc/probe_tricumsum.cu
# issues the same passes in the same order.
PASSES = {
    "default": ((0, 0),),
    "high": ((0, 1), (1, 0), (0, 0)),
    "highest": ((0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0)),
}
# The width of P2's last axis: the TPU script's G, one 128x128 tri.
TRI_WIDTH = 128
# P3 stages one row of its table in shared memory, without the opt-in
# above 48 KB: at most GATHER_MAX_COLS floats (csrc/probe_gather.cu).
GATHER_MAX_COLS = 12 * 1024
# The quiet NaN that P3 gives for an index outside [-C, C).
QNAN_BITS = 0x7FC00000


# ---------------------------------------------------------------- plain P1

def fast_exp(x):
    """exp(x) for x <= 0: exp2 split into an exponent and a cubic of the
    fraction, in the operation order of micro_kernel_costs.py:62-73."""
    y = torch.clamp_min(x * LOG2E, -125.0)
    yi = torch.floor(y)
    yf = y - yi
    p = 1.0 + yf * (0.6951937 + yf * (0.2285243 + yf * 0.0782680))
    ex = ((yi.to(torch.int32) + 127) << 23).view(torch.float32)
    return ex * p


def fast_log1p_neg(a):
    """log1p(-a) for a in [0, 0.995]: exponent and mantissa of u = 1 - a
    and a quartic of the mantissa, in the operation order of
    micro_kernel_costs.py:76-88."""
    u = torch.clamp_min(1.0 - a, 1e-30)
    bits = u.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x7FFFFF) | (127 << 23)).view(torch.float32)
    t = m - 1.0
    lm = t * (1.4426950 + t * (-0.7181451 + t * (0.4546480 + t * -0.2775329)))
    return (e.to(torch.float32) + lm) * LN2


def transc_plain(x, mode: str):
    """P1's plain version: micro_kernel_costs.py:37-56 for one mode."""
    if mode == "exact":
        e = torch.exp(x)
        return e + torch.log1p(-0.5 * e)
    if mode == "exact3":
        e = torch.exp(x)
        return torch.exp(torch.log1p(-0.5 * e)) + e
    if mode == "mults":
        e = x * x + x
        l = 1.0 - 0.5 * e
        return e + l * l
    if mode == "fast3":
        e = fast_exp(x)
        return fast_exp(fast_log1p_neg(0.5 * e)) + e
    raise ValueError(f"transc: mode must be one of {tuple(TRANSC_MODES)}, "
                     f"got {mode!r}")


# ---------------------------------------------------------------- plain P2

def make_triangular(g: int, dtype=torch.float32, device=None):
    """tri[j, i] = 1 if j <= i, so (x @ tri)[p, i] = sum_{j<=i} x[p, j]
    (the port's copy of gsplat_tpu.ops.blend.make_triangular)."""
    idx = torch.arange(g, device=device)
    return (idx[:, None] <= idx[None, :]).to(dtype)


def bf16_split(x, parts: int) -> list:
    """x as `parts` bf16 values (held in float32) whose sum approximates it:
    each part is the rest so far rounded to bf16 to nearest even; the rests
    are exact in float32."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def tricumsum_plain(x, tri, precision: str):
    """P2's plain version: x @ tri as the TPU computes it at `precision`,
    the float32 products of bf16 parts summed smallest first (PASSES).
    tri is 0/1, so its parts below hi are exactly 0; the definition keeps
    them. On the card it needs torch.backends.cuda.matmul.allow_tf32 off."""
    if precision not in PASSES:
        raise ValueError(f"tri_cumsum: precision must be one of "
                         f"{tuple(PASSES)}, got {precision!r}")
    passes = PASSES[precision]
    parts = 1 + max(max(p) for p in passes)
    xs, ts = bf16_split(x, parts), bf16_split(tri, parts)
    out = None
    for i, j in passes:
        prod = torch.matmul(xs[i], ts[j])
        out = prod if out is None else out + prod
    return out


# ------------------------------------------------------------- plain P3, P4

def lane_gather_plain(tab, idx):
    """P3's plain version: out[r, c] = tab[r, j] for j = idx[r, c], read at
    j + C where j is in [-C, 0), and the quiet NaN where j is outside
    [-C, C). take_along_dim only sees indices clamped into range: its own
    out-of-range behaviour differs between the CPU and CUDA."""
    cols = tab.shape[-1]
    j = idx.long()
    j = torch.where(j < 0, j + cols, j)
    ok = (j >= 0) & (j < cols)
    got = torch.take_along_dim(tab, j.clamp(0, cols - 1), dim=-1)
    nan = torch.tensor(QNAN_BITS, dtype=torch.int32,
                       device=tab.device).view(torch.float32)
    return torch.where(ok, got, nan)


def column_copy_plain(table, idx):
    """P4's plain version: out[i, r, j] = table[r, c], (B, F, G), where
    c = idx[i, j] + n if that index is negative, then clamped into
    [0, n - 1]."""
    n = table.shape[1]
    c = idx.long()
    c = torch.where(c < 0, c + n, c).clamp(0, n - 1)
    return table[:, c].permute(1, 0, 2)


# ----------------------------------------------------------------- kernels

_P1 = _build.kernel("probe_transc", "gsplat_probe_transc",
                    [PTR, PTR, INT64, INT], "P1")
_P2 = _build.kernel("probe_tricumsum", "gsplat_probe_tricumsum",
                    [PTR, PTR, INT64, INT], "P2")
_P3 = _build.kernel("probe_gather", "gsplat_probe_gather",
                    [PTR, PTR, PTR, INT, INT], "P3")
_P4 = _build.kernel("probe_coldma", "gsplat_probe_coldma",
                    [PTR, PTR, PTR, INT64, INT, INT64, INT], "P4")


def transc_cuda(x, mode: str):
    """Launch P1: float32 x of any shape (16-byte aligned) -> the mode's
    function of each element."""
    _build.expect(x, "transc: x", dtype=torch.float32)
    if mode not in TRANSC_MODES:
        raise ValueError(f"transc: mode must be one of {tuple(TRANSC_MODES)},"
                         f" got {mode!r}")
    if x.data_ptr() % 16:
        raise ValueError("transc: x must be 16-byte aligned (float4 loads)")
    out = torch.empty_like(x)
    _P1(x.device, x.data_ptr(), out.data_ptr(), x.numel(), TRANSC_MODES[mode])
    return out


def tricumsum_cuda(x, precision: str):
    """Launch P2: float32 x (..., 128) -> x @ make_triangular(128) at
    `precision` (1, 3 or 6 bf16 passes on the tensor cores)."""
    _build.expect(x, "tri_cumsum: x", dtype=torch.float32)
    if x.dim() < 2 or x.shape[-1] != TRI_WIDTH:
        raise ValueError(f"tri_cumsum: x must be (..., {TRI_WIDTH}), got "
                         f"{tuple(x.shape)}")
    if precision not in PASSES:
        raise ValueError(f"tri_cumsum: precision must be one of "
                         f"{tuple(PASSES)}, got {precision!r}")
    out = torch.empty_like(x)
    _P2(x.device, x.data_ptr(), out.data_ptr(), x.numel() // TRI_WIDTH,
        len(PASSES[precision]))
    return out


def lane_gather_cuda(tab, idx):
    """Launch P3: tab (R, C) float32, idx (R, C) int32 -> tab[r, idx[r, c]]
    with lane_gather_plain's index rule, from one CTA per row that holds its
    row in shared memory (C <= GATHER_MAX_COLS)."""
    _build.expect(tab, "lane_gather: tab", dtype=torch.float32,
                  shape=(None, None))
    _build.expect(idx, "lane_gather: idx", dtype=torch.int32,
                  shape=(None, None), device=tab.device)
    if idx.shape != tab.shape or tab.shape[1] > GATHER_MAX_COLS:
        raise ValueError(f"lane_gather: tab and idx must be one (R, C) shape "
                         f"with C <= {GATHER_MAX_COLS}, got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    out = torch.empty_like(tab)
    _P3(tab.device, tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
        tab.shape[0], tab.shape[1])
    return out


def column_copy_cuda(table, idx):
    """Launch P4: table (F, n) float32, idx (B, G) int32 -> (B, F, G) with
    out[i, :, j] = table[:, c] by column_copy_plain's index rule: a thread
    owns 4 columns of a block (one where G % 4 != 0), loads every row of
    them into registers and stores each row as one 16-byte store."""
    _build.expect(table, "column_copy: table", dtype=torch.float32,
                  shape=(None, None))
    _build.expect(idx, "column_copy: idx", dtype=torch.int32,
                  shape=(None, None), device=table.device)
    f, n = table.shape
    b, g = idx.shape
    if n == 0 and idx.numel():
        raise ValueError("column_copy: the table has no column to copy")
    out = torch.empty((b, f, g), dtype=torch.float32, device=table.device)
    _P4(table.device, table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, f,
        b, g)
    return out


# ------------------------------------------------------------- dispatchers

def transc(x, mode: str):
    """P1 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return transc_plain(x, mode)
    if x.device.type == "cuda":
        return transc_cuda(x, mode)
    raise ValueError(f"transc: unsupported device {x.device}")


def tri_cumsum(x, precision: str):
    """x (..., 128) @ make_triangular(128) at `precision`: P2 for a CUDA
    tensor, its plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return tricumsum_plain(x, make_triangular(x.shape[-1]), precision)
    if x.device.type == "cuda":
        return tricumsum_cuda(x, precision)
    raise ValueError(f"tri_cumsum: unsupported device {x.device}")


def lane_gather(tab, idx):
    """P3 for CUDA tensors, its plain version for CPU tensors."""
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx)
    if tab.device.type == "cuda":
        return lane_gather_cuda(tab, idx)
    raise ValueError(f"lane_gather: unsupported device {tab.device}")


def column_copy(table, idx):
    """P4 for CUDA tensors, its plain version for CPU tensors."""
    if table.device.type == "cpu":
        return column_copy_plain(table, idx)
    if table.device.type == "cuda":
        return column_copy_cuda(table, idx)
    raise ValueError(f"column_copy: unsupported device {table.device}")
