"""K1, the per-tile forward blend (CUDA kernel `csrc/raster_fwd.cu`), and
K2, its backward (`csrc/raster_bwd.cu`).

K1 replaces `gsplat_tpu/ops/pallas/raster.py::_fwd_kernel`; its plain
PyTorch version is the tiled walk `ops/raster_torch.py::_raster_tiles`. K2
replaces `raster.py::_bwd_kernel`; its plain version is the analytic
re-walk `ops/raster_torch.py::_raster_tiles_bwd_walk`. `rasterize_tiles` is
one `torch.autograd.Function` over the pair: K1 forward and K2 backward on a
CUDA tensor, the two plain walks on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.binning import NUM_FEATURES
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.raster_torch import (
    _raster_tiles,
    _raster_tiles_bwd_walk,
    _tiles_to_image,
    _tiles_to_scalar_image,
)

# Kernel launches: raster_tiles_cuda adds one per launch of K1, nowhere else.
launches = 0
# K2 launches: raster_bwd_cuda adds one per launch, nowhere else.
bwd_launches = 0


def _check_stream(features, ranges, cfg: RenderConfig) -> None:
    if features.device.type != "cuda":
        raise ValueError(f"raster: the kernel needs a CUDA device, got "
                         f"{features.device}")
    if features.dtype != torch.float32 or features.dim() != 2 or \
            features.shape[0] != NUM_FEATURES or not features.is_contiguous():
        raise ValueError(
            "raster: features must be a contiguous (9, max_I) float32 "
            f"tensor, got {tuple(features.shape)} {features.dtype}"
        )
    if ranges.dtype != torch.int32 or ranges.dim() != 1 or \
            not ranges.is_contiguous() or ranges.device != features.device:
        raise ValueError(
            "raster: ranges must be a contiguous (T+1,) int32 tensor on the "
            "features' device"
        )
    if ranges.shape[0] - 1 != cfg.num_tiles:
        raise ValueError("raster: ranges length does not match cfg.num_tiles")


def raster_tiles_cuda(features, ranges, cfg: RenderConfig, tile_offset=0):
    """Launch K1: (tile_colors (T, 3, P), tile_trans (T, P))."""
    global launches
    _check_stream(features, ranges, cfg)
    num_tiles = ranges.shape[0] - 1
    p = cfg.pixels_per_tile
    colors = torch.empty((num_tiles, 3, p), dtype=torch.float32,
                         device=features.device)
    trans = torch.empty((num_tiles, p), dtype=torch.float32,
                        device=features.device)
    fn = _build.load("raster_fwd").gsplat_raster_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = fn(
            features.data_ptr(), features.shape[1], ranges.data_ptr(),
            num_tiles, int(tile_offset), cfg.tiles_x, cfg.tile_size,
            cfg.alpha_clamp, cfg.alpha_min, cfg.transmittance_min,
            colors.data_ptr(), trans.data_ptr(), stream,
        )
    _build.check(err, "gsplat_raster_fwd")
    launches += 1
    return colors, trans


def raster_bwd_cuda(features, ranges, g_color_tiles, b_total_tiles,
                    cfg: RenderConfig, tile_offset=0):
    """Launch K2: g_color_tiles (T, 3, P) and b_total_tiles (T, P) ->
    dfeat (NUM_FEATURES, max_I), zero on every slot no pixel applied."""
    global bwd_launches
    _check_stream(features, ranges, cfg)
    num_tiles = ranges.shape[0] - 1
    p = cfg.pixels_per_tile
    for name, t, shape in (("g_color_tiles", g_color_tiles, (num_tiles, 3, p)),
                           ("b_total_tiles", b_total_tiles, (num_tiles, p))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != features.device:
            raise ValueError(f"raster: {name} must be a contiguous {shape} "
                             f"float32 tensor on the features' device, got "
                             f"{tuple(t.shape)} {t.dtype}")
    # Zero-filled: slots after a tile's early exit and the invalid tail past
    # ranges[T] are never written, and reach real Gaussians through the
    # gather backward's sort if they hold anything but 0.
    dfeat = torch.zeros_like(features)
    fn = _build.load("raster_bwd").gsplat_raster_bwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = fn(
            features.data_ptr(), features.shape[1], ranges.data_ptr(),
            num_tiles, g_color_tiles.data_ptr(), b_total_tiles.data_ptr(),
            int(tile_offset), cfg.tiles_x, cfg.tile_size, cfg.alpha_clamp,
            cfg.alpha_min, cfg.transmittance_min, dfeat.data_ptr(), stream,
        )
    _build.check(err, "gsplat_raster_bwd")
    bwd_launches += 1
    return dfeat


class _RasterizeTiles(torch.autograd.Function):
    """Per-tile (colour, final T) of the sorted stream, with the analytic
    backward: b_total = sum_c g_colour * colour + g_T * T per pixel, formed
    from the forward's own outputs, feeds K2 (or the plain re-walk)."""

    @staticmethod
    def forward(ctx, features, ranges, cfg, tile_offset):
        if features.device.type == "cpu":
            tile_colors, tile_trans, _ = _raster_tiles(
                features, ranges, tile_offset, cfg
            )
        else:
            tile_colors, tile_trans = raster_tiles_cuda(
                features, ranges, cfg, tile_offset
            )
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(features, ranges, tile_colors, tile_trans)
            ctx.cfg, ctx.tile_offset = cfg, tile_offset
        return tile_colors, tile_trans

    @staticmethod
    def backward(ctx, g_colors, g_trans):
        features, ranges, tile_colors, tile_trans = ctx.saved_tensors
        b_total = (g_colors * tile_colors).sum(1) + g_trans * tile_trans
        if features.device.type == "cpu":
            dfeat, _ = _raster_tiles_bwd_walk(
                features, ranges, ctx.tile_offset, g_colors, b_total[..., None],
                ctx.cfg,
            )
        else:
            dfeat = raster_bwd_cuda(
                features, ranges, g_colors.contiguous(), b_total.contiguous(),
                ctx.cfg, ctx.tile_offset,
            )
        return dfeat, None, None, None


def rasterize_tiles(features, ranges, cfg: RenderConfig, tile_offset=0):
    """(features (9, max_I), ranges (T+1,)) -> (image (H, W, 3), trans
    (H, W)), differentiable in `features`: K1 and K2 for CUDA tensors, the
    plain walks for CPU tensors."""
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster: unsupported device {features.device}")
    tile_colors, tile_trans = _RasterizeTiles.apply(
        features, ranges, cfg, tile_offset
    )
    return _tiles_to_image(tile_colors, cfg), _tiles_to_scalar_image(tile_trans, cfg)
