"""K1, the per-tile forward blend: CUDA kernel `csrc/raster_fwd.cu`.

Replaces `gsplat_tpu/ops/pallas/raster.py::_fwd_kernel`. Its plain PyTorch
version is the tiled walk `ops/raster_torch.py::_raster_tiles`.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.binning import NUM_FEATURES
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.raster_torch import (
    _raster_tiles,
    _tiles_to_image,
    _tiles_to_scalar_image,
)

# Kernel launches: raster_tiles_cuda adds one per launch, nowhere else.
launches = 0


def raster_tiles_cuda(features, ranges, cfg: RenderConfig, tile_offset=0):
    """Launch the kernel: (tile_colors (T, 3, P), tile_trans (T, P))."""
    global launches
    num_tiles = ranges.shape[0] - 1
    p = cfg.pixels_per_tile
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
    if num_tiles != cfg.num_tiles:
        raise ValueError("raster: ranges length does not match cfg.num_tiles")
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


def rasterize_tiles(features, ranges, cfg: RenderConfig, tile_offset=0):
    """(features (9, max_I), ranges (T+1,)) -> (image (H, W, 3), trans
    (H, W)): the CUDA kernel for CUDA tensors, the plain walk for CPU
    tensors."""
    if features.device.type == "cpu":
        tile_colors, tile_trans, _ = _raster_tiles(
            features, ranges, tile_offset, cfg
        )
    elif features.device.type == "cuda":
        tile_colors, tile_trans = raster_tiles_cuda(
            features, ranges, cfg, tile_offset
        )
    else:
        raise ValueError(f"raster: unsupported device {features.device}")
    return _tiles_to_image(tile_colors, cfg), _tiles_to_scalar_image(tile_trans, cfg)
