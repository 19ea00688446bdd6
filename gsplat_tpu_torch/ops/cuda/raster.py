"""K1, the per-tile forward blend (CUDA kernel `csrc/raster_fwd.cu`), and
K2, its backward (`csrc/raster_bwd.cu`), for the float32 stream and the
packed int32 streams of `ops/stream16.py`.

K1 replaces `gsplat_tpu/ops/pallas/raster.py::_fwd_kernel`; its plain
PyTorch version is the tiled walk `ops/raster_torch.py::_raster_tiles`, fed
`stream16.unpack_block` of a packed stream. K2 replaces
`raster.py::_bwd_kernel`; its plain version is the analytic re-walk
`ops/raster_torch.py::_raster_tiles_bwd_walk`, followed by
`bf16_pairs.pack_bf16_pairs` where K2 writes bf16 pairs.

Two `torch.autograd.Function`s use them: `rasterize_tiles` over the float32
stream (K1 forward, K2 backward; the gather backward is a separate VJP), and
`rasterize_packed16` over a packed stream, the port of
`gsplat_tpu.ops.stream16.rasterize_packed16`: an int32 stream carries no
gradient, so its backward runs K2 and the gather backward in one VJP,
straight through onto the float32 features. Both take the kernels for CUDA
tensors and the plain walks for CPU tensors.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs
from gsplat_tpu_torch.ops.binning import (
    NUM_FEATURES,
    gather_slots_bwd,
    kmax_eff,
)
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import FLOAT, INT, INT64, PTR
from gsplat_tpu_torch.ops.raster_torch import (
    _raster_tiles,
    _raster_tiles_bwd_walk,
    _tiles_to_image,
    _tiles_to_scalar_image,
)
from gsplat_tpu_torch.ops.stream16 import (
    PACKED4_COLOR_RANGE,
    STREAM_ROWS,
    quant_params,
    unpack_block,
)

# The `fmt` argument of the kernels (csrc/blend.cuh, StreamFormat).
_FORMATS = {"f32": 0, "packed16": 1, "packed4": 2}
# Rows of K2's bf16-pair output: the 9 gradients, padded to 10, in pairs.
GRAD_PAIRS = (NUM_FEATURES + 1) // 2


def packs_grads(cfg: RenderConfig) -> bool:
    """K2 writes its slot gradients as bf16 pairs: on a packed stream with
    gather_backward='bf16' (the TPU kernel's `_pack_grads`)."""
    return cfg.stream_format != "f32" and cfg.gather_backward == "bf16"


def _stream_args(stream, ranges, cfg: RenderConfig) -> list:
    """Check the stream against the format of cfg; the kernels' format and
    dequantisation arguments."""
    fmt = cfg.stream_format
    rows, dtype = ((NUM_FEATURES, torch.float32) if fmt == "f32"
                   else (STREAM_ROWS[fmt], torch.int32))
    _build.expect(stream, f"raster: a {fmt!r} stream", dtype=dtype,
                  shape=(rows, None))
    _build.expect(ranges, "raster: ranges (cfg.num_tiles + 1)",
                  dtype=torch.int32, shape=(cfg.num_tiles + 1,),
                  device=stream.device)
    lox, sx, loy, sy = quant_params(cfg)
    s = PACKED4_COLOR_RANGE
    return [_FORMATS[fmt], lox, 1.0 / sx, loy, 1.0 / sy, s / 2047.0,
            s / 1023.0]


# The entry points; K1 counts as "K1" or "K1.packed", K2 as "K2" or
# "K2.packed".
_QUANT_TYPES = [FLOAT] * 6
_BLEND_TYPES = [FLOAT] * 3
_FWD = _build.kernel(
    "raster_fwd", "gsplat_raster_fwd",
    [PTR, INT, INT64, PTR, INT, INT, INT, INT, *_BLEND_TYPES, *_QUANT_TYPES,
     PTR, PTR], None)
_BWD = _build.kernel(
    "raster_bwd", "gsplat_raster_bwd",
    [PTR, INT, INT64, PTR, INT, PTR, PTR, INT, INT, INT, *_BLEND_TYPES,
     *_QUANT_TYPES, INT, PTR], None)
_PIXELS_PER_THREAD = _build.query("raster_fwd",
                                  "gsplat_raster_pixels_per_thread")


def raster_tiles_cuda(stream, ranges, cfg: RenderConfig, tile_offset=0):
    """Launch K1 on a stream of cfg.stream_format: (tile_colors (T, 3, P),
    tile_trans (T, P))."""
    fmt, *quant = _stream_args(stream, ranges, cfg)
    num_tiles = ranges.shape[0] - 1
    p = cfg.pixels_per_tile
    colors = torch.empty((num_tiles, 3, p), dtype=torch.float32,
                         device=stream.device)
    trans = torch.empty((num_tiles, p), dtype=torch.float32,
                        device=stream.device)
    _FWD(stream.device, stream.data_ptr(), fmt, stream.shape[1],
         ranges.data_ptr(), num_tiles, int(tile_offset), cfg.tiles_x,
         cfg.tile_size, cfg.alpha_clamp, cfg.alpha_min,
         cfg.transmittance_min, *quant, colors.data_ptr(), trans.data_ptr(),
         count="K1.packed" if fmt else "K1")
    return colors, trans


def raster_bwd_cuda(stream, ranges, g_color_tiles, b_total_tiles,
                    cfg: RenderConfig, tile_offset=0, pack_out=False):
    """Launch K2: g_color_tiles (T, 3, P) and b_total_tiles (T, P) -> the
    slot gradients, zero on every slot no pixel applied: (NUM_FEATURES,
    max_I) float32, or with pack_out (GRAD_PAIRS, max_I) int32 bf16 pairs
    (a packed stream only)."""
    fmt, *quant = _stream_args(stream, ranges, cfg)
    if pack_out and not fmt:
        raise ValueError("raster: bf16-pair gradients need a packed stream")
    num_tiles = ranges.shape[0] - 1
    p = cfg.pixels_per_tile
    for name, t, shape in (("g_color_tiles", g_color_tiles, (num_tiles, 3, p)),
                           ("b_total_tiles", b_total_tiles, (num_tiles, p))):
        _build.expect(t, f"raster: {name}", dtype=torch.float32, shape=shape,
                      device=stream.device)
    # Zero-filled: slots after a tile's early exit and the invalid tail past
    # ranges[T] are never written, and reach real Gaussians through the
    # gather backward's sort if they hold anything but 0.
    max_i = stream.shape[1]
    dfeat = (torch.zeros((GRAD_PAIRS, max_i), dtype=torch.int32,
                         device=stream.device) if pack_out else
             torch.zeros((NUM_FEATURES, max_i), dtype=torch.float32,
                         device=stream.device))
    _BWD(stream.device, stream.data_ptr(), fmt, max_i, ranges.data_ptr(),
         num_tiles, g_color_tiles.data_ptr(), b_total_tiles.data_ptr(),
         int(tile_offset), cfg.tiles_x, cfg.tile_size, cfg.alpha_clamp,
         cfg.alpha_min, cfg.transmittance_min, *quant, int(pack_out),
         dfeat.data_ptr(), count="K2.packed" if fmt else "K2")
    return dfeat


def pixels_per_thread() -> int:
    """The pixels of one column each thread of K1 and K2 walks
    (csrc/blend.cuh's kPixelsPerThread, read from the build): the rows of a
    warp's strip at tile 32."""
    return _PIXELS_PER_THREAD()


def _check_device(stream) -> None:
    if stream.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster: unsupported device {stream.device}")


def raster_fwd(stream, ranges, cfg: RenderConfig, tile_offset=0):
    """(tile_colors, tile_trans) of a stream of cfg.stream_format: K1 for a
    CUDA tensor, the plain walk (of the unpacked stream) for a CPU one."""
    if stream.device.type == "cpu":
        feats = stream if cfg.stream_format == "f32" else unpack_block(stream, cfg)
        colors, trans, _ = _raster_tiles(feats, ranges, tile_offset, cfg)
        return colors, trans
    return raster_tiles_cuda(stream, ranges, cfg, tile_offset)


def raster_bwd(stream, ranges, g_colors, tile_colors, g_trans, tile_trans,
               cfg: RenderConfig, tile_offset=0, pack_out=False):
    """The slot gradients of `raster_fwd`'s stream from the upstream
    gradients of its outputs: b_total = sum_c g_colour * colour + g_T * T
    per pixel, formed from the forward's own outputs, feeds K2 (or the plain
    re-walk, then the bf16-pair packing where pack_out)."""
    b_total = (g_colors * tile_colors).sum(1) + g_trans * tile_trans
    if stream.device.type == "cpu":
        feats = stream if cfg.stream_format == "f32" else unpack_block(stream, cfg)
        dfeat, _ = _raster_tiles_bwd_walk(feats, ranges, tile_offset,
                                          g_colors, b_total[..., None], cfg)
        return pack_bf16_pairs(dfeat) if pack_out else dfeat
    return raster_bwd_cuda(stream, ranges, g_colors.contiguous(),
                           b_total.contiguous(), cfg, tile_offset, pack_out)


class _RasterizeTiles(torch.autograd.Function):
    """Per-tile (colour, final T) of the float32 stream, differentiable in
    the stream, with the analytic backward K2."""

    @staticmethod
    def forward(ctx, features, ranges, cfg, tile_offset):
        tile_colors, tile_trans = raster_fwd(features, ranges, cfg, tile_offset)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(features, ranges, tile_colors, tile_trans)
            ctx.cfg, ctx.tile_offset = cfg, tile_offset
        return tile_colors, tile_trans

    @staticmethod
    def backward(ctx, g_colors, g_trans):
        features, ranges, tile_colors, tile_trans = ctx.saved_tensors
        dfeat = raster_bwd(features, ranges, g_colors, tile_colors, g_trans,
                           tile_trans, ctx.cfg, ctx.tile_offset)
        return dfeat, None, None, None


def rasterize_tiles(features, ranges, cfg: RenderConfig, tile_offset=0):
    """(features (9, max_I) float32, ranges (T+1,)) -> (image (H, W, 3),
    trans (H, W)), differentiable in `features`: K1 and K2 for CUDA tensors,
    the plain walks for CPU tensors."""
    _check_device(features)
    tile_colors, tile_trans = _RasterizeTiles.apply(
        features, ranges, cfg, tile_offset
    )
    return _tiles_to_image(tile_colors, cfg), _tiles_to_scalar_image(tile_trans, cfg)


class _RasterizePacked16(torch.autograd.Function):
    """Per-tile (colour, final T) of a packed slot stream, differentiable in
    the float32 features it was packed and gathered from. Backward: K2 on the
    packed stream, then the gather backward onto the features, straight
    through the quantiser. With gather_backward='bf16' K2 writes bf16 pairs
    and `gather_slots_bwd` sums them with K5; else its float32 gradients
    go through K4 with the config's read-out."""

    @staticmethod
    def forward(ctx, feats, slots, gidk, offsets, counts, ranges, cfg,
                tile_offset):
        tile_colors, tile_trans = raster_fwd(slots, ranges, cfg, tile_offset)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(slots, gidk, offsets, counts, ranges,
                                  tile_colors, tile_trans)
            ctx.cfg, ctx.tile_offset = cfg, tile_offset
        return tile_colors, tile_trans

    @staticmethod
    def backward(ctx, g_colors, g_trans):
        slots, gidk, offsets, counts, ranges, tile_colors, tile_trans = \
            ctx.saved_tensors
        cfg = ctx.cfg
        dslot = raster_bwd(slots, ranges, g_colors, tile_colors, g_trans,
                           tile_trans, cfg, ctx.tile_offset,
                           pack_out=packs_grads(cfg))
        dfeats = gather_slots_bwd(dslot, gidk, offsets, counts, kmax_eff(cfg),
                                  cfg.gather_backward, cfg.grad_readout)
        return dfeats, None, None, None, None, None, None, None


def rasterize_packed16(feats, slots, binned, cfg: RenderConfig, tile_offset=0):
    """feats (NUM_FEATURES, N) float32 and slots, the packed stream
    `stream16.gather_packed` made of them in `binned`'s slot order ->
    (image (H, W, 3), trans (H, W)), differentiable in feats. cfg describes
    the rasterized tiles: on the tile-sharded path one band of tile rows
    (`parallel.sharding.local_tile_cfg`, which pins the global quant ranges
    the stream was packed with), whose first tile is tile_offset of the
    global grid; the JAX function's `lcfg`."""
    _check_device(slots)
    tile_colors, tile_trans = _RasterizePacked16.apply(
        feats, slots, binned.sorted_gidk, binned.gauss_offsets,
        binned.gauss_counts, binned.ranges, cfg, tile_offset,
    )
    return _tiles_to_image(tile_colors, cfg), _tiles_to_scalar_image(tile_trans, cfg)
