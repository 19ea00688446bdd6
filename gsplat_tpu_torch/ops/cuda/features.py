"""K6, the blend of the colour and of C feature channels per Gaussian
(CUDA kernel `csrc/feat_fwd.cu`), and K7, its backward
(`csrc/feat_bwd.cu`): Feature 3DGS's N-dimensional rasterizer (Zhou et al.
2024, arXiv:2312.03203), for every stream format.

A Gaussian's C features lie in an (N, C) float32 table read by the slot's
Gaussian id; the stream carries the 9 features K1 blends, unwidened. K6
writes K1's per-tile colour and transmittance and the (H, W, C) feature
map; K7 writes the 9 slot gradients K2 writes, as float32, and adds the
feature table's gradient. Their plain versions are K1's and K2's walks
(`ops/raster_torch.py`) over the stream with the slots' feature rows
stacked under it, so CPU tensors take the same path.

`rasterize_features` is the autograd function of the render: the stream
carries no gradient (a packed one cannot), so its backward runs K7 and
the gather backward onto the float32 features in one VJP, as
`raster.rasterize_packed16` does, and sums the feature rows per Gaussian
in K7 (atomic adds on the card, so that sum is not bit for bit the same
from run to run; `index_add_` on the CPU).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.binning import (
    NUM_FEATURES,
    gather_slots_bwd,
    kmax_eff,
)
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import INT, INT64, PTR
from gsplat_tpu_torch.ops.cuda.raster import (
    _BLEND_TYPES,
    _QUANT_TYPES,
    _stream_args,
)
from gsplat_tpu_torch.ops.raster_torch import (
    _image_to_tiles,
    _raster_tiles,
    _raster_tiles_bwd_walk,
    _tiles_to_image,
    _tiles_to_scalar_image,
)
from gsplat_tpu_torch.ops.stream16 import unpack_block

# The entry points, after the stream's arguments, gid and the table: the
# channels, a count of tiles and the image's geometry; K7 takes the
# upstream gradients and the map before the geometry.
_GEOMETRY = [INT, INT, INT, INT, INT, *_BLEND_TYPES, *_QUANT_TYPES]
_K6 = _build.kernel(
    "feat_fwd", "gsplat_feat_fwd",
    [PTR, INT, INT64, PTR, PTR, PTR, INT, INT, *_GEOMETRY, PTR, PTR, PTR],
    "K6")
_K7 = _build.kernel(
    "feat_bwd", "gsplat_feat_bwd",
    [PTR, INT, INT64, PTR, PTR, PTR, INT, INT, PTR, PTR, PTR, PTR,
     *_GEOMETRY, PTR, PTR], "K7")


def _check_table(table, gid, stream) -> None:
    _build.expect(table, "features: the feature table (N, C)",
                  dtype=torch.float32, shape=(None, None),
                  device=stream.device)
    _build.expect(gid, "features: gid (max_I,)", dtype=torch.int32,
                  shape=(stream.shape[1],), device=stream.device)


def feat_fwd_cuda(stream, ranges, gid, table, cfg: RenderConfig):
    """Launch K6: (tile_colors (T, 3, P), tile_trans (T, P), feature map
    (H, W, C))."""
    fmt, *quant = _stream_args(stream, ranges, cfg)
    _check_table(table, gid, stream)
    num_tiles, p = cfg.num_tiles, cfg.pixels_per_tile
    channels = table.shape[1]
    dev = stream.device
    colors = torch.empty((num_tiles, 3, p), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, p), dtype=torch.float32, device=dev)
    fmap = torch.empty((cfg.height, cfg.width, channels), dtype=torch.float32,
                       device=dev)
    _K6(dev, stream.data_ptr(), fmt, stream.shape[1], ranges.data_ptr(),
        gid.data_ptr(), table.data_ptr(), channels, num_tiles, 0,
        cfg.tiles_x, cfg.tile_size, cfg.width, cfg.height, cfg.alpha_clamp,
        cfg.alpha_min, cfg.transmittance_min, *quant, colors.data_ptr(),
        trans.data_ptr(), fmap.data_ptr())
    return colors, trans, fmap


def feat_bwd_cuda(stream, ranges, gid, table, g_colors, b_total, g_fmap,
                  fmap, cfg: RenderConfig):
    """Launch K7: g_colors (T, 3, P) and b_total (T, P), the colour's share
    of K2's inputs, g_fmap the feature map's gradient and fmap the map ->
    (the 9 slot gradients (NUM_FEATURES, max_I) float32, zero on every
    slot no pixel applied; the feature table's gradient (N, C))."""
    fmt, *quant = _stream_args(stream, ranges, cfg)
    _check_table(table, gid, stream)
    num_tiles, p = cfg.num_tiles, cfg.pixels_per_tile
    channels = table.shape[1]
    dev = stream.device
    for name, t, shape in (
            ("g_colors", g_colors, (num_tiles, 3, p)),
            ("b_total", b_total, (num_tiles, p)),
            ("g_fmap", g_fmap, (cfg.height, cfg.width, channels)),
            ("fmap", fmap, (cfg.height, cfg.width, channels))):
        _build.expect(t, f"features: {name}", dtype=torch.float32,
                      shape=shape, device=dev)
    max_i = stream.shape[1]
    dgeo = torch.zeros((NUM_FEATURES, max_i), dtype=torch.float32, device=dev)
    dtable = torch.zeros_like(table)
    _K7(dev, stream.data_ptr(), fmt, max_i, ranges.data_ptr(), gid.data_ptr(),
        table.data_ptr(), channels, num_tiles, g_colors.data_ptr(),
        b_total.data_ptr(), g_fmap.data_ptr(), fmap.data_ptr(), 0,
        cfg.tiles_x, cfg.tile_size, cfg.width, cfg.height, cfg.alpha_clamp,
        cfg.alpha_min, cfg.transmittance_min, *quant, dgeo.data_ptr(),
        dtable.data_ptr())
    return dgeo, dtable


def _stacked(stream, gid, table, cfg: RenderConfig) -> torch.Tensor:
    """The plain walks' stream: the 9 float32 stream features of every slot
    with its Gaussian's C features under them, (NUM_FEATURES + C, max_I)."""
    feats = stream if cfg.stream_format == "f32" else unpack_block(stream, cfg)
    return torch.cat([feats, table.index_select(0, gid.long()).T], 0)


def feat_fwd(stream, ranges, gid, table, cfg: RenderConfig):
    """(tile_colors, tile_trans, feature map) of a stream and the feature
    table: K6 for CUDA tensors, K1's plain walk for CPU ones."""
    if stream.device.type == "cpu":
        tiles, trans, _ = _raster_tiles(_stacked(stream, gid, table, cfg),
                                        ranges, 0, cfg)
        return tiles[:, :3], trans, _tiles_to_image(tiles[:, 3:], cfg)
    return feat_fwd_cuda(stream, ranges, gid, table, cfg)


def feat_bwd(stream, ranges, gid, gidk, table, g_colors, tile_colors,
             g_trans, tile_trans, g_fmap, fmap, cfg: RenderConfig):
    """(the 9 slot gradients (NUM_FEATURES, max_I), the table's gradient
    (N, C)) from the upstream gradients of `feat_fwd`'s outputs: K7 for
    CUDA tensors, K2's plain re-walk over the stacked stream for CPU ones
    (its feature rows summed per Gaussian by `index_add_` over the valid
    slots, gidk >= 0)."""
    b_total = (g_colors * tile_colors).sum(1) + g_trans * tile_trans
    if stream.device.type == "cpu":
        g_all = torch.cat([g_colors, _image_to_tiles(g_fmap, cfg)], 1)
        fmap_tiles = _image_to_tiles(fmap, cfg)
        b_all = b_total + (g_all[:, 3:] * fmap_tiles).sum(1)
        dslot, _ = _raster_tiles_bwd_walk(_stacked(stream, gid, table, cfg),
                                          ranges, 0, g_all, b_all[..., None],
                                          cfg)
        valid = gidk >= 0
        dtable = torch.zeros_like(table).index_add_(
            0, gid.long()[valid], dslot[NUM_FEATURES:, valid].T)
        return dslot[:NUM_FEATURES], dtable
    return feat_bwd_cuda(stream, ranges, gid, table, g_colors.contiguous(),
                         b_total.contiguous(), g_fmap.contiguous(), fmap, cfg)


class _RasterizeFeatures(torch.autograd.Function):
    """Per-tile (colour, final T) and the (H, W, C) feature map of a slot
    stream, differentiable in the float32 features it was gathered from and
    in the feature table. Backward: K7, then the gather backward of the
    9 slot gradients with the config's strategy and read-out (bf16 pairs
    summed by K5, or float32 rows by K4), straight through the stream's
    quantiser."""

    @staticmethod
    def forward(ctx, feats, table, stream, gid, gidk, offsets, counts, ranges,
                cfg):
        tile_colors, tile_trans, fmap = feat_fwd(stream, ranges, gid, table,
                                                 cfg)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(table, stream, gid, gidk, offsets, counts,
                                  ranges, tile_colors, tile_trans, fmap)
            ctx.cfg = cfg
        return tile_colors, tile_trans, fmap

    @staticmethod
    def backward(ctx, g_colors, g_trans, g_fmap):
        (table, stream, gid, gidk, offsets, counts, ranges, tile_colors,
         tile_trans, fmap) = ctx.saved_tensors
        cfg = ctx.cfg
        g_colors = (torch.zeros_like(tile_colors) if g_colors is None
                    else g_colors)
        g_trans = torch.zeros_like(tile_trans) if g_trans is None else g_trans
        g_fmap = torch.zeros_like(fmap) if g_fmap is None else g_fmap
        dslot, dtable = feat_bwd(stream, ranges, gid, gidk, table, g_colors,
                                 tile_colors, g_trans, tile_trans, g_fmap,
                                 fmap, cfg)
        dfeats = gather_slots_bwd(dslot, gidk, offsets, counts, kmax_eff(cfg),
                                  cfg.gather_backward, cfg.grad_readout)
        return dfeats, dtable, None, None, None, None, None, None, None


def rasterize_features(feats, table, stream, binned, cfg: RenderConfig):
    """feats (NUM_FEATURES, N) float32, table (N, C) float32 and `stream`,
    the slot stream of cfg.stream_format gathered from feats in `binned`'s
    slot order -> (image (H, W, 3), trans (H, W), feature map (H, W, C)),
    differentiable in feats and table. Needs the gidk stream (any binning
    but 'scatter')."""
    if binned.sorted_gidk is None:
        raise ValueError("features: binning='scatter' has no gidk stream to "
                         "read the feature rows by")
    tile_colors, tile_trans, fmap = _RasterizeFeatures.apply(
        feats, table, stream, binned.sorted_gid, binned.sorted_gidk,
        binned.gauss_offsets, binned.gauss_counts, binned.ranges, cfg)
    return (_tiles_to_image(tile_colors, cfg),
            _tiles_to_scalar_image(tile_trans, cfg), fmap)
