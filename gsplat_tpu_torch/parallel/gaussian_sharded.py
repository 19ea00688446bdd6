"""Gaussian-sharded rendering over a mesh of processes (port of
`gsplat_tpu.parallel.gaussian_sharded`): the scene's N axis is sharded, so
no rank holds more than N/D Gaussians.

Every rank owns both a Gaussian shard (N/D splats, its `scene` here) and a
tile shard (a band of tile rows, the partition of the tile-sharded mode).
Per rank:

  1. project its Gaussians, bin and depth-sort them over the global tile
     grid (K3 culls its N/D);
  2. re-space the sorted stream into D blocks of `per_dest_capacity` slots,
     one per destination band (a gather: the stream is already segmented by
     destination, the bands being contiguous);
  3. exchange the blocks with one `all_to_all_single`; each slot carries its
     (local tile, depth) merge key, computed at the source;
  4. merge the D received depth-sorted segments with one key sort over the
     local tiles: per tile the merged stream is depth-ordered, so the blend
     is exact;
  5. blend its band (K1 at tile_offset = band x tiles per band).

Backward: the ordering is a stop-gradient permutation; gradients flow image
-> received slots -> the same all_to_all (the tiled exchange is its own
transpose) -> sent slots -> this rank's Gaussians: every rank ends with the
gradients of exactly its own N/D parameters, and no parameter is reduced.

The wire formats: the f32 feature rows (or, with fragment_format='bf16',
the 5-row packed16 layout forward and bf16 pairs back), or on
stream_format='packed16' the packed stream itself, packed once per shard
(`_P16ShardRaster`, one autograd Function over the exchange, the merge, K1
and K2: an int32 stream carries no gradient). Keys travel as int32 holding
the bits of u32 keys; the port sorts them as int64, and packs the global
grid's depth bits (the JAX package the band's), so that the merge keeps
each source's order among tied depths.
`per_dest_capacity` bounds each (source, destination) segment; a longer one
sets the overflow flag. `render_gaussian_sharded_jit` is the whole per-rank
frame dispatched as one program (a CUDA graph on an NCCL mesh, the
exchange inside; eager on gloo: `utils/graphs.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
from gsplat_tpu_torch.ops.binning import (
    NUM_FEATURES,
    SENTINEL_KEY,
    _align_stream,
    _tile_ranges,
    bin_gaussians,
    check_stream_slots,
    depth_bits_for,
    features_f32,
    gather_features,
    gather_slots_bwd,
    kmax_eff,
    pack_tile_depth_key,
    packed_grad_reduce,
)
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda.raster import (
    packs_grads,
    raster_bwd,
    raster_fwd,
    rasterize_tiles,
)
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.raster_torch import _tiles_to_image, _tiles_to_scalar_image
from gsplat_tpu_torch.ops.stream16 import pack_stream, unpack_block
from gsplat_tpu_torch.parallel.sharding import (
    Mesh,
    all_to_all,
    any_flag,
    gather_rows,
    local_tile_cfg,
)
from gsplat_tpu_torch.render.pipeline import scene_camera_inputs, split_inputs
from gsplat_tpu_torch.utils.graphs import Captured

_INVALID_KEY = 2**31 - 1


def a2a_cols(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The tiled all_to_all of a (rows, D * cap) tensor split along its
    columns: block i of the columns goes to rank i of the axis."""
    d = mesh.size_of(axis)
    rows = x.shape[0]
    blocks = x.reshape(rows, d, -1).transpose(0, 1)
    out = all_to_all(blocks.contiguous(), mesh, axis)
    return out.transpose(0, 1).reshape(rows, -1)


def _key_to_wire(key: torch.Tensor) -> torch.Tensor:
    """int64 key values in [0, 2^32) -> int32 with the same 32 bits."""
    return (key - ((key >> 31) << 32)).to(torch.int32)


def _key_from_wire(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & 0xFFFFFFFF


class _BlocksGather(torch.autograd.Function):
    """feats[:, idx] (idx == M reads zero) whose backward is a gather: the
    block slot of a stream position p follows from its tile (destination
    band) and the destination's segment start."""

    @staticmethod
    def forward(ctx, feats, idx, sorted_tile, seg_start, seg_end, td, cap):
        pad = torch.cat([feats, feats.new_zeros((feats.shape[0], 1))], 1)
        ctx.save_for_backward(sorted_tile, seg_start, seg_end)
        ctx.td, ctx.cap = td, cap
        return pad.index_select(1, idx.to(torch.int64))

    @staticmethod
    def backward(ctx, dblocks):
        sorted_tile, seg_start, seg_end = ctx.saved_tensors
        d = seg_start.shape[0]
        p = torch.arange(sorted_tile.shape[0], device=dblocks.device)
        dest = sorted_tile.to(torch.int64) // ctx.td
        destc = torch.clamp(dest, 0, d - 1)
        within = p - seg_start[destc]
        slot = destc * ctx.cap + within
        ok = ((dest < d) & (within >= 0) & (within < ctx.cap)
              & (p < seg_end[destc]))
        picked = dblocks.index_select(
            1, torch.clamp(slot, 0, dblocks.shape[1] - 1))
        return (torch.where(ok[None, :], picked, 0.0),
                None, None, None, None, None, None)


def _unmerge(dmerged: torch.Tensor, s_perm, present) -> torch.Tensor:
    """The transpose of the injective take by s_perm, without a scatter:
    received slot r's gradient sits at rank(r) of the merged stream sorted by
    received slot id."""
    key = torch.where(s_perm >= 0, s_perm, _INVALID_KEY)
    pos = torch.sort(key, stable=False).indices
    dsorted = dmerged.index_select(1, pos)
    rank = torch.cumsum(present, 0) - 1
    picked = dsorted.index_select(
        1, torch.clamp(rank, 0, dsorted.shape[1] - 1))
    return torch.where(present[None, :], picked, torch.zeros_like(picked))


def _take_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[:, idx] with idx < 0 reading an appended zero column."""
    pad = torch.cat([x, x.new_zeros((x.shape[0], 1))], 1)
    return pad.index_select(
        1, torch.where(idx < 0, x.shape[1], idx).to(torch.int64))


class _PermGather(torch.autograd.Function):
    """recv[:, s_perm] for an injective slot permutation (-1 reads zero),
    with the sort-based transpose of `_unmerge`."""

    @staticmethod
    def forward(ctx, recv, s_perm, present):
        ctx.save_for_backward(s_perm, present)
        return _take_cols(recv, s_perm)

    @staticmethod
    def backward(ctx, dout):
        s_perm, present = ctx.saved_tensors
        return _unmerge(dout, s_perm, present), None, None


class _A2A(torch.autograd.Function):
    """The f32 fragment exchange; its backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return a2a_cols(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return a2a_cols(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _A2AFeaturesBF16(torch.autograd.Function):
    """fragment_format='bf16': the (9, D cap) feature blocks cross the wire
    as the 5 int32 rows of the packed16 layout (means as u16 fixed point
    over the global image), and their gradients as bf16 pairs."""

    @staticmethod
    def forward(ctx, x, mesh, axis, cfg):
        ctx.mesh, ctx.axis = mesh, axis
        recv = a2a_cols(pack_stream(x, cfg), mesh, axis)
        return unpack_block(recv, cfg)

    @staticmethod
    def backward(ctx, g):
        recv = a2a_cols(pack_bf16_pairs(g), ctx.mesh, ctx.axis)
        return unpack_bf16_pairs(recv, g.shape[0]), None, None, None


class _P16ShardRaster(torch.autograd.Function):
    """packed16 exchange, merge and blend as one VJP (port of the JAX
    `_p16_shard_raster`). Forward: pack the shard's features once (global
    quant ranges), take each outgoing block slot's packed column by
    Gaussian id, exchange the 5 int32 rows, take the merge order, and run
    K1 on the merged packed stream at this band's tile offset. Backward:
    K2 on the merged stream (bf16 pairs out with gather_backward='bf16'),
    the merge undone by one sort, the exchange again (int32 lanes pass bit
    for bit), and the received block slots reduced to per-Gaussian
    gradients by the gidk sort and the segmented suffix sum (K5 on pairs,
    K4 on float32)."""

    @staticmethod
    def forward(ctx, feats9, block_gid, gidk_block, offsets, counts, s_perm,
                present, ranges, tile_offset, mesh, axis, src_cfg, lcfg):
        packed = pack_stream(feats9, src_cfg)
        blocks = _take_cols(packed, block_gid)
        recv = a2a_cols(blocks, mesh, axis)
        merged = _take_cols(recv, s_perm).contiguous()
        colors, trans = raster_fwd(merged, ranges, lcfg, tile_offset)
        ctx.save_for_backward(merged, ranges, colors, trans, gidk_block,
                              offsets, counts, s_perm, present)
        ctx.opts = (tile_offset, mesh, axis, src_cfg, lcfg)
        return colors, trans

    @staticmethod
    def backward(ctx, g_colors, g_trans):
        (merged, ranges, colors, trans, gidk_block, offsets, counts, s_perm,
         present) = ctx.saved_tensors
        tile_offset, mesh, axis, src_cfg, lcfg = ctx.opts
        dmerged = raster_bwd(merged, ranges, g_colors.contiguous(), colors,
                             g_trans.contiguous(), trans, lcfg, tile_offset,
                             pack_out=packs_grads(lcfg))
        dblocks = a2a_cols(_unmerge(dmerged, s_perm, present), mesh, axis)
        kmax = kmax_eff(src_cfg)
        if dblocks.dtype == torch.int32:
            key = torch.where(gidk_block >= 0, gidk_block, _INVALID_KEY)
            dfeats = packed_grad_reduce(dblocks, key, offsets, counts, kmax,
                                        NUM_FEATURES)
        else:
            dfeats = gather_slots_bwd(dblocks, gidk_block, offsets, counts,
                                      kmax, src_cfg.gather_backward,
                                      src_cfg.grad_readout)
        return (dfeats,) + (None,) * 12


def _block_layout(ranges_g, num_shards: int, td: int, cap: int):
    """The destination-block slot map of the globally sorted local stream:
    block slot s of destination d = s // cap reads stream position
    src_pos[s]. Returns (seg_start, seg_end, src_pos, valid, overflow)."""
    dev = ranges_g.device
    idx = torch.arange(num_shards, device=dev)
    seg_start = ranges_g[idx * td].to(torch.int64)
    seg_end = ranges_g[(idx + 1) * td].to(torch.int64)
    overflow = (seg_end - seg_start > cap).any()
    s = torch.arange(num_shards * cap, device=dev)
    dest = s // cap
    src_pos = seg_start[dest] + s % cap
    valid = src_pos < seg_end[dest]
    return seg_start, seg_end, src_pos, valid, overflow


def _block_merge_keys(proj, binned, td: int, src_pos, valid, cap: int,
                      n_tiles: int):
    """Per block slot the merge key local_tile << depth_bits | depth_q (the
    value of a u32 key, as int64), SENTINEL_KEY for an empty slot. The
    depth bits are the global grid's (n_tiles), as in every key of the
    port's binning (the JAX package packs the band's here)."""
    m = binned.sorted_tile.shape[0]
    src_c = torch.clamp_max(src_pos, m - 1)
    dest = torch.arange(src_pos.shape[0], device=src_pos.device) // cap
    tile_blocks = torch.where(valid, binned.sorted_tile[src_c] - dest * td, td)
    n = proj.depth.shape[0]
    depth_slots = proj.depth.detach()[torch.clamp(binned.sorted_gid, 0, n - 1)]
    depth_row = torch.where(valid, depth_slots[src_c], 0.0)
    return torch.where(tile_blocks >= td, SENTINEL_KEY,
                       pack_tile_depth_key(tile_blocks, depth_row, n_tiles))


def _merge_order(recv_key, lcfg: RenderConfig, align: int, n_tiles: int):
    """Merge order of the D received depth-sorted fragments from their keys
    (int64 values of u32 keys with the depth bits of a grid of n_tiles):
    (s_perm merged position -> received slot, -1 on padding; present, the
    received slots' validity; ranges (td + 1,); overflow). A stable sort:
    tied keys keep the source order, then each source's stream order.
    Integers only, shared by the f32 and packed16 paths."""
    m = recv_key.shape[0]
    td = lcfg.num_tiles
    s_key, s_perm = torch.sort(recv_key, stable=True)
    s_tile = torch.clamp_max(s_key >> depth_bits_for(n_tiles), td).to(
        torch.int32)
    s_perm = torch.where(s_tile < td, s_perm, -1).to(torch.int32)
    ranges = _tile_ranges(s_tile, td)
    overflow = torch.zeros((), dtype=torch.bool, device=recv_key.device)
    if align > 1:
        s_tile, s_perm, ranges, total_padded = _align_stream(
            s_tile, s_perm, ranges, m, td, align)
        overflow = total_padded > m
    return s_perm, recv_key != SENTINEL_KEY, ranges, overflow


def _src_cfg_for(cfg: RenderConfig) -> RenderConfig:
    """The per-source binning config: no alignment (that comes after the
    exchange) and the one-key sort ('tiered' or 'packed'), so that each
    tile's order is the quantized order the merge sort uses."""
    return dataclasses.replace(
        cfg, binning="tiered" if cfg.binning == "tiered" else "packed",
        stream_align=1)


def _shard_render(scene, camera, cfg: RenderConfig, src_cfg: RenderConfig,
                  lcfg: RenderConfig, mesh: Mesh, axis: str, cap: int,
                  align: int, uv_tap=None):
    """One rank's forward: local projection and sort, the fragment
    exchange, the merge, the band's blend. Returns (image band, trans band,
    overflow of this rank, visible (N_local,) bool)."""
    d = mesh.size_of(axis)
    td = lcfg.num_tiles
    check_stream_slots(d * cap, "the merged stream (D x per_dest_capacity)")
    if cfg.stream_format == "packed4":
        raise ValueError(
            "the Gaussian-sharded fragment-exchange wire format is the "
            "5-row packed16 stream (or f32); use stream_format='packed16' "
            "on this path"
        )
    proj = project_gaussians(scene, camera, src_cfg, uv_tap=uv_tap)
    with torch.no_grad():
        binned = bin_gaussians(proj, src_cfg)
        seg_start, seg_end, src_pos, valid, ovf = _block_layout(
            binned.ranges, d, td, cap)
        key_blocks = _block_merge_keys(proj, binned, td, src_pos, valid, cap,
                                       cfg.num_tiles)
        recv_key = _key_from_wire(all_to_all(_key_to_wire(key_blocks), mesh,
                                             axis))
        s_perm, present, ranges, merge_ovf = _merge_order(
            recv_key, lcfg, align, cfg.num_tiles)
    tile_offset = mesh.index(axis) * td
    if cfg.stream_format == "packed16":
        feats9 = features_f32(proj, src_cfg)
        with torch.no_grad():
            src_c = torch.clamp_max(src_pos, binned.sorted_gid.shape[0] - 1)
            g = binned.sorted_gid[src_c]
            block_gid = torch.where(valid & (g >= 0), g, -1)
            gidk_block = torch.where(valid, binned.sorted_gidk[src_c], -1)
        colors, trans = _P16ShardRaster.apply(
            feats9, block_gid, gidk_block, binned.gauss_offsets,
            binned.gauss_counts, s_perm, present, ranges, tile_offset, mesh,
            axis, src_cfg, lcfg)
        image = _tiles_to_image(colors, lcfg)
        trans = _tiles_to_scalar_image(trans, lcfg)
    else:
        feats = gather_features(proj, binned, src_cfg)
        idx = torch.where(valid, src_pos, feats.shape[1])
        blocks = _BlocksGather.apply(feats, idx, binned.sorted_tile,
                                     seg_start, seg_end, td, cap)
        if cfg.fragment_format == "bf16":
            recv = _A2AFeaturesBF16.apply(blocks, mesh, axis, cfg)
        else:
            recv = _A2A.apply(blocks, mesh, axis)
        merged = _PermGather.apply(recv, s_perm, present)
        image, trans = rasterize_tiles(merged.contiguous(), ranges, lcfg,
                                       tile_offset)
    ovf = ovf | binned.overflow | merge_ovf
    return image, trans, ovf, proj.counts > 0


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "gauss"):
    """This rank's rows of a (C, ...) tensor sharded over the axis."""
    d = mesh.size_of(axis)
    if x.shape[0] % d:
        raise ValueError(f"capacity {x.shape[0]} not divisible by {d} "
                         "shards; pad_to")
    n = x.shape[0] // d
    k = mesh.index(axis)
    return x[k * n:(k + 1) * n]


def shard_scene(scene: GaussianScene, mesh: Mesh,
                axis: str = "gauss") -> GaussianScene:
    """This rank's Gaussian shard of a whole scene (its capacity must divide
    by the axis: `GaussianScene.pad_to`), as fresh tensors."""
    return GaussianScene(**{
        f.name: shard_rows(getattr(scene, f.name), mesh, axis).detach().clone()
        for f in dataclasses.fields(scene)})


def fragment_occupancy(scene: GaussianScene, camera: Camera,
                       cfg: RenderConfig, num_shards: int,
                       per_dest_capacity: int | None = None) -> dict:
    """Capacity report of the fragment exchange for a whole scene and a
    camera: the (source, destination) segment lengths against
    `per_dest_capacity`. Host-side, in one process: each source shard is
    binned in turn, so it also sizes meshes larger than the cards at hand.

    Returns {"per_dest_capacity", "max_segment",
    "suggested_per_dest_capacity" (1.15x the max), "occupancy" (max /
    capacity), "total_intersections", "overflow", "segment_quantiles",
    "per_dest_totals"}, the JAX function's dict."""
    d = num_shards
    c = scene.num_gaussians
    if c % d != 0:
        raise ValueError(f"capacity {c} not divisible by {d} shards")
    n_local = c // d
    src_cfg = _src_cfg_for(cfg)
    td = local_tile_cfg(cfg, d).num_tiles
    seg = np.zeros((d, d), np.int64)
    idx = np.arange(d)
    for s in range(d):
        part = GaussianScene(**{
            f.name: getattr(scene, f.name)[s * n_local:(s + 1) * n_local]
            for f in dataclasses.fields(scene)})
        with torch.no_grad():
            proj = project_gaussians(part, camera, src_cfg)
            r = bin_gaussians(proj, src_cfg).ranges.cpu().numpy()
        seg[s] = r[(idx + 1) * td] - r[idx * td]
    cap = per_dest_capacity or max(cfg.max_intersections // d, 1)
    mx = int(seg.max())
    return {
        "per_dest_capacity": cap,
        "max_segment": mx,
        "suggested_per_dest_capacity": int(mx * 1.15),
        "occupancy": round(mx / cap, 4),
        "total_intersections": int(seg.sum()),
        "overflow": bool(mx > cap),
        "segment_quantiles": {
            str(q): int(np.quantile(seg, q)) for q in (0.5, 0.9, 1.0)
        },
        "per_dest_totals": seg.sum(axis=0).tolist(),
    }


def exchange_bytes(cfg: RenderConfig, d: int, cap: int) -> dict:
    """Bytes of the fragment exchange of one view over all D ranks, as the
    JAX bench counts them (4-byte lanes): forward the payload rows plus the
    merge-key row, backward the gradient rows."""
    compressed = (cfg.stream_format == "packed16"
                  or cfg.fragment_format == "bf16")
    rows_fwd = (5 if compressed else NUM_FEATURES) + 1
    rows_bwd = 5 if compressed else NUM_FEATURES
    return {"fwd": d * rows_fwd * d * cap * 4, "bwd": d * rows_bwd * d * cap * 4}


def render_gaussian_sharded(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    axis_name: str = "gauss",
    per_dest_capacity: int | None = None,
    background: torch.Tensor | None = None,
):
    """Render with the scene's N axis sharded over `mesh`'s axis: `scene` is
    this rank's shard (`shard_scene`), the camera the same on every rank.
    Every rank gets the whole (image (H, W, 3), transmittance (H, W),
    overflow ()), the bands gathered. Differentiable in the shard: with the
    same loss of the whole image on every rank, each rank's backward leaves
    the complete gradients of its own Gaussians."""
    d = mesh.size_of(axis_name)
    lcfg = local_tile_cfg(cfg, d)
    cap = per_dest_capacity or max(cfg.max_intersections // d, 1)
    image, trans, ovf, _ = _shard_render(
        scene, camera, cfg, _src_cfg_for(cfg), lcfg, mesh, axis_name, cap,
        cfg.stream_align or 1)
    ovf = any_flag(ovf, mesh, axis_name)
    img = gather_rows(image, mesh, axis_name)[: cfg.height, : cfg.width]
    trans = gather_rows(trans, mesh, axis_name)[: cfg.height, : cfg.width]
    if background is not None:
        img = img + trans[..., None] * background
    return img, trans, ovf


# The captured Gaussian-sharded frames, keyed by config, axis, capacity and
# shapes.
GAUSSIAN_SHARDED_GRAPHS = Captured("render_gaussian_sharded")


def render_gaussian_sharded_jit(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    axis_name: str = "gauss",
    per_dest_capacity: int | None = None,
    background: torch.Tensor | None = None,
):
    """`render_gaussian_sharded` dispatched as one program per rank, as the
    JAX bench jits it: projection and binning of the shard (K3), the
    fragment exchange (`all_to_all_single`), the merge, the band's blend
    (K1 at its tile offset), the overflow flag and the gather of the bands.
    A CUDA graph on an NCCL mesh on the card, captured on the first call
    for (cfg, axis, capacity, input shapes) and replayed after; the same
    body eagerly on gloo and on the CPU (`utils/graphs.py`). Returns fresh
    (image, transmittance, overflow), outside autograd."""
    inputs = scene_camera_inputs(scene, camera)
    if background is not None:
        inputs.append(background)

    def body(*flat):
        s, c, rest = split_inputs(flat)
        with torch.no_grad():
            return render_gaussian_sharded(s, c, cfg, mesh, axis_name,
                                           per_dest_capacity,
                                           rest[0] if rest else None)

    return GAUSSIAN_SHARDED_GRAPHS(
        (cfg, axis_name, per_dest_capacity, background is not None), inputs,
        body, mesh=mesh)
