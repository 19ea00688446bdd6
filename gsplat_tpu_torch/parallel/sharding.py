"""Tile-sharded rendering over a mesh of processes (port of
`gsplat_tpu.parallel.sharding`).

JAX runs one program over a device `Mesh` with `shard_map`. The port runs
one process per shard, each calling the same functions, and collectives of
`torch.distributed` take the place of `shard_map`'s specs:

  - `Mesh` holds the axis names and sizes, this rank's coordinate on each
    axis, its device, and for each axis the process group of the ranks that
    differ only along it. Ranks are laid out row-major over the axes, as
    `make_mesh` lays out devices in the JAX package.
  - Only `all_reduce`, `all_gather` and `all_to_all_single` are used, the
    collectives that both NCCL and gloo take on CUDA tensors (gloo stages
    them through host memory). Flags travel as int32 (NCCL has no bool).
    The SSIM halo `ppermute` is an `all_gather` of each band's edge rows.
  - The tile grid is sharded by contiguous rows of tiles: each rank projects
    all N Gaussians, but bins, sorts and blends only its band of tile rows
    (`cfg.max_intersections` is then the per-shard capacity). The forward
    needs no collective but the flags'; `render_tile_sharded` gathers the
    bands into the whole image on every rank.
  - `render_tile_sharded_jit` is the whole per-rank frame dispatched as one
    program, as the JAX package jits the `shard_map`: on an NCCL mesh a CUDA
    graph with its collectives inside (`utils/graphs.py`), on gloo the same
    body eagerly.

Every rank must issue the same collectives in the same order, or the run
waits until the process group's timeout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import (
    bin_gaussians,
    features_f32,
    gather_features,
)
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda import counters
from gsplat_tpu_torch.ops.cuda.raster import rasterize_packed16, rasterize_tiles
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.stream16 import gather_packed, quant_params
from gsplat_tpu_torch.render.pipeline import scene_camera_inputs, split_inputs
from gsplat_tpu_torch.utils.graphs import Captured


def _dist():
    """torch.distributed when a process group is up, else None."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of processes: axis names and sizes, its
    coordinate on each axis, its device, per axis the process group of
    the ranks that differ only along that axis (None: the whole world, or
    no process group at all in a one-process mesh), and the process
    group's backend ('nccl' or 'gloo'; None without a group), which decides
    whether a program on the mesh is captured (`utils/graphs.py`)."""

    axis_names: tuple
    axis_sizes: tuple
    coords: tuple
    groups: tuple
    device: torch.device
    distributed: bool
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def rank(self) -> int:
        return int(np.ravel_multi_index(self.coords, self.axis_sizes))

    def size_of(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on the axis; 0 for an absent axis."""
        if axis not in self.axis_names:
            return 0
        return int(self.coords[self.axis_names.index(axis)])

    def group(self, axis: str | None):
        """The process group of `axis` (None: all ranks of the mesh)."""
        if axis is None or axis not in self.axis_names:
            return None
        return self.groups[self.axis_names.index(axis)]


def make_mesh(axis_sizes: dict[str, int], device="cuda") -> Mesh:
    """The mesh of every rank of the process group, laid out row-major over
    `axis_sizes` (counterpart of `gsplat_tpu.parallel.sharding.make_mesh`).
    Every rank must call it, with the same sizes, in the same order as its
    other group creations: it creates one process group per axis line.
    Without a process group only a mesh of one rank can be made."""
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(v) for v in axis_sizes.values())
    total = int(np.prod(sizes))
    dist = _dist()
    world = dist.get_world_size() if dist else 1
    if total != world:
        raise ValueError(f"mesh needs {total} ranks, the process group has "
                         f"{world}")
    rank = dist.get_rank() if dist else 0
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups = []
    for a, n in enumerate(sizes):
        mine = None
        if dist and n != world:
            # One group per line along axis a, created by every rank in the
            # same order (the lines in row-major order of the other axes).
            others = [range(s) for i, s in enumerate(sizes) if i != a]
            for rest in np.ndindex(*[len(r) for r in others]):
                ranks = []
                for j in range(n):
                    c = list(rest)
                    c.insert(a, j)
                    ranks.append(int(np.ravel_multi_index(c, sizes)))
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine = g
        groups.append(mine)
    return Mesh(names, sizes, coords, tuple(groups), torch.device(device),
                dist is not None, dist.get_backend() if dist else None)


# ---- collectives ----------------------------------------------------------

# The helpers below count each collective they issue to the process group
# (on NCCL one kernel each) as "collectives" (`ops/cuda/counters.py`); a
# replayed graph adds its own.


def _local(mesh: Mesh, axis: str | None) -> bool:
    """No collective to issue: one process, or an axis the mesh lacks (size
    1). A present axis of size 1 still issues it, on its one-rank group."""
    return not mesh.distributed or (axis is not None
                                    and axis not in mesh.axis_names)


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str | None = None,
                op: str = "sum") -> torch.Tensor:
    """t (contiguous) reduced ('sum' or 'max') over the axis (None: every
    rank) in place; returns t."""
    if not _local(mesh, axis):
        dist = torch.distributed
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(t, op=red, group=mesh.group(axis))
        counters.bump("collectives")
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str | None = None,
               op: str = "sum") -> torch.Tensor:
    """t reduced ('sum' or 'max') over the axis (None: every rank), in a
    new tensor."""
    return all_reduce_(t.detach().clone().contiguous(), mesh, axis, op)


def any_flag(flag: torch.Tensor, mesh: Mesh, axis: str | None = None):
    """A bool (or a bool tensor) OR-reduced over the axis, through int32
    MAX (NCCL has no bool)."""
    return all_reduce(flag.to(torch.int32), mesh, axis, "max") > 0


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """[t of each rank along the axis], in the axis's order."""
    if _local(mesh, axis):
        return [t]
    n = mesh.size_of(axis)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(n)]
    torch.distributed.all_gather(out, t, group=mesh.group(axis))
    counters.bump("collectives")
    return out


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The tiled all_to_all over dim 0: t is D equal blocks, block i goes to
    rank i of the axis, and block s of the result came from rank s. Its own
    transpose (an involution)."""
    if _local(mesh, axis):
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    torch.distributed.all_to_all_single(out, t, group=mesh.group(axis))
    counters.bump("collectives")
    return out


class _GatherRows(torch.autograd.Function):
    """The bands of every rank along an axis stacked along dim 0 (the whole
    image from its row bands). Backward: this rank's rows of the gradient
    (each rank's loss is the same function of the whole image, so the
    gradient of its own band is complete without a reduction)."""

    @staticmethod
    def forward(ctx, band, mesh, axis):
        ctx.rows = (mesh.index(axis) * band.shape[0], band.shape[0])
        return torch.cat(all_gather(band, mesh, axis), 0)

    @staticmethod
    def backward(ctx, g):
        start, h = ctx.rows
        return g[start:start + h], None, None


def gather_rows(band: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _GatherRows.apply(band, mesh, axis)


class _SumGrads(torch.autograd.Function):
    """Identity on tensors every rank of an axis holds alike; backward sums
    their gradients over the axis in one all_reduce (the transpose of a
    replicated `shard_map` input, a psum)."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = all_reduce(flat, ctx.mesh, ctx.axis)
        out, i = [], 0
        for shape in ctx.shapes:
            n = math.prod(shape)
            out.append(flat[i:i + n].view(shape))
            i += n
        return (None, None, *out)


def replicated(scene: GaussianScene, mesh: Mesh, axis: str) -> GaussianScene:
    """The scene, with its gradients summed over the axis on the way back."""
    fields = [f.name for f in dataclasses.fields(scene)]
    if not (torch.is_grad_enabled()
            and any(getattr(scene, f).requires_grad for f in fields)):
        return scene
    outs = _SumGrads.apply(mesh, axis, *(getattr(scene, f) for f in fields))
    return GaussianScene(**dict(zip(fields, outs)))


class _HaloExchange(torch.autograd.Function):
    """(h, W, C) band -> (h + 2 halo, W, C): the band with the halo rows of
    its neighbours along the axis above and below (zeros past the global
    edges, as the zero-padded SSIM window sees them). One all_gather of each
    band's edge rows each way; the backward sends each neighbour the
    gradient of its rows the same way."""

    @staticmethod
    def forward(ctx, band, mesh, axis, halo):
        i, n = mesh.index(axis), mesh.size_of(axis)
        ctx.mesh, ctx.axis, ctx.halo = mesh, axis, halo
        edges = all_gather(torch.cat([band[:halo], band[-halo:]]), mesh, axis)
        zero = band.new_zeros((halo,) + band.shape[1:])
        up = edges[i - 1][halo:] if i > 0 else zero
        down = edges[i + 1][:halo] if i < n - 1 else zero
        return torch.cat([up, band, down], 0)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, halo = ctx.mesh, ctx.axis, ctx.halo
        i, n = mesh.index(axis), mesh.size_of(axis)
        g_band = g[halo:-halo].clone()
        sent = all_gather(torch.cat([g[:halo], g[-halo:]]), mesh, axis)
        if i < n - 1:  # the neighbour below read my last rows as its `up`
            g_band[-halo:] += sent[i + 1][:halo]
        if i > 0:      # the neighbour above read my first rows as `down`
            g_band[:halo] += sent[i - 1][halo:]
        return g_band, None, None, None


def halo_exchange_rows(band: torch.Tensor, mesh: Mesh, axis: str,
                       halo: int) -> torch.Tensor:
    """(h, W, C) row band -> (h + 2 halo, W, C) extended with the neighbour
    shards' boundary rows (zeros at the global top and bottom, as the zero
    window padding): every 11x11 SSIM window then sees the pixels the
    single-device computation sees. Differentiable."""
    return _HaloExchange.apply(band, mesh, axis, halo)


# ---- the tile-sharded render ----------------------------------------------


def local_tile_cfg(cfg: RenderConfig, num_shards: int) -> RenderConfig:
    """The config of one shard's tile rows: the padded tile grid divided
    along its rows (tiles_y % num_shards == 0), tiles_x kept. The packed
    streams' quant ranges are pinned to the global image (the means stay
    global pixel coordinates on every shard)."""
    if cfg.tiles_y % num_shards != 0:
        raise ValueError(
            f"tiles_y={cfg.tiles_y} not divisible by {num_shards} shards"
        )
    local_rows = cfg.tiles_y // num_shards
    return dataclasses.replace(
        cfg,
        height=local_rows * cfg.tile_size,
        width=cfg.padded_width,
        quant_ranges=tuple(float(q) for q in quant_params(cfg)),
    )


def _render_local_tiles(scene, camera, cfg: RenderConfig, lcfg: RenderConfig,
                        shard_idx: int, uv_tap=None):
    """One shard's body: project all, bin and blend only this shard's tile
    rows. Returns (image band, transmittance band of the padded image,
    overflow, num_intersections, the projection). uv_tap threads the
    densification trigger's gradient tap through the projection."""
    tile_start = shard_idx * lcfg.num_tiles
    proj = project_gaussians(scene, camera, cfg, uv_tap=uv_tap)
    with torch.no_grad():
        binned = bin_gaussians(proj, cfg, tile_start=tile_start,
                               num_local_tiles=lcfg.num_tiles)
    if cfg.stream_format == "f32":
        features = gather_features(proj, binned, cfg)
        image, trans = rasterize_tiles(features, binned.ranges, lcfg,
                                       tile_start)
    else:
        # Packed with the global cfg, rasterized under lcfg, which carries
        # the same quant ranges.
        feats = features_f32(proj, cfg)
        with torch.no_grad():
            slots = gather_packed(feats, binned.sorted_gid, cfg)
        image, trans = rasterize_packed16(feats, slots, binned, lcfg,
                                          tile_start)
    return image, trans, binned.overflow, binned.num_intersections, proj


def render_tile_sharded(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    axis_name: str = "tiles",
    background: torch.Tensor | None = None,
):
    """Render with the tile grid sharded over `mesh`'s axis. Every rank
    passes the same scene and camera and gets the whole (image (H, W, 3),
    transmittance (H, W), overflow ()), the bands gathered. Differentiable
    in the scene: each rank's gradients are summed over the axis, so every
    rank holds the whole gradient, as the JAX function's replicated input
    gets it."""
    d = mesh.size_of(axis_name)
    lcfg = local_tile_cfg(cfg, d)
    scene = replicated(scene, mesh, axis_name)
    img, trans, ovf, _, _ = _render_local_tiles(
        scene, camera, cfg, lcfg, mesh.index(axis_name))
    ovf = any_flag(ovf, mesh, axis_name)
    img = gather_rows(img, mesh, axis_name)[: cfg.height, : cfg.width]
    trans = gather_rows(trans, mesh, axis_name)[: cfg.height, : cfg.width]
    if background is not None:
        img = img + trans[..., None] * background
    return img, trans, ovf


# The captured tile-sharded frames, keyed by config, axis and shapes.
TILE_SHARDED_GRAPHS = Captured("render_tile_sharded")


def render_tile_sharded_jit(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    axis_name: str = "tiles",
    background: torch.Tensor | None = None,
):
    """`render_tile_sharded` dispatched as one program per rank, as the JAX
    bench jits the `shard_map`: projection, binning (K3), the band's blend
    (K1 at its tile offset), the overflow flag and the gather of the bands.
    On an NCCL mesh on the card it is a CUDA graph, collectives inside,
    captured on the first call for (cfg, axis, input shapes) and replayed
    after; on gloo, and on the CPU, the same body runs eagerly
    (`utils/graphs.py`). The scene and the camera are copied into the
    graph's buffers. Returns fresh (image, transmittance, overflow),
    outside autograd."""
    inputs = scene_camera_inputs(scene, camera)
    if background is not None:
        inputs.append(background)

    def body(*flat):
        s, c, rest = split_inputs(flat)
        with torch.no_grad():
            return render_tile_sharded(s, c, cfg, mesh, axis_name,
                                       rest[0] if rest else None)

    return TILE_SHARDED_GRAPHS((cfg, axis_name, background is not None),
                               inputs, body, mesh=mesh)
