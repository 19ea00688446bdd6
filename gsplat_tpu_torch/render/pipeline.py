"""The forward render: project -> bin/sort (cull kernel K3) -> gather ->
blend (kernel K1). Port of `gsplat_tpu.render.pipeline.render` for
`stream_format='f32'`.

Nothing on this path needs gradients yet (training is a later slice of the
port), so it runs under `torch.no_grad()`. It makes no host synchronisation:
`num_intersections` and `overflow` stay device tensors.

Each stage runs inside a `torch.profiler.record_function` span named in
`STAGES`, so a profiler sees the served path's stages as they are
(`scripts/profile_torch_render.py` reads them); outside a profiler a span
costs a few microseconds.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import bin_gaussians, gather_features
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda.raster import rasterize_tiles
from gsplat_tpu_torch.ops.projection import project_gaussians

# The profiler spans of `render`, in the order the stages run.
STAGES = ("render.project", "render.bin", "render.gather", "render.blend")


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor              # (H, W, 3) float32, black background
    transmittance: torch.Tensor      # (H, W) final T (for bg compositing)
    num_intersections: torch.Tensor  # () int32
    overflow: torch.Tensor           # () bool -- static capacity exceeded
    gauss_counts: torch.Tensor       # (N,) int32 post-cull candidates per Gaussian


@torch.no_grad()
def render(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    background: torch.Tensor | None = None,
) -> RenderOutput:
    if cfg.stream_format != "f32":
        raise NotImplementedError(
            f"stream_format={cfg.stream_format!r} comes with the packed-stream "
            "slice of the port (packed16/packed4, jumbo tiers); use 'f32'"
        )
    with record_function("render.project"):
        proj = project_gaussians(scene, camera, cfg)
    with record_function("render.bin"):
        binned = bin_gaussians(proj, cfg)
    with record_function("render.gather"):
        features = gather_features(proj, binned, cfg)
    with record_function("render.blend"):
        image, trans = rasterize_tiles(features, binned.ranges, cfg)
    if background is not None:
        image = image + trans[..., None] * background
    return RenderOutput(
        image=image,
        transmittance=trans,
        num_intersections=binned.num_intersections,
        overflow=binned.overflow,
        gauss_counts=binned.gauss_counts,
    )
