"""The differentiable render: project -> bin/sort (cull kernel K3) -> gather
(scatter-free backward through kernel K4, or K5 over bf16 pairs) -> blend
(kernel K1, backward kernel K2). Port of `gsplat_tpu.render.pipeline` for
every `stream_format`: on 'packed16' and 'packed4' the gather packs the
features into int32 rows (`ops/stream16.py`) and the blend is one VJP over
K1 and K2 on the packed stream and the gather backward
(`ops/cuda/raster.py::rasterize_packed16`), straight through onto the
float32 features.

Gradient flow, as in the JAX package: the ordering (sorted ids, ranges) is
a stop-gradient permutation, so binning runs under `torch.no_grad()`; every
value flows through the differentiable gather and blend, so d image / d
{means, log_scales, quats, opacity_logits, sh} (and d / d uv_tap) is exact
for the fixed ordering. With no input requiring grad, autograd records
nothing and no residual is kept: the serving path runs as before.

`render` makes no host synchronisation: `num_intersections` and `overflow`
stay device tensors, so a frame can be captured whole. `render_jit` and
`render_loss_and_grad` are the counterparts of the JAX package's jitted
functions: on a CUDA device each replays a CUDA graph captured once per
config and input shapes (`utils/graphs.py`); `render` itself stays eager,
as JAX's `render` is the function `render_jit` jits. Each stage runs inside a
`utils/trace.py::stage` named in `STAGES`: a `torch.profiler.record_function`
span where the body runs eagerly, and a mark on the card where it is
captured, so a replay's record holds the stages too (the bin stage's mark
carries its intersections and the keys its sort ordered). Gradient hooks
mark the backward's boundaries: "render.blend.backward" begins when the
image's gradient is ready (the loss's backward ends; K2 and the gather's
backward follow), "render.project.backward" when the features' gradient is
(the SH and projection backward follow).
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import (
    bin_gaussians,
    features_f32,
    gather_stream,
)
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda.raster import rasterize_packed16, rasterize_tiles
from gsplat_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from gsplat_tpu_torch.ops.stream16 import gather_packed
from gsplat_tpu_torch.train.losses import l1
from gsplat_tpu_torch.utils.graphs import Captured
from gsplat_tpu_torch.utils.trace import on_grad, stage

# The stages of `render`, in the order they run.
STAGES = ("render.project", "render.bin", "render.gather", "render.blend")


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor              # (H, W, 3) float32, black background
    transmittance: torch.Tensor      # (H, W) final T (for bg compositing)
    num_intersections: torch.Tensor  # () int32
    overflow: torch.Tensor           # () bool -- static capacity exceeded
    gauss_counts: torch.Tensor       # (N,) int32 post-cull candidates per Gaussian


def render_with_projection(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    background: torch.Tensor | None = None,
    uv_tap: torch.Tensor | None = None,
) -> tuple[RenderOutput, ProjectedGaussians]:
    """`render`, and the projection it rendered from (the train step reads
    its tile counts for visibility instead of projecting a second time)."""
    with stage("render.project"):
        proj = project_gaussians(scene, camera, cfg, uv_tap=uv_tap)
    with stage("render.bin") as bin_stage, torch.no_grad():
        binned = bin_gaussians(proj, cfg)
        bin_stage.payload(binned.num_intersections, binned.keys_sorted)
    with stage("render.gather"):
        feats = features_f32(proj, cfg)
        on_grad(feats, "render.project.backward")
        if cfg.stream_format == "f32":
            features = gather_stream(feats, binned, cfg)
        else:
            with torch.no_grad():
                slots = gather_packed(feats, binned.sorted_gid, cfg)
    with stage("render.blend"):
        if cfg.stream_format == "f32":
            image, trans = rasterize_tiles(features, binned.ranges, cfg)
        else:
            image, trans = rasterize_packed16(feats, slots, binned, cfg)
        if background is not None:
            image = image + trans[..., None] * background
    on_grad(image, "render.blend.backward")
    out = RenderOutput(
        image=image,
        transmittance=trans,
        num_intersections=binned.num_intersections,
        overflow=binned.overflow,
        gauss_counts=binned.gauss_counts,
    )
    return out, proj


def render(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    background: torch.Tensor | None = None,
    uv_tap: torch.Tensor | None = None,
) -> RenderOutput:
    """uv_tap: optional (N, 2) zeros added to the screen-space uv, the
    gradient tap of the densification trigger (see `project_gaussians`)."""
    return render_with_projection(scene, camera, cfg, background, uv_tap)[0]


def render_loss_with_aux(scene, camera, target, cfg: RenderConfig,
                         background=None):
    """L1 loss against a target image, plus the capacity diagnostics a
    training step must read: a saturated stream silently truncates the image
    and every gradient. Returns (loss, {"overflow": () bool,
    "num_intersections": () int32}). The training losses with SSIM live in
    `gsplat_tpu_torch.train.losses`."""
    out = render(scene, camera, cfg, background)
    return l1(out.image, target), {
        "overflow": out.overflow,
        "num_intersections": out.num_intersections,
    }


def render_loss(scene, camera, target, cfg: RenderConfig, background=None):
    """The L1 loss of `render_loss_with_aux` alone."""
    return render_loss_with_aux(scene, camera, target, cfg, background)[0]


SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianScene))
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))

# The captured frames and loss-and-gradients, keyed by config and shapes.
RENDER_GRAPHS = Captured("render")
LOSS_AND_GRAD_GRAPHS = Captured("loss_and_grad")


def scene_camera_inputs(scene: GaussianScene, camera: Camera) -> list:
    """The scene's and the camera's tensors, in field order: the inputs of
    a captured call."""
    return ([getattr(scene, f) for f in SCENE_FIELDS]
            + [getattr(camera, f) for f in CAMERA_FIELDS])


def split_inputs(flat) -> tuple[GaussianScene, Camera, list]:
    """`scene_camera_inputs` read back: (scene, camera, the rest)."""
    n, m = len(SCENE_FIELDS), len(CAMERA_FIELDS)
    return (GaussianScene(*flat[:n]), Camera(*flat[n:n + m]),
            list(flat[n + m:]))


def render_jit(scene: GaussianScene, camera: Camera, cfg: RenderConfig,
               background: torch.Tensor | None = None) -> RenderOutput:
    """`render` dispatched as one program, as the JAX package's `render_jit`
    (a `jax.jit` with cfg static): on a CUDA device the frame is a CUDA
    graph, captured on the first call for (cfg, input shapes, dtypes,
    device, background or not, the scene's addresses) and replayed after;
    the scene is read where it lies, the camera copied into the graph's
    buffers (`utils/graphs.py`).
    On the CPU the same call runs eagerly. The outputs are new tensors,
    outside autograd."""
    inputs = scene_camera_inputs(scene, camera)
    if background is not None:
        inputs.append(background)

    def body(*flat):
        s, c, rest = split_inputs(flat)
        with torch.no_grad():
            return render(s, c, cfg, rest[0] if rest else None)

    return RENDER_GRAPHS((cfg, background is not None), inputs, body,
                         held=len(SCENE_FIELDS))


def _loss_and_grad(scene, camera, target, cfg: RenderConfig):
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in SCENE_FIELDS}
    with torch.enable_grad():
        loss = render_loss(GaussianScene(**leaves), camera, target, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
    return loss.detach(), GaussianScene(*grads)


def render_loss_and_grad(scene, camera, target, cfg: RenderConfig):
    """(loss, GaussianScene of d loss / d each field), dispatched as one
    program as the JAX package's jitted `render_loss_and_grad`: a CUDA
    graph per (cfg, input shapes) on a CUDA device, eager on the CPU; the
    scene is read where it lies. The scene's own tensors are left as they
    are: the gradient is taken on detached views of them, so no `.grad` is
    written."""

    def body(*flat):
        s, c, (t,) = split_inputs(flat)
        return _loss_and_grad(s, c, t, cfg)

    return LOSS_AND_GRAD_GRAPHS(
        cfg, scene_camera_inputs(scene, camera) + [target], body,
        held=len(SCENE_FIELDS))
