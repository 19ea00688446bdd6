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

A `FeatureScene` (Feature 3DGS) renders its (N, C) features beside the
colour with the same weights: the blend is then kernel K6 and its backward
K7 (`ops/cuda/features.py`), reading each slot's feature row by its
Gaussian id, and the output carries the (H, W, C) feature map. A scene
without features takes the path above unchanged.

A `SurfelScene` (2D Gaussian splatting, arXiv:2403.17888) projects its
surfels with kernel K12 (backward K13), bins them by their reachable
ellipse (`ops/surfels.py`), gathers them into an (N, 18) table read by
each slot's id, and blends with kernel K10 (backward K11, then the gather
backward's K4): the output carries the normal map, the expected depth,
the distortion and alpha beside the image.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import (
    FeatureScene,
    GaussianScene,
    SurfelScene,
)
from gsplat_tpu_torch.ops.binning import (
    bin_gaussians,
    features_f32,
    gather_stream,
)
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda.features import rasterize_features
from gsplat_tpu_torch.ops.cuda.raster import rasterize_packed16, rasterize_tiles
from gsplat_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from gsplat_tpu_torch.ops.stream16 import gather_packed
from gsplat_tpu_torch.ops.surfels import (
    expected_depth,
    project_surfels,
    rasterize_surfels,
    surfel_table,
)
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
    features: torch.Tensor | None = None  # (H, W, C) feature map of a
    #                                     #   FeatureScene, else None
    # A SurfelScene's maps, else None: the normal map sum w n (view
    # space), the expected depth sum w z / alpha, the distortion and
    # alpha = 1 - transmittance.
    normals: torch.Tensor | None = None     # (H, W, 3)
    depth: torch.Tensor | None = None       # (H, W)
    distortion: torch.Tensor | None = None  # (H, W)
    alpha: torch.Tensor | None = None       # (H, W)


def render_with_projection(
    scene: GaussianScene,
    camera: Camera,
    cfg: RenderConfig,
    background: torch.Tensor | None = None,
    uv_tap: torch.Tensor | None = None,
) -> tuple[RenderOutput, ProjectedGaussians]:
    """`render`, and the projection it rendered from (the train step reads
    its tile counts for visibility instead of projecting a second time)."""
    if isinstance(scene, SurfelScene):
        return _render_surfels(scene, camera, cfg, background)
    table = scene.features if isinstance(scene, FeatureScene) else None
    with stage("render.project"):
        proj = project_gaussians(scene, camera, cfg, uv_tap=uv_tap)
    with stage("render.bin") as bin_stage, torch.no_grad():
        binned = bin_gaussians(proj, cfg)
        bin_stage.payload(binned.num_intersections, binned.keys_sorted)
    with stage("render.gather"):
        feats = features_f32(proj, cfg)
        on_grad(feats, "render.project.backward")
        if table is not None:
            # The stream carries no gradient: K7's VJP takes the gather's.
            with torch.no_grad():
                slots = (gather_stream(feats, binned, cfg)
                         if cfg.stream_format == "f32"
                         else gather_packed(feats, binned.sorted_gid, cfg))
        elif cfg.stream_format == "f32":
            features = gather_stream(feats, binned, cfg)
        else:
            with torch.no_grad():
                slots = gather_packed(feats, binned.sorted_gid, cfg)
    fmap = None
    with stage("render.blend"):
        if table is not None:
            image, trans, fmap = rasterize_features(feats, table, slots,
                                                    binned, cfg)
        elif cfg.stream_format == "f32":
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
        features=fmap,
    )
    return out, proj


def _render_surfels(scene: SurfelScene, camera: Camera, cfg: RenderConfig,
                    background=None):
    """`render_with_projection` of a SurfelScene. The blend reads each
    slot's surfel from the (N, 18) float32 table by its id and sums float32
    slot gradients, so a configuration that selects another stream or a
    bf16 gradient path is refused."""
    if (cfg.stream_format != "f32" or cfg.gather_backward == "bf16"
            or cfg.grad_readout != "f32"):
        raise ValueError(
            "surfels: the blend reads a float32 table by slot id and sums "
            "float32 slot gradients; set stream_format='f32', "
            "grad_readout='f32' and a float32 gather_backward (got "
            f"{cfg.stream_format!r}, {cfg.grad_readout!r}, "
            f"{cfg.gather_backward!r})")
    with stage("render.project"):
        proj = project_surfels(scene, camera, cfg)
    with stage("render.bin") as bin_stage, torch.no_grad():
        binned = bin_gaussians(proj, cfg)
        bin_stage.payload(binned.num_intersections, binned.keys_sorted)
    with stage("render.gather"):
        table = surfel_table(proj)
        on_grad(table, "render.project.backward")
    with stage("render.blend"):
        image, trans, normals, dsum, dist = rasterize_surfels(table, binned,
                                                              cfg)
        alpha = 1.0 - trans
        depth = expected_depth(dsum, alpha)
        if background is not None:
            image = image + trans[..., None] * background
    on_grad(image, "render.blend.backward")
    out = RenderOutput(
        image=image, transmittance=trans,
        num_intersections=binned.num_intersections,
        overflow=binned.overflow,
        gauss_counts=binned.gauss_counts, normals=normals, depth=depth,
        distortion=dist, alpha=alpha)
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
    outside autograd. A FeatureScene's feature table is read where it lies
    too, and the output carries its feature map; a SurfelScene's output
    carries its normal, depth, distortion and alpha maps."""
    inputs = scene_camera_inputs(scene, camera)
    if background is not None:
        inputs.append(background)
    n = len(SCENE_FIELDS)
    key = (cfg, background is not None)
    table = scene.features if isinstance(scene, FeatureScene) else None
    surfels = isinstance(scene, SurfelScene)
    if table is not None:
        inputs.insert(n, table)
        key += ("features",)
    if surfels:
        key += ("surfels",)

    def body(*flat):
        if table is None:
            s, c, rest = split_inputs(flat)
            if surfels:
                s = SurfelScene(**vars(s))
        else:
            s, c, rest = split_inputs(flat[:n] + flat[n + 1:])
            s = FeatureScene(*flat[:n], features=flat[n])
        with torch.no_grad():
            return render(s, c, cfg, rest[0] if rest else None)

    return RENDER_GRAPHS(key, inputs, body, held=n + (table is not None))


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
