"""Training on one device: the train step (forward, L1 + DSSIM loss,
backward through kernels K2 and K4 or K5, and an Adam update) and `fit`,
the training loop with densification, opacity reset, SH warm-up,
position-lr decay, the staged-capacity schedule, evals, metrics CSV and
checkpoints (port of `gsplat_tpu.train.loop`, and of
`gsplat_tpu.parallel.train_step.make_optimizer`); with `mesh=` the fit
drives the tile-sharded step of `parallel/train_step.py`.

Where the JAX step is a pure function of a train state, the port's step
updates the scene's tensors in place: they are the optimizer's parameters
(leaf tensors with requires_grad), as torch optimizers hold them. On a CUDA
device the step is a CUDA graph, as the JAX step is one jitted program
(`make_train_step`); `make_eager_train_step` runs the same body op by op.
Each phase runs inside a `utils/trace.py::stage` named in `TRAIN_SPANS`: a
`torch.profiler.record_function` span where the body runs eagerly, and a
mark where it is captured. The backward's own boundaries are the render's
gradient marks ("render.blend.backward" ends the loss's backward,
"render.project.backward" the blend's); the profile scripts
(`scripts/profile_torch_train*.py`) read the record of replays.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import _normalize_tier_plan
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.render.pipeline import (
    CAMERA_FIELDS,
    SCENE_FIELDS,
    render_with_projection,
)
from gsplat_tpu_torch.train.losses import rgb_loss
from gsplat_tpu_torch.utils.graphs import Captured
from gsplat_tpu_torch.utils.trace import stage

# The stages of a train step (a view's forward and loss stages repeat once
# per view).
TRAIN_SPANS = ("train.forward", "train.loss", "train.backward",
               "train.optimizer")

# Learning-rate multipliers of the graphdeco recipe: positions slower than
# colour and opacity.
LR_SCALES = dict(means=0.016, log_scales=0.5, quats=0.1, opacity_logits=5.0,
                 sh=0.25)


def sh_band_mask(num_coeffs: int, active_degree, device="cuda") -> torch.Tensor:
    """(K, 1) float mask keeping the SH bands <= active_degree. The band of
    coefficient j is floor(sqrt(j)), counted in integers on the device (the
    d >= 1 with d^2 <= j): no float edge at j = 1, 4, 9, and no copy from
    the host, which would make the step wait for the card."""
    j = torch.arange(num_coeffs, dtype=torch.int32, device=device)
    band = torch.zeros_like(j)
    for d in range(1, math.isqrt(max(num_coeffs - 1, 0)) + 1):
        band += j >= d * d
    return (band <= active_degree).to(torch.float32)[:, None]


def decayed_lr(t, base: float, ratio: float, max_steps: int):
    """optax.exponential_decay's rate at update t: base ratio^(t /
    max_steps), held at base ratio from then on. t is a number (a float in
    double precision) or a float64 tensor (the same on its device)."""
    end = base * ratio
    if isinstance(t, torch.Tensor):
        x = base * torch.pow(ratio, t / max_steps)
        return torch.clamp_min(x, end) if ratio < 1.0 else \
            torch.clamp_max(x, end)
    clip = max if ratio < 1.0 else min
    return clip(base * ratio ** (t / max_steps), end)


class SceneAdam(torch.optim.Adam):
    """`torch.optim.Adam` with one parameter group per scene field (named
    by the group's "name") and an optional exponential schedule of the
    "means" group's rate, `decay` = (base, ratio, max_steps) of
    `decayed_lr`: the rate of the update t = 0, 1, ... is
    `means_lr_at(t)`.

    On a CUDA device it is capturable (torch's `capturable=True`), so that
    a captured train step replays it whole: the rates are float32 device
    tensors, Adam's step counts stay on the device, and before each update
    the "means" rate is computed there (in float64) from the device count
    `count`. On the CPU the rates are floats, set from the host count, as
    torch's non-capturable Adam wants them; `updates` reads either count."""

    def __init__(self, groups, decay=None):
        dev = groups[0]["params"][0].device
        capturable = dev.type == "cuda"
        if capturable:
            groups = [dict(g, lr=torch.full((), g["lr"], dtype=torch.float32,
                                            device=dev)) for g in groups]
        # optax.adam's defaults, which are torch's: eps outside the sqrt.
        super().__init__(groups, betas=(0.9, 0.999), eps=1e-8,
                         capturable=capturable)
        self.decay = decay
        self.count = (torch.zeros((), dtype=torch.float64, device=dev)
                      if capturable else None)
        self._updates = 0

    def means_lr_at(self, t: int) -> float:
        return decayed_lr(t, *self.decay)

    @property
    def updates(self) -> int:
        """Updates made so far (reads the card when capturable)."""
        return self._updates if self.count is None else int(self.count)

    @updates.setter
    def updates(self, n: int) -> None:
        if self.count is None:
            self._updates = int(n)
        else:
            self.count.fill_(int(n))

    def step(self, closure=None):
        if self.decay is not None:
            for group in self.param_groups:
                if group["name"] != "means":
                    continue
                if self.count is None:
                    group["lr"] = self.means_lr_at(self._updates)
                else:
                    group["lr"].copy_(decayed_lr(self.count, *self.decay))
        loss = super().step(closure)
        if self.count is None:
            self._updates += 1
        else:
            self.count.add_(1)
        return loss


def make_optimizer(
    scene: GaussianScene,
    lr: float = 1e-2,
    *,
    position_lr_final_ratio: float | None = None,
    lr_max_steps: int | None = None,
) -> SceneAdam:
    """Adam over the scene's five fields, each at lr times its `LR_SCALES`
    multiplier. The scene's tensors become the parameters: they are set to
    require grad, and the optimizer updates them in place.

    position_lr_final_ratio with lr_max_steps adds the exponential position
    decay of optax.exponential_decay: lr_means(t) = lr_means ratio^(t /
    lr_max_steps), held at lr_means ratio from then on. Other groups stay
    constant."""
    decay = None
    if position_lr_final_ratio is not None:
        if not lr_max_steps:
            raise ValueError("position_lr_final_ratio requires lr_max_steps")
        decay = (lr * LR_SCALES["means"], float(position_lr_final_ratio),
                 lr_max_steps)
    groups = []
    for name in SCENE_FIELDS:
        param = getattr(scene, name)
        if not param.is_leaf:
            raise ValueError(f"make_optimizer: scene.{name} is not a leaf "
                             "tensor; pass a scene of plain tensors")
        param.requires_grad_(True)
        groups.append(dict(params=[param], lr=lr * LR_SCALES[name], name=name))
    return SceneAdam(groups, decay)


def check_params(scene: GaussianScene, params) -> None:
    if any(getattr(scene, f) is not p for f, p in zip(SCENE_FIELDS, params)):
        raise ValueError("train step: the scene's tensors are not the "
                         "optimizer's parameters")


def sh_mask_fn(params):
    """band_mask(active_sh_degree) of a step over the scene fields
    `params`: the degree's (K, 1) SH band mask, built once per degree on
    the parameters' device (no copy from the host), or None for None."""
    dev = params[0].device
    num_coeffs = params[SCENE_FIELDS.index("sh")].shape[1]
    masks = {}

    def band_mask(active_sh_degree):
        if active_sh_degree is None:
            return None
        degree = int(active_sh_degree)
        if degree not in masks:
            masks[degree] = sh_band_mask(num_coeffs, degree, dev)
        return masks[degree]

    return band_mask


def zero_grads_(optimizer, tap: torch.Tensor) -> None:
    """Zero the parameters' and the tap's gradients where they lie (a
    captured step reads and accumulates them at fixed addresses)."""
    optimizer.zero_grad(set_to_none=False)
    if tap.grad is not None:
        tap.grad.zero_()


def _train_step_body(cfg: RenderConfig, optimizer: SceneAdam,
                     ssim_weight: float):
    """(body, band_mask, params) of the train step.

    body(scene, cameras, targets, mask=None) -> (loss, aux, (tap_grads,
    visible)), mask a (K, 1) SH band mask or None. Its `.grad`s (the
    parameters' and the (N, 2) zero leaf `tap` of the densification
    trigger, made once) are zeroed and accumulated in place, so each keeps
    its storage from the first step on, as a captured step needs.
    band_mask is `sh_mask_fn`'s."""
    tier_klos = tuple(
        k_lo for k_lo, _, budget in _normalize_tier_plan(
            cfg.tier_spec, cfg.max_tiles_per_gaussian, 1)
        if budget is not None
    ) if cfg.binning == "tiered" else ()
    params = [group["params"][0] for group in optimizer.param_groups]
    dev = params[0].device
    tap = torch.zeros((params[0].shape[0], 2), device=dev, requires_grad=True)

    def body(scene, cameras, targets, mask=None):
        zero_grads_(optimizer, tap)
        if mask is not None:
            scene = dataclasses.replace(scene, sh=scene.sh * mask)
        losses, overflow, n_int, visible, members = [], [], [], [], []
        for camera, target in zip(cameras, targets):
            with stage("train.forward"):
                out, proj = render_with_projection(scene, camera, cfg,
                                                   uv_tap=tap)
            with stage("train.loss"):
                losses.append(rgb_loss(out.image, target, ssim_weight))
            overflow.append(out.overflow)
            n_int.append(out.num_intersections)
            visible.append(proj.counts > 0)
            members.append(torch.stack(
                [(out.gauss_counts > k).sum(dtype=torch.int32)
                 for k in tier_klos]) if tier_klos
                else torch.zeros((0,), dtype=torch.int32, device=dev))
        with stage("train.loss"):
            loss = torch.stack(losses).mean()
        with stage("train.backward"):
            loss.backward()
        with stage("train.optimizer"):
            # One non-finite gradient lane spreads through Adam into the
            # whole scene within a few steps; the flags let the caller stop
            # and name the field.
            leaf_ok = torch.stack([
                torch.isfinite(p.grad).all() if p.grad is not None
                else torch.ones((), dtype=torch.bool, device=dev)
                for p in params
            ])
            optimizer.step()
        aux = {
            "overflow": torch.stack(overflow).any(),
            "num_intersections": torch.stack(n_int).max(),
            "grads_finite": leaf_ok.all(),
            "grads_finite_leaves": leaf_ok,
            "tier_members": torch.stack(members).amax(0),
        }
        return (loss.detach(), aux,
                (tap.grad, torch.stack(visible).any(0)))

    return body, sh_mask_fn(params), params


def eager_step(body, band_mask, params):
    """step(scene, cameras, targets, active_sh_degree=None) -> (loss, aux,
    (tap_grads, visible)) running `body` (a `_train_step_body`'s, or a
    sharded step's of the same contract) op by op, the tap's gradient
    copied out of its fixed storage."""

    def step(scene: GaussianScene, cameras, targets, active_sh_degree=None):
        check_params(scene, params)
        loss, aux, (tap_grads, visible) = body(
            scene, cameras, targets, band_mask(active_sh_degree))
        return loss, aux, (tap_grads.clone(), visible)

    return step


def captured_step(body, params, kind: str, key, mesh=None):
    """step(scene, cameras, targets, *extra) -> body(scene, cameras,
    targets, *extra) dispatched as one program (`utils/graphs.py`): the
    cameras, targets and extra tensors (an SH band mask) are the graph's
    inputs, copied into its buffers; the scene (the optimizer's
    parameters, `params`), their gradients and the optimizer's state are
    read and written where they lie. A graph per (key, number of views,
    capacity, number of extras), of the `Captured` of `kind` (its cache is
    `step.graphs`); `mesh`: the mesh whose collectives the body issues."""
    graphs = Captured(kind)
    n_cam = len(CAMERA_FIELDS)

    def step(scene: GaussianScene, cameras, targets, *extra):
        check_params(scene, params)
        inputs = [getattr(c, f) for c in cameras for f in CAMERA_FIELDS]
        inputs += [targets, *extra]
        b = len(cameras)

        def run(*flat):
            cams = [Camera(*flat[i * n_cam:(i + 1) * n_cam])
                    for i in range(b)]
            return body(scene, cams, *flat[b * n_cam:])

        return graphs((key, b, scene.num_gaussians, len(extra)), inputs, run,
                      mesh=mesh)

    step.graphs = graphs
    return step


def masked_step(run, band_mask):
    """step(scene, cameras, targets, active_sh_degree=None): a
    `captured_step` given the degree's SH band mask as its extra input (JAX's
    traced `active_sh`: one graph serves every degree)."""

    def step(scene: GaussianScene, cameras, targets, active_sh_degree=None):
        mask = band_mask(active_sh_degree)
        return run(scene, cameras, targets,
                   *(() if mask is None else (mask,)))

    step.graphs = run.graphs
    return step


def make_eager_train_step(cfg: RenderConfig, optimizer: SceneAdam,
                          ssim_weight: float = 0.2):
    """`make_train_step`'s step run eagerly, op by op: the body the
    captured step captures, with the same interface. The profile scripts
    (`scripts/profile_torch_train*.py`) read its spans, and `chip_smoke.py`
    holds the captured step to it."""
    return eager_step(*_train_step_body(cfg, optimizer, ssim_weight))


def make_train_step(cfg: RenderConfig, optimizer: SceneAdam,
                    ssim_weight: float = 0.2):
    """Single-device train step over a small batch of views, unrolled (one
    render per view, as the JAX step unrolls its batch), dispatched as one
    program as the JAX package's jitted `_step`: on a CUDA device a CUDA
    graph (`utils/graphs.py`) captured on the first call for (cfg, B, the
    scene's capacity, ssim_weight, SH masking on or off: the JAX step's
    static `mask_sh`) and replayed after; on the CPU the same body eagerly.

    Returns step(scene, cameras, targets, active_sh_degree=None) ->
    (loss, aux, (tap_grads, visible)), where scene's tensors are the
    optimizer's parameters and are updated in place:
      cameras: a sequence of B `Camera`s; targets: (B, H, W, 3) images;
      active_sh_degree: SH bands above it are masked out of the loss (and
           get zero gradient), graphdeco's progressive SH activation; the
           degree's mask is an input of the graph (JAX's traced
           `active_sh`), so one graph serves every degree;
      loss: () the mean over views of the L1 + DSSIM loss, before the update;
      aux: device tensors, no host read: "overflow" (any view), the largest
           "num_intersections" of the views, "grads_finite" and the per-
           field "grads_finite_leaves" (SCENE_FIELDS order), and
           "tier_members" (members of each pool tier, worst view);
      tap_grads: (N, 2) d loss / d uv_tap, the screen-space positional
           gradient of the densification trigger;
      visible: (N,) bool, Gaussian touched >= 1 tile in >= 1 view.
    The gradients stay in each parameter's `.grad` after the step. The
    parameters, their `.grad` and Adam's state keep their storage: code
    between steps changes them in place (`fit`'s `_assign`)."""
    body, band_mask, params = _train_step_body(cfg, optimizer, ssim_weight)
    return masked_step(captured_step(body, params, "train_step",
                                     (cfg, float(ssim_weight))), band_mask)


def _append_csv_row(path: str, row: dict):
    """Append a metrics row; if the row brings columns the existing header
    lacks (e.g. the first eval row's PSNR columns), rewrite the file with
    the extended header, padding the earlier rows."""
    import csv

    header = list(row.keys())
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            reader = csv.DictReader(f)
            old_header = reader.fieldnames or []
            if set(header) <= set(old_header):
                with open(path, "a") as fa:
                    fa.write(
                        ",".join(str(row.get(k, "")) for k in old_header)
                        + "\n"
                    )
                return
            rows = list(reader)
            header = old_header + [k for k in header if k not in old_header]
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows + [row]:
            f.write(",".join(str(r.get(k, "")) for k in header) + "\n")


@torch.no_grad()
def _zero_opacity_moments(optimizer: SceneAdam) -> None:
    """Zero the Adam moments of the opacity group, in place (the CUDA
    original resets the opacity optimizer state with the opacity reset).
    Its step count is left alone, as optax's count is."""
    for group in optimizer.param_groups:
        if group["name"] != "opacity_logits":
            continue
        st = optimizer.state.get(group["params"][0])
        if st:
            st["exp_avg"].zero_()
            st["exp_avg_sq"].zero_()


@torch.no_grad()
def _assign(params, scene: GaussianScene) -> None:
    """Write scene's values into the optimizer's parameters, in place: the
    train step refuses a scene whose tensors are not its parameters."""
    for p, f in zip(params, SCENE_FIELDS):
        new = getattr(scene, f)
        if new.data_ptr() != p.data_ptr():
            p.copy_(new)


def fit(
    scene: GaussianScene,
    cameras,           # a sequence of V Cameras
    targets,           # (V, H, W, 3) tensor on the scene's device
    cfg: RenderConfig,
    steps: int = 200,
    lr: float = 1e-2,
    batch: int = 1,
    ssim_weight: float = 0.2,
    seed: int = 0,
    log_every: int = 20,
    checkpoint_every: int = 0,
    checkpoint_dir: str = "checkpoints",
    resume: str | None = None,
    on_metrics=None,
    densify_every: int = 0,
    densify_grad_threshold: float = 2e-4,
    densify_from: int = 0,
    densify_until: int | None = None,
    densify_max_scale: float | None = None,
    metrics_csv: str | None = None,
    overflow_policy: str = "raise",
    opacity_reset_every: int = 0,
    sh_warmup_every: int = 0,
    position_lr_final_ratio: float | None = None,
    lr_max_steps: int | None = None,
    eval_every: int = 0,
    eval_fn=None,
    trace_dir: str | None = None,
    trace_steps: tuple[int, int] | None = None,
    mesh=None,
    data_axis: str = "data",
    tile_axis: str = "tiles",
    retighten_capacity: float = 0.0,
):
    """Fit `scene` to `targets` seen from `cameras` (port of
    `gsplat_tpu.train.loop.fit`, single device). Returns (trained scene,
    metrics list). The caller's scene is not modified: the fit trains a
    copy, and returns its tensors detached.

    mesh: a `parallel.sharding.Mesh` with ('data', 'tiles') axes (an absent
    axis counts as size 1): every rank of the mesh calls fit alike, and it
    runs the tile-sharded step (`parallel/train_step.py`) with the same
    protocol: densification, opacity reset, SH warm-up, the staged capacity
    and the overflow and health guards. `batch` must divide by the data
    axis; cfg.max_intersections is the per-shard capacity. The scene and
    Adam's state stay replicated, bit for bit alike on every rank, so
    eval_fn and checkpoints see whole tensors; only the primary rank (rank
    0) writes checkpoints, the metrics CSV and the log rows.

    sh_warmup_every > 0 activates the SH bands progressively: active degree
    = min(sh_degree, step // sh_warmup_every) (graphdeco's oneupSHdegree).

    position_lr_final_ratio enables the exponential position-lr decay over
    lr_max_steps (default: `steps`), see make_optimizer.

    eval_every > 0 calls eval_fn(scene, step) at the log rows whose step is
    a multiple of it (and at the last step); its dict is merged into the
    row. The scene it gets is detached from autograd.

    densify_every > 0 enables adaptive density control (train/densify.py)
    every that many steps from densify_from to densify_until (default
    steps // 2); the scene must carry free capacity (GaussianScene.pad_to).
    Adam moments survive for untouched slots and are zeroed for killed and
    new ones.

    opacity_reset_every > 0 clamps opacities below 0.01 every that many
    steps and zeroes the opacity group's Adam moments.

    retighten_capacity > 0 enables the staged-capacity schedule: once
    densification ends, the train step is rebuilt with max_intersections
    tightened to retighten_capacity x the peak stream demand measured so
    far (and, with tiered binning, the pool budgets re-sized from the
    measured peak tier membership). An overflow under the tightened config
    rebuilds the step at the original sizing (one warning, no abort).

    overflow_policy, checked at the log rows: 'raise' aborts with the
    measured demand, 'warn' prints and goes on, 'ignore' does neither (and
    skips the scene-health guard). The flags accumulate on the device
    between log rows: no step waits for the card.

    trace_dir with trace_steps=(start, stop) records a `torch.profiler`
    trace of the steps [start, stop) (densify rounds, evals and host work
    included) and writes it to trace_dir/trace.json (Chrome trace format).
    """
    if overflow_policy not in ("raise", "warn", "ignore"):
        raise ValueError(f"unknown overflow_policy {overflow_policy!r}")
    from gsplat_tpu_torch.train.densify import (
        accumulate_grads,
        densify_and_prune_jit,
        init_densify_state,
        mask_opt_moments,
        reset_opacity,
    )
    from gsplat_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    dev = scene.means.device
    scene = GaussianScene(**{f: getattr(scene, f).detach().clone()
                             for f in SCENE_FIELDS})
    optimizer = make_optimizer(
        scene, lr,
        position_lr_final_ratio=position_lr_final_ratio,
        lr_max_steps=(lr_max_steps or steps)
        if position_lr_final_ratio is not None else None,
    )
    params = [getattr(scene, f) for f in SCENE_FIELDS]
    n_cap = scene.num_gaussians
    dstate = init_densify_state(n_cap, dev)
    start_step = 0
    # With a mesh, rank 0 alone writes checkpoints, the CSV and the log.
    primary = mesh is None or mesh.rank == 0

    def say(msg) -> None:
        if primary:
            print(msg)

    if resume:
        start_step = load_checkpoint(resume, scene, optimizer)
        say(f"resumed from {resume} at step {start_step}")

    def detached():
        return GaussianScene(*(p.detach() for p in params))

    if mesh is not None:
        from gsplat_tpu_torch.parallel.sharding import local_tile_cfg
        from gsplat_tpu_torch.parallel.train_step import (
            make_sharded_train_step,
            shard_batch,
        )

        local_tile_cfg(cfg, mesh.size_of(tile_axis))  # validates the grid
        if batch % mesh.size_of(data_axis) != 0:
            raise ValueError(f"batch={batch} not divisible by data axis "
                             f"{mesh.size_of(data_axis)}")
        # Targets padded once to the tile grid; each rank then takes only
        # its band of its views (shard_batch).
        ph, pw = cfg.padded_height, cfg.padded_width
        targets = torch.nn.functional.pad(
            targets, (0, 0, 0, pw - targets.shape[2], 0, ph - targets.shape[1]))

    def build_step(c: RenderConfig):
        """The train step under config c: rebuilt by the staged-capacity
        schedule with a different max_intersections and tier_spec (on a
        CUDA device a new graph is captured then, where JAX re-jits)."""
        if mesh is None:
            return make_train_step(c, optimizer, ssim_weight)
        sharded_step = make_sharded_train_step(
            c, mesh, optimizer, ssim_weight, data_axis=data_axis,
            tile_axis=tile_axis)

        def step_fn(scene, cams_b, targets_b, active_sh=None):
            cams_b, targets_b = shard_batch(cams_b, targets_b, mesh,
                                            data_axis, tile_axis)
            return sharded_step(scene, cams_b, targets_b, active_sh)

        return step_fn

    step_fn = build_step(cfg)
    # Staged capacity: 'full' -> (tighten at densify_until) -> 'tight' ->
    # (regrow on overflow) -> 'regrown' (terminal).
    capacity_stage = "full"
    tight_cfg: RenderConfig | None = None

    num_views = targets.shape[0]
    rng = np.random.default_rng(seed)
    metrics = []
    t_last = time.time()
    # Device-side accumulators, read only at log rows and at the tighten.
    ovf_any = torch.zeros((), dtype=torch.bool, device=dev)
    int_max = torch.zeros((), dtype=torch.int32, device=dev)
    grads_ok = torch.ones((), dtype=torch.bool, device=dev)
    grads_leaf_ok = None  # (L,) accumulated per-field finite flags
    tier_max = None       # (T,) peak pool-tier membership (worst view)

    def check_overflow(at_step):
        nonlocal ovf_any, int_max, capacity_stage, step_fn
        if overflow_policy == "ignore" or not bool(ovf_any):
            return
        demand = int(int_max)
        if capacity_stage == "tight" and tight_cfg is not None:
            # Any overflow under the tightened config (stream demand or a
            # tightened pool) regrows instead of aborting. Gradients of at
            # most log_every steps were truncated.
            say(
                f"WARNING: staged capacity overflowed at step <= {at_step} "
                f"(stream demand {demand} vs tightened "
                f"{tight_cfg.max_intersections}; or a tightened pool); "
                f"rebuilding the step at the original sizing"
            )
            step_fn = build_step(cfg)
            capacity_stage = "regrown"
            ovf_any = torch.zeros_like(ovf_any)
            int_max = torch.zeros_like(int_max)
            return
        if demand > cfg.max_intersections:
            cause = (
                f"measured demand {demand} > capacity "
                f"{cfg.max_intersections}; re-run with max_intersections "
                f">= {int(demand * 1.15)}"
            )
        else:
            cause = (
                f"stream demand {demand} fits capacity "
                f"{cfg.max_intersections}, so a tier pool saturated or a "
                f"splat's tile rect exceeded max_tiles_per_gaussian="
                f"{cfg.max_tiles_per_gaussian}; raise the tier budgets / "
                f"K_max, or prune big splats (fit(densify_max_scale=...), "
                f"the 3DGS 5.2 rule)"
            )
        msg = (
            f"capacity overflow during step <= {at_step}: {cause}. "
            f"Gradients were truncated."
        )
        if overflow_policy == "raise":
            raise RuntimeError(msg)
        say(f"WARNING: {msg}")
        ovf_any = torch.zeros_like(ovf_any)
        int_max = torch.zeros_like(int_max)

    # Scene-health guard: liveness checks on the eval rows turn a dead or
    # NaN scene that would otherwise train silently to the end into an
    # early diagnosis.
    eval_hist: list[dict] = []
    alive_first: int | None = None

    def check_scene_health(row, at_step):
        nonlocal alive_first
        if overflow_policy == "ignore":
            return
        problems = []
        alive = row.get("alive")
        if alive is not None:
            if alive_first is None:
                alive_first = max(int(alive), 1)
            elif int(alive) < max(64, alive_first // 100):
                problems.append(
                    f"alive-Gaussian count collapsed to {alive} "
                    f"(first eval: {alive_first})"
                )
        eval_hist.append(row)
        metric = next(
            (k for k in ("holdout_psnr", "train_psnr") if k in row), None
        )
        if metric is not None and len(eval_hist) >= 3:
            vals = [r.get(metric) for r in eval_hist[-3:]]
            if (
                all(v is not None for v in vals)
                and max(vals) - min(vals) < 1e-3
                and vals[-1] < 15.0
            ):
                problems.append(
                    f"{metric} frozen at {vals[-1]} dB for 3 consecutive "
                    "evals (the rendered image is not changing; a dead/NaN "
                    "scene otherwise trains silently to the end)"
                )
        if problems:
            msg = (
                f"scene-health collapse detected at step {at_step}: "
                + "; ".join(problems)
            )
            if overflow_policy == "raise":
                raise RuntimeError(msg)
            say(f"WARNING: {msg}")

    # Epoch-shuffled view sampling: a reshuffled stack of the views each
    # epoch (uniform draws with replacement can starve views).
    view_queue: list[int] = []

    def next_views(k: int):
        nonlocal view_queue
        out = []
        while len(out) < k:
            if not view_queue:
                view_queue = [int(v) for v in rng.permutation(num_views)]
            out.append(view_queue.pop())
        return out

    # Resume fast-forward: replay the draws of steps [0, start_step), so a
    # resumed run samples the same views as an uninterrupted one. The
    # densification accumulator is not checkpointed: the first window after
    # a resume averages over fewer steps.
    for _ in range(start_step):
        next_views(batch)

    prof = None
    for it in range(start_step, steps):
        if trace_dir and trace_steps and it == trace_steps[0]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(dev)
            prof = profile(activities=acts)
            prof.__enter__()
        if prof is not None and it == trace_steps[1]:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            prof = None
            print(f"trace written to {trace_dir}")
        sel = next_views(batch)
        cams_b = [cameras[i] for i in sel]
        targets_b = torch.stack([targets[i] for i in sel])
        active_sh = (
            min(scene.sh_degree, it // sh_warmup_every)
            if sh_warmup_every else None
        )
        loss, aux, (screen_grads, visible) = step_fn(
            scene, cams_b, targets_b, active_sh
        )
        ovf_any = ovf_any | aux["overflow"]
        tm = aux["tier_members"]
        if tm.shape[0]:
            tier_max = tm if tier_max is None else torch.maximum(tier_max, tm)
        grads_ok = grads_ok & aux["grads_finite"]
        grads_leaf_ok = (
            aux["grads_finite_leaves"] if grads_leaf_ok is None
            else grads_leaf_ok & aux["grads_finite_leaves"]
        )
        int_max = torch.maximum(int_max, aux["num_intersections"])
        until = densify_until if densify_until is not None else steps // 2
        if densify_every:
            dstate = accumulate_grads(dstate, screen_grads, visible)
            if (
                (it + 1) % densify_every == 0
                and densify_from <= it + 1 <= until
            ):
                new_scene, dstate, changed, dstats = densify_and_prune_jit(
                    scene, dstate, grad_threshold=densify_grad_threshold,
                    max_world_scale=densify_max_scale,
                )
                _assign(params, new_scene)
                # Moments survive for untouched slots; killed and new slots
                # start cold.
                mask_opt_moments(optimizer, changed)
                say({k: int(v) if k != "saturated" else bool(v)
                     for k, v in dstats.items()} | {"densify_at": it + 1})
        if (
            retighten_capacity
            and capacity_stage == "full"
            and it + 1 >= until
            # Peak demand is a max over the sampled views: wait one epoch
            # past the segment start, so that every view contributed.
            and it + 1 >= start_step + -(-num_views // batch)
        ):
            # Densification is over, the stream stops growing: rebuild at
            # retighten_capacity x the measured peak demand (rounded up to
            # a multiple of 2048).
            demand_now = int(int_max)
            new_max = int(demand_now * retighten_capacity)
            new_max += (-new_max) % 2048
            new_spec = None
            peak = (None if tier_max is None
                    else [int(x) for x in tier_max.tolist()])
            if peak is not None and cfg.binning == "tiered":
                plan = _normalize_tier_plan(
                    cfg.tier_spec, cfg.max_tiles_per_gaussian, n_cap
                )
                spec, mi = [], 0
                for k_lo, k_hi, budget in plan:
                    if budget is None:
                        spec.append((k_hi, 0))
                        continue
                    rows = int(peak[mi] * retighten_capacity) + 256
                    mi += 1
                    spec.append((k_hi, max(1, n_cap // rows)))
                new_spec = tuple(spec)
            if 0 < new_max < cfg.max_intersections or (
                new_spec is not None and new_spec != tuple(cfg.tier_spec)
            ):
                tight_cfg = dataclasses.replace(
                    cfg,
                    max_intersections=min(
                        new_max or cfg.max_intersections,
                        cfg.max_intersections,
                    ),
                    **({"tier_spec": new_spec}
                       if new_spec is not None else {}),
                )
                say(
                    f"staged capacity: tightening max_intersections "
                    f"{cfg.max_intersections} -> "
                    f"{tight_cfg.max_intersections} and tier_spec "
                    f"{cfg.tier_spec} -> {tight_cfg.tier_spec} at step "
                    f"{it + 1} ({retighten_capacity}x peak demand "
                    f"{demand_now}, peak members {peak}; the step is "
                    "rebuilt)"
                )
                step_fn = build_step(tight_cfg)
                capacity_stage = "tight"
            else:
                capacity_stage = "regrown"  # nothing to gain; don't retry
        if opacity_reset_every and (it + 1) % opacity_reset_every == 0 \
                and it + 1 < steps:
            _assign(params, reset_opacity(detached()))
            _zero_opacity_moments(optimizer)
        if (it + 1) % log_every == 0 or it + 1 == steps:
            check_overflow(it + 1)
            if not bool(grads_ok):
                bad = [
                    name for name, ok in zip(SCENE_FIELDS,
                                             grads_leaf_ok.tolist())
                    if not ok
                ] if grads_leaf_ok is not None else []
                msg = (
                    f"non-finite gradients during step <= {it + 1} in "
                    f"{bad or 'unknown leaves'}: a "
                    "NaN/inf parameter cascades through the whole scene "
                    "within a few steps (the fit is unrecoverable). "
                    "Typical causes: degenerate quats/scales, a custom "
                    "loss without stabilizers."
                )
                if overflow_policy == "raise":
                    raise FloatingPointError(msg)
                say(f"WARNING: {msg}")
                grads_ok = torch.ones_like(grads_ok)
                grads_leaf_ok = None
            loss = float(loss)
            dt = time.time() - t_last
            t_last = time.time()
            its = log_every / dt if it + 1 != start_step + 1 else 1.0 / dt
            row = {"step": it + 1, "loss": round(loss, 6),
                   "it_per_s": round(its, 3)}
            if eval_every and eval_fn is not None and (
                (it + 1) % eval_every == 0 or it + 1 == steps
            ):
                row.update(eval_fn(detached(), it + 1) or {})
                check_scene_health(row, it + 1)
                t_last = time.time()  # eval time is not billed to it/s
            metrics.append(row)
            say(row if on_metrics is None else on_metrics(row))
            if metrics_csv and primary:
                _append_csv_row(metrics_csv, row)
        if checkpoint_every and (it + 1) % checkpoint_every == 0:
            path = os.path.join(checkpoint_dir, f"ckpt_{it + 1:06d}.npz")
            if primary:
                save_checkpoint(path, scene, optimizer, it + 1)
                print(f"checkpoint -> {path}")
            if mesh is not None:
                # Every rank goes on once the file is written.
                from gsplat_tpu_torch.parallel.sharding import all_reduce

                all_reduce(torch.zeros((1,), device=dev), mesh)
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"trace written to {trace_dir}")
    return detached(), metrics


def place_init(means: torch.Tensor, center, radius: float) -> torch.Tensor:
    """`train_from_cli`'s start near the target's spatial distribution: the
    init cloud `means` centred on the target's centre and scaled so that
    its 90th-percentile radius is radius / 2.5, the target's own.

    The JAX command computes means * radius / 2.5 + center, the same map
    for a cloud centred on the origin with a 90th-percentile radius of 1.
    random_scene's cloud lies in front of the origin (z in [2, 6]), so that
    map moves its centre 1.6 radius along z (4 radius / 2.5), across the
    orbit, and scales its spread by its own 90th-percentile radius: at
    1920x1080 some orbit views start inside it, with rects past K_max (an
    overflow under 'raise' at the first step). This map keeps the intent
    for any cloud."""
    spread = means - means.mean(0)
    p90 = float(torch.quantile(torch.linalg.vector_norm(
        spread, dim=-1).cpu(), 0.9))
    return spread * (radius / 2.5 / p90) + torch.as_tensor(
        center, dtype=torch.float32, device=means.device)


def train_from_cli(args) -> int:
    """Backs the `train` subcommand of `gsplat_tpu_torch.cli`: fit a fresh
    random scene to orbit renders of a target scene (a synthetic one, or a
    PLY). The scenes are drawn from torch generators seeded args.seed and
    args.seed + 1, so they differ from the JAX command's."""
    from gsplat_tpu_torch.cli import _build_cfg, _load_scene
    from gsplat_tpu_torch.io.ply import save_ply
    from gsplat_tpu_torch.models.gaussians import random_scene
    from gsplat_tpu_torch.ops.camera import orbit_cameras
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.train.losses import psnr as psnr_fn

    dev = torch.device(args.device)
    cfg = _build_cfg(args, args.width, args.height)
    target_scene = _load_scene(args)

    means = target_scene.means.cpu().numpy()
    center = means.mean(0)
    radius = float(
        np.percentile(np.linalg.norm(means - center, axis=-1), 90) * 2.5
    )
    holdout = getattr(args, "holdout_views", 0)
    total_views = args.views + holdout
    all_cams = orbit_cameras(
        center, radius, total_views, cfg.width, cfg.height,
        fx=float(cfg.width), fy=float(cfg.height), device=dev,
    )
    print(f"rendering {total_views} target views "
          f"({args.views} train + {holdout} held-out)...")
    # Targets and evals through render_jit, as the JAX command jits them.
    all_targets = torch.stack([render_jit(target_scene, c, cfg).image
                               for c in all_cams])
    # Interleave the held-out views so they sample the whole orbit, like
    # taking every Nth image of a capture (the graphdeco -eval convention).
    idx = np.arange(total_views)
    hold_idx = idx[:: total_views // holdout][:holdout] if holdout else idx[:0]
    train_idx = np.setdiff1d(idx, hold_idx)
    cams = [all_cams[i] for i in train_idx]
    targets = all_targets[torch.as_tensor(train_idx, device=dev)]

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    init = random_scene(target_scene.num_gaussians,
                        sh_degree=target_scene.sh_degree, generator=gen,
                        device=dev)
    init.means = place_init(init.means, center, radius)
    if args.densify_every:
        capacity = args.capacity or 2 * init.num_gaussians
        init = init.pad_to(capacity)

    eval_fn = None
    if holdout:
        def eval_fn(scene_now, step):
            vals = [float(psnr_fn(render_jit(scene_now, all_cams[i],
                                             cfg).image, all_targets[i]))
                    for i in hold_idx]
            tr = float(psnr_fn(render_jit(scene_now, cams[0], cfg).image,
                               targets[0]))
            return {
                "holdout_psnr": round(float(np.mean(vals)), 3),
                "train_psnr": round(tr, 3),
            }

    trained, metrics = fit(
        init, cams, targets, cfg,
        steps=args.steps, lr=args.lr, seed=args.seed,
        batch=args.batch,
        ssim_weight=args.ssim_weight,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        densify_every=args.densify_every,
        densify_grad_threshold=args.densify_grad_threshold,
        densify_from=getattr(args, "densify_from", 0),
        densify_until=args.densify_until,
        densify_max_scale=args.densify_max_scale,
        opacity_reset_every=args.opacity_reset_every,
        overflow_policy=args.overflow_policy,
        sh_warmup_every=args.sh_warmup_every,
        position_lr_final_ratio=args.position_lr_final_ratio,
        metrics_csv=args.metrics_csv,
        eval_every=args.eval_every,
        eval_fn=eval_fn,
        retighten_capacity=args.retighten_capacity,
    )
    final_psnr = float(
        psnr_fn(render_jit(trained, cams[0], cfg).image, targets[0]))
    print(f"final view-0 PSNR: {final_psnr:.2f} dB")
    if eval_fn is not None:
        print(f"final held-out metrics: {eval_fn(trained, args.steps)}")
    save_ply(trained, args.out)
    print(f"saved {args.out}")
    return 0
