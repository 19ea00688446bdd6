"""The single-device training step: forward, L1 + DSSIM loss, backward
through kernels K2 and K4, and an Adam update (port of
`gsplat_tpu.train.loop.make_train_step` and `sh_band_mask`, and of
`gsplat_tpu.parallel.train_step.make_optimizer`).

Where the JAX step is a pure function of a train state, the port's step
updates the scene's tensors in place: they are the optimizer's parameters
(leaf tensors with requires_grad), as torch optimizers hold them. Each
phase runs inside a `torch.profiler.record_function` span named in
`TRAIN_SPANS` (`scripts/profile_torch_train.py` reads them).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.profiler import record_function

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.binning import _normalize_tier_plan
from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS, render_with_projection
from gsplat_tpu_torch.train.losses import rgb_loss

# The profiler spans of a train step (a view's forward and loss spans
# repeat once per view).
TRAIN_SPANS = ("train.forward", "train.loss", "train.backward",
               "train.optimizer")

# Learning-rate multipliers of the graphdeco recipe: positions slower than
# colour and opacity.
LR_SCALES = dict(means=0.016, log_scales=0.5, quats=0.1, opacity_logits=5.0,
                 sh=0.25)


def sh_band_mask(num_coeffs: int, active_degree, device="cuda") -> torch.Tensor:
    """(K, 1) float mask keeping the SH bands <= active_degree. The band of
    coefficient j is floor(sqrt(j)), computed with an integer sqrt so there
    is no float edge at j = 1, 4, 9."""
    band = torch.tensor([math.isqrt(j) for j in range(num_coeffs)],
                        dtype=torch.int32, device=device)
    return (band <= torch.as_tensor(active_degree, device=device)).to(
        torch.float32)[:, None]


class SceneAdam(torch.optim.Adam):
    """`torch.optim.Adam` with one parameter group per scene field (named
    by the group's "name") and an optional schedule for the "means" group:
    `means_lr_at(t)` is the learning rate of the update t = 0, 1, ..."""

    def __init__(self, groups, means_lr_at=None):
        # optax.adam's defaults, which are torch's: eps outside the sqrt.
        super().__init__(groups, betas=(0.9, 0.999), eps=1e-8)
        self.means_lr_at = means_lr_at
        self.updates = 0

    def step(self, closure=None):
        if self.means_lr_at is not None:
            for group in self.param_groups:
                if group["name"] == "means":
                    group["lr"] = self.means_lr_at(self.updates)
        loss = super().step(closure)
        self.updates += 1
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
    means_lr = lr * LR_SCALES["means"]
    means_lr_at = None
    if position_lr_final_ratio is not None:
        if not lr_max_steps:
            raise ValueError("position_lr_final_ratio requires lr_max_steps")
        ratio = float(position_lr_final_ratio)
        end = means_lr * ratio
        clip = max if ratio < 1.0 else min

        def means_lr_at(t: int) -> float:
            return clip(means_lr * ratio ** (t / lr_max_steps), end)

    groups = []
    for name in SCENE_FIELDS:
        param = getattr(scene, name)
        if not param.is_leaf:
            raise ValueError(f"make_optimizer: scene.{name} is not a leaf "
                             "tensor; pass a scene of plain tensors")
        param.requires_grad_(True)
        groups.append(dict(params=[param], lr=lr * LR_SCALES[name], name=name))
    return SceneAdam(groups, means_lr_at)


def make_train_step(cfg: RenderConfig, optimizer: SceneAdam,
                    ssim_weight: float = 0.2):
    """Single-device train step over a small batch of views, unrolled (one
    render per view, as the JAX step unrolls its batch).

    Returns step(scene, cameras, targets, active_sh_degree=None) ->
    (loss, aux, (tap_grads, visible)), where scene's tensors are the
    optimizer's parameters and are updated in place:
      cameras: a sequence of B `Camera`s; targets: (B, H, W, 3) images;
      active_sh_degree: SH bands above it are masked out of the loss (and
           get zero gradient), graphdeco's progressive SH activation;
      loss: () the mean over views of the L1 + DSSIM loss, before the update;
      aux: device tensors, no host read: "overflow" (any view), the largest
           "num_intersections" of the views, "grads_finite" and the per-
           field "grads_finite_leaves" (SCENE_FIELDS order), and
           "tier_members" (members of each pool tier, worst view);
      tap_grads: (N, 2) d loss / d uv_tap, the screen-space positional
           gradient of the densification trigger;
      visible: (N,) bool, Gaussian touched >= 1 tile in >= 1 view.
    The gradients stay in each parameter's `.grad` after the step."""
    tier_klos = tuple(
        k_lo for k_lo, _, budget in _normalize_tier_plan(
            cfg.tier_spec, cfg.max_tiles_per_gaussian, 1)
        if budget is not None
    ) if cfg.binning == "tiered" else ()
    params = [group["params"][0] for group in optimizer.param_groups]

    def step(scene: GaussianScene, cameras, targets, active_sh_degree=None):
        if any(getattr(scene, f) is not p for f, p in zip(SCENE_FIELDS, params)):
            raise ValueError("train step: the scene's tensors are not the "
                             "optimizer's parameters")
        dev = scene.means.device
        optimizer.zero_grad(set_to_none=True)
        tap = torch.zeros((scene.num_gaussians, 2), device=dev,
                          requires_grad=True)
        if active_sh_degree is not None:
            scene = dataclasses.replace(scene, sh=scene.sh * sh_band_mask(
                scene.sh.shape[1], active_sh_degree, dev))
        losses, overflow, n_int, visible, members = [], [], [], [], []
        for camera, target in zip(cameras, targets):
            with record_function("train.forward"):
                out, proj = render_with_projection(scene, camera, cfg,
                                                   uv_tap=tap)
            with record_function("train.loss"):
                losses.append(rgb_loss(out.image, target, ssim_weight))
            overflow.append(out.overflow)
            n_int.append(out.num_intersections)
            visible.append(proj.counts > 0)
            members.append(torch.stack(
                [(out.gauss_counts > k).sum(dtype=torch.int32)
                 for k in tier_klos]) if tier_klos
                else torch.zeros((0,), dtype=torch.int32, device=dev))
        with record_function("train.loss"):
            loss = torch.stack(losses).mean()
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
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

    return step
