"""Adaptive density control (densify / prune) on a static capacity (port of
`gsplat_tpu.train.densify`).

The scene lives in a fixed-capacity buffer (`GaussianScene.pad_to`) whose
dead slots are fully transparent (opacity logit -30) and never contribute
to the image or the gradients. A round of densification is a masked slot
allocation with no change of shape:
  prune:  opacity < min_opacity -> slot freed;
  split:  trigger & max scale > split_size -> two children at scale / 1.6,
          displaced +/- one sigma along the major axis; parent slot freed;
  clone:  trigger & max scale <= split_size -> a copy nudged along the
          major axis;
with children written into the freed and padding slots by rank matching.
The trigger is the screen-space positional gradient averaged over the
steps each Gaussian was visible (Kerbl et al. 2023, section 5.2).

Every function returns new tensors and leaves its inputs as they are (the
JAX functions are pure); `fit` writes the results into the optimizer's
parameters. `mask_opt_moments` is the exception: it scales a `SceneAdam`'s
moments in place. The scatters of the JAX module drop index C (`mode=
"drop"`); here they write into one extra row that is sliced off, so the
index is never clamped into slot C - 1.

`densify_and_prune_jit` dispatches a round as one program, as the JAX fit
jits `densify_and_prune`: a CUDA graph on the card (`utils/graphs.py`),
the same body eagerly on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.projection import quat_to_rotmat
from gsplat_tpu_torch.utils.graphs import Captured

DEAD_OPACITY_LOGIT = -30.0
DEAD_LOG_SCALE = -10.0


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor   # (C,) float32 accumulated ||dL/d_ndc_xy||
    count: torch.Tensor        # () int32 steps accumulated
    visit_count: torch.Tensor  # (C,) int32 steps each Gaussian was visible


def init_densify_state(capacity: int, device="cuda") -> DensifyState:
    return DensifyState(
        grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        visit_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def accumulate_grads(state: DensifyState, screen_grads: torch.Tensor,
                     visible=None) -> DensifyState:
    """Add this step's per-Gaussian screen-space gradient norms.

    screen_grads: (C, 2) d loss / d uv_tap (summed over the view batch),
    converted here to NDC units (d/d_ndc = 0.5 d/d_uv, so the standard 2e-4
    threshold applies). visible: (C,) bool, the steps where the Gaussian
    touched at least one tile; every step when None."""
    norm = 0.5 * torch.linalg.vector_norm(screen_grads.detach(), dim=-1)
    vis = (torch.ones_like(state.visit_count) if visible is None
           else visible.to(torch.int32))
    return DensifyState(
        grad_accum=state.grad_accum + norm,
        count=state.count + 1,
        visit_count=state.visit_count + vis,
    )


def alive_mask(scene: GaussianScene, min_opacity: float = 1.0 / 255.0):
    return torch.sigmoid(scene.opacity_logits.detach()) >= min_opacity


def _quat_rotmat(quats: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(quats)


def _drop_scatter(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """dst with dst[idx] = vals, where idx == len(dst) is dropped (the JAX
    `.at[idx].set(vals, mode="drop")` for indices in [0, len(dst)]): written
    into an extra row that is sliced off."""
    c = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    buf[idx] = vals
    return buf[:c]


@torch.no_grad()
def densify_and_prune(
    scene: GaussianScene,
    state: DensifyState,
    grad_threshold: float = 2e-4,
    split_size: float = 0.01,
    min_opacity: float = 1.0 / 255.0,
    split_scale_down: float = 1.6,
    max_world_scale: float | None = None,
):
    """One densification round. Returns (scene, fresh DensifyState, changed
    (C,) bool, stats dict of device scalars).

    max_world_scale, when set, prunes Gaussians whose largest axis exceeds
    it (the 3DGS section 5.2 big-splat removal). The capacity C is kept; no
    host synchronisation."""
    scene = GaussianScene(**{f.name: getattr(scene, f.name).detach()
                             for f in dataclasses.fields(scene)})
    c = scene.num_gaussians
    dev = scene.means.device
    avg_grad = state.grad_accum / torch.clamp_min(state.visit_count, 1).to(
        torch.float32)
    alive = alive_mask(scene, min_opacity)
    max_scale = torch.exp(scene.log_scales.max(dim=-1).values)

    trigger = alive & (avg_grad > grad_threshold)
    split_want = trigger & (max_scale > split_size)
    clone_want = trigger & ~split_want

    # Admission against the free-slot budget: each admitted op nets +1 slot
    # (a split frees its parent and places 2 children; a clone places 1), so
    # at most free0 ops fit, free0 counting the slots freed by pruning
    # alone. Ops past the budget are not performed: their parents survive.
    big = ((max_scale > max_world_scale) if max_world_scale is not None
           else torch.zeros_like(alive))
    pruned = (~alive) | (alive & big & ~split_want)
    free0 = pruned.sum()
    want = trigger & ~pruned
    # Ranked by accumulated gradient; big splats that want a split first.
    # The sort is stable, as jnp.argsort is: equal scores at the cutoff are
    # admitted in slot order.
    score = avg_grad + torch.where(big & split_want, 1e9, 0.0)
    order = torch.argsort(torch.where(want, -score, math.inf), stable=True)
    adm_rank = torch.empty((c,), dtype=torch.int64, device=dev)
    adm_rank[order] = torch.arange(c, device=dev)
    admitted = want & (adm_rank < free0)
    split = split_want & admitted
    clone = clone_want & admitted
    saturated = want.sum() > free0
    # A big splat whose split was not admitted is pruned outright (the hard
    # 5.2 bound); it only enlarges the free pool.
    big_unadmitted = big & split_want & ~admitted

    # Children: column j of the (C, 2) specs is the j-th child of slot i;
    # they read the original scene.
    rot = _quat_rotmat(scene.quats)
    axis = scene.log_scales.argmax(dim=-1)
    major_axis = rot.transpose(-1, -2)[torch.arange(c, device=dev), axis]
    offset = major_axis * max_scale[:, None]

    child_want = torch.stack([split | clone, split], dim=1)
    child_means = torch.stack(
        [torch.where(split[:, None], scene.means + offset,
                     scene.means + 0.01 * offset),
         scene.means - offset],
        dim=1,
    )
    # log of the float32 factor, in float32, computed on the host: a copy
    # of it to the card would be a host copy inside a captured round.
    scale_down = float(torch.log(torch.tensor(split_scale_down,
                                              dtype=torch.float32)))
    child_ls = torch.where(
        split[:, None, None],
        scene.log_scales[:, None, :] - scale_down,
        scene.log_scales[:, None, :],
    ).repeat(1, 2, 1)

    # Prune and free the split parents.
    dead = pruned | split | big_unadmitted

    def kill(x, fill):
        return torch.where(dead.reshape((c,) + (1,) * (x.ndim - 1)),
                           torch.full_like(x, fill), x)

    killed_quats = kill(scene.quats, 0.0)
    killed_quats[:, 0] = torch.where(dead, 1.0, scene.quats[:, 0])
    killed = GaussianScene(
        means=kill(scene.means, 0.0),
        log_scales=kill(scene.log_scales, DEAD_LOG_SCALE),
        quats=killed_quats,
        opacity_logits=kill(scene.opacity_logits, DEAD_OPACITY_LOGIT),
        sh=kill(scene.sh, 0.0),
    )

    # Slot allocation: the r-th child takes the r-th free slot. Admission
    # guarantees 2 splits + clones <= num_free: no child is dropped.
    free = dead
    free_rank = torch.cumsum(free, 0) - 1
    num_free = free.sum()
    child_flat = child_want.reshape(-1)
    child_rank = torch.cumsum(child_flat, 0) - 1
    arange_c = torch.arange(c, device=dev)
    slot_of_rank = _drop_scatter(
        torch.full((c,), c, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, c), arange_c)
    dest = torch.where(
        child_flat & (child_rank < num_free),
        slot_of_rank[torch.clamp(child_rank, 0, c - 1)],
        c,
    )

    def place(dst, child_vals):
        return _drop_scatter(
            dst, dest, child_vals.reshape((2 * c,) + child_vals.shape[2:]))

    new_scene = GaussianScene(
        means=place(killed.means, child_means),
        log_scales=place(killed.log_scales, child_ls),
        quats=place(killed.quats, scene.quats[:, None, :].repeat(1, 2, 1)),
        opacity_logits=place(killed.opacity_logits,
                             scene.opacity_logits[:, None].repeat(1, 2)),
        sh=place(killed.sh, scene.sh[:, None].repeat(1, 2, 1, 1)),
    )

    # Slots whose content changed: killed, or written by a child. The Adam
    # moments of every other slot stay valid.
    received = _drop_scatter(torch.zeros((c,), dtype=torch.bool, device=dev),
                             dest, torch.ones_like(dest, dtype=torch.bool))
    changed = dead | received

    stats = dict(
        num_alive=alive_mask(new_scene, min_opacity).sum(),
        num_split=split.sum(),
        num_clone=clone.sum(),
        num_free_before=num_free,
        saturated=saturated,
    )
    return new_scene, init_densify_state(c, dev), changed, stats


# The captured densification rounds, keyed by their settings and shapes.
DENSIFY_GRAPHS = Captured("densify")


def densify_and_prune_jit(scene: GaussianScene, state: DensifyState,
                          **settings):
    """`densify_and_prune(scene, state, **settings)` dispatched as one
    program (the JAX fit's `jax.jit(densify_and_prune)`): on a CUDA device
    a CUDA graph captured on the first call for (settings, shapes, the
    scene's addresses) and replayed after; the scene is read where it lies
    (`fit`'s parameters), the state copied into the graph's buffers. On the
    CPU the same body eagerly. Returns fresh tensors."""
    fields = [f.name for f in dataclasses.fields(scene)]
    inputs = [getattr(scene, f) for f in fields] + [
        state.grad_accum, state.count, state.visit_count]

    def body(*flat):
        return densify_and_prune(
            GaussianScene(**dict(zip(fields, flat[:len(fields)]))),
            DensifyState(*flat[len(fields):]), **settings)

    return DENSIFY_GRAPHS(tuple(sorted(settings.items())), inputs, body,
                          held=len(fields))


@torch.no_grad()
def mask_opt_moments(optimizer, changed: torch.Tensor) -> None:
    """Zero the Adam moments of a `SceneAdam` at `changed` slots, in place,
    keeping them everywhere else. Multiplied by the 0/1 mask as the JAX
    function does, so a NaN moment at a changed slot stays NaN. The Adam
    step counts are left alone, as optax's count is."""
    c = changed.shape[0]
    keep = (~changed).to(torch.float32)
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if not st:
                continue
            for k in ("exp_avg", "exp_avg_sq"):
                m = st[k]
                if m.ndim >= 1 and m.shape[0] == c and m.is_floating_point():
                    m.mul_(keep.reshape((c,) + (1,) * (m.ndim - 1)).to(m.dtype))


def reset_opacity(scene: GaussianScene, ceiling: float = 0.01) -> GaussianScene:
    """Periodic opacity reset (Kerbl section 5.2): opacity clamped below a
    small ceiling, so that the next prune can cull floaters the optimizer
    has pushed opaque. Dead slots stay dead."""
    logits = scene.opacity_logits.detach()
    c = torch.tensor(ceiling, dtype=torch.float32)
    cap = float(torch.log(c) - torch.log1p(-c))  # logit(ceiling), float32
    dead = logits <= DEAD_OPACITY_LOGIT
    return dataclasses.replace(
        scene, opacity_logits=torch.where(dead, logits,
                                          torch.clamp_max(logits, cap)))
