"""Gaussian-sharded training (port of `gsplat_tpu.parallel.gaussian_train`):
the scene and Adam's state are both sharded over the mesh's Gaussian axis,
so no rank holds more than N/D parameters, moments or gradients.

Layout on a ('gauss',) mesh of D ranks, one process each:
  - scene, Adam moments, densification accumulators: rank k holds rows
    [k C/D, (k + 1) C/D) of the capacity C, which must divide by D;
  - cameras: alike on every rank; targets: (B, band_h, padded_W, 3), the
    rows of the rank's own image band;
  - gradients land on their own shard through the exchange's transpose; no
    parameter is reduced. The collectives of a step: the fragment
    all_to_alls forward and back, the SSIM halo all_gathers, and the loss
    and overflow scalars;
  - densification runs per shard on the static local capacity C/D: a child
    lands in its parent's shard. The stats are summed over the shards and
    `saturated` is any shard's.

Checkpoints are per shard (`save_sharded_checkpoint`): each rank writes its
own rows to `shard_{k:05d}.npz`, the primary rank the step and the
scalars to `meta.npz`; no rank ever gathers the whole state.

The step and the densification round are each one CUDA graph per rank on
an NCCL mesh, collectives inside (`make_gaussian_sharded_train_step`,
`make_gaussian_sharded_densify`); the `make_eager_*` functions run the same
bodies op by op.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.parallel.gaussian_sharded import (
    _shard_render,
    _src_cfg_for,
    shard_rows,
    shard_scene,
)
from gsplat_tpu_torch.parallel.sharding import (
    Mesh,
    all_reduce,
    any_flag,
    local_tile_cfg,
)
from gsplat_tpu_torch.parallel.train_step import (
    band_loss,
    band_mask,
    check_band_height,
)
from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
from gsplat_tpu_torch.train.densify import DensifyState, densify_and_prune
from gsplat_tpu_torch.train.loop import (
    captured_step,
    check_params,
    make_optimizer,
    zero_grads_,
)
from gsplat_tpu_torch.utils.checkpoint import (
    atomic_savez,
    checkpoint_arrays,
    restore_arrays,
)
from gsplat_tpu_torch.utils.graphs import Captured

# The arrays of a checkpoint that are not per slot (held by meta.npz).
_SCALAR_KEYS = ("adam.updates", "step") + tuple(
    f"adam.{f}.step" for f in SCENE_FIELDS)


def shard_train_state(scene: GaussianScene, mesh: Mesh, axis_name="gauss",
                      lr: float = 1e-2, optimizer=None, **opt_kw):
    """This rank's shard of a whole scene and a `SceneAdam` over it: fresh,
    or carrying the rows of `optimizer`'s moments (a `SceneAdam` over the
    whole scene) and its step counts. Returns (scene shard, optimizer)."""
    local = shard_scene(scene, mesh, axis_name)
    opt = make_optimizer(local, lr, **opt_kw)
    if optimizer is not None:
        arrays = checkpoint_arrays(scene, optimizer, 0)
        arrays = {k: v if k in _SCALAR_KEYS else
                  shard_rows(torch.from_numpy(v), mesh, axis_name).numpy()
                  for k, v in arrays.items()}
        restore_arrays(arrays, local, opt)
    return local, opt


def _gaussian_step_body(cfg: RenderConfig, mesh: Mesh, optimizer,
                        capacity: int, ssim_weight: float, axis_name: str,
                        per_dest_capacity: int | None):
    """(body, params) of the Gaussian-sharded step: body(scene, cameras,
    targets) -> (metrics, (tap_grads, visible)). The band's pixel mask and
    the `tap` leaf are made once and the gradients zeroed and accumulated
    in place, so that a capture reads them at fixed addresses."""
    d = mesh.size_of(axis_name)
    lcfg = local_tile_cfg(cfg, d)
    if capacity % d != 0:
        raise ValueError(f"capacity {capacity} not divisible by {d} shards")
    cap = per_dest_capacity or max(cfg.max_intersections // d, 1)
    src_cfg = _src_cfg_for(cfg)
    align = cfg.stream_align or 1
    check_band_height(lcfg, ssim_weight)
    params = [group["params"][0] for group in optimizer.param_groups]
    dev = params[0].device
    mask = band_mask(cfg, lcfg, mesh.index(axis_name), dev)
    tap = torch.zeros((params[0].shape[0], 2), device=dev,
                      requires_grad=True)

    def body(scene: GaussianScene, cameras, targets):
        zero_grads_(optimizer, tap)
        losses, overflow, visible = [], [], []
        for camera, target_band in zip(cameras, targets):
            img, _, ovf, vis = _shard_render(
                scene, camera, cfg, src_cfg, lcfg, mesh, axis_name, cap,
                align, uv_tap=tap)
            losses.append(band_loss(img, target_band, mask, cfg, lcfg,
                                    mesh, axis_name, ssim_weight))
            overflow.append(ovf)
            visible.append(vis)
        loss = torch.stack(losses).mean()
        loss.backward()
        # The band partials sum to the whole image's loss; the gradients are
        # complete on each shard already: metric-only collectives.
        metrics = {
            "loss": all_reduce(loss.detach(), mesh, axis_name),
            "overflow": any_flag(torch.stack(overflow).any(), mesh,
                                 axis_name),
        }
        optimizer.step()
        return metrics, (tap.grad, torch.stack(visible).any(0))

    body.tap = tap
    return body, params


def make_eager_gaussian_sharded_train_step(
    cfg: RenderConfig,
    mesh: Mesh,
    optimizer,
    capacity: int,
    ssim_weight: float = 0.2,
    axis_name: str = "gauss",
    per_dest_capacity: int | None = None,
):
    """`make_gaussian_sharded_train_step`'s step run eagerly, op by op, on
    every backend: the body the captured step captures, with the same
    interface (the tap's gradient copied out of its fixed storage)."""
    body, params = _gaussian_step_body(cfg, mesh, optimizer, capacity,
                                       ssim_weight, axis_name,
                                       per_dest_capacity)

    def step(scene: GaussianScene, cameras, targets):
        check_params(scene, params)
        metrics, (tap_grads, visible) = body(scene, cameras, targets)
        return metrics, (tap_grads.clone(), visible)

    return step


def make_gaussian_sharded_train_step(
    cfg: RenderConfig,
    mesh: Mesh,
    optimizer,
    capacity: int,
    ssim_weight: float = 0.2,
    axis_name: str = "gauss",
    per_dest_capacity: int | None = None,
):
    """Returns step(scene, cameras, targets) -> (metrics, (screen_grads,
    visible)): scene is this rank's shard, whose tensors are `optimizer`'s
    parameters and are updated in place; capacity the whole scene's C.
    cameras: the views of the batch (alike on every rank); targets (B,
    band_h, padded_W, 3) their rows of this rank's band. metrics: "loss"
    (the batch mean, summed over the bands) and "overflow" (any rank);
    screen_grads and visible are this shard's (N/D, 2) and (N/D,), feeding
    its densification accumulator. The JAX function takes an example scene
    for C; here C is given.

    Dispatched as one program per rank, as the JAX step is a `jax.jit` of a
    `shard_map`: on an NCCL mesh on the card a CUDA graph with the fragment
    exchange, the SSIM halo's all_gathers and their transposes and the
    metrics' all_reduces inside, captured on the first call for (cfg, B,
    capacity) and replayed after; on gloo and on the CPU the same body
    eagerly (`utils/graphs.py`)."""
    body, params = _gaussian_step_body(cfg, mesh, optimizer, capacity,
                                       ssim_weight, axis_name,
                                       per_dest_capacity)
    return captured_step(
        body, params, "gaussian_sharded_train_step",
        (cfg, float(ssim_weight), axis_name, per_dest_capacity), mesh)


def make_eager_gaussian_sharded_densify(
    mesh: Mesh,
    axis_name: str = "gauss",
    grad_threshold: float = 2e-4,
    split_size: float = 0.01,
    min_opacity: float = 1.0 / 255.0,
):
    """`make_gaussian_sharded_densify`'s program run eagerly, op by op, on
    every backend: the body its graph captures."""

    def run(scene: GaussianScene, dstate):
        new_scene, fresh, changed, stats = densify_and_prune(
            scene, dstate, grad_threshold=grad_threshold,
            split_size=split_size, min_opacity=min_opacity)
        names = [k for k in stats if k != "saturated"]
        sums = all_reduce(torch.stack([stats[k].to(torch.int64)
                                       for k in names]), mesh, axis_name)
        out = dict(zip(names, sums))
        out["saturated"] = any_flag(stats["saturated"], mesh, axis_name)
        return new_scene, fresh, changed, out

    return run


def make_gaussian_sharded_densify(
    mesh: Mesh,
    axis_name: str = "gauss",
    grad_threshold: float = 2e-4,
    split_size: float = 0.01,
    min_opacity: float = 1.0 / 255.0,
):
    """Per-shard adaptive density control on the static local capacity C/D.
    Returns densify_fn(scene, dstate) -> (scene, fresh dstate, changed,
    stats): children take their parent's shard's free slots only (no
    migration between shards); the stats are summed over the shards,
    `saturated` is any shard's. One program per rank, as the JAX function
    is jitted: on an NCCL mesh on the card a CUDA graph (per shard
    `densify_and_prune` and its two stat reductions) captured on the first
    call for the shard's shapes and replayed after, the scene and the state
    copied into its buffers; on gloo and on the CPU the same body eagerly.
    The outputs are fresh tensors; `densify_fn.graphs` is its cache."""
    run = make_eager_gaussian_sharded_densify(
        mesh, axis_name, grad_threshold, split_size, min_opacity)
    graphs = Captured("gaussian_sharded_densify")
    n = len(SCENE_FIELDS)

    def densify_fn(scene: GaussianScene, dstate):
        inputs = [getattr(scene, f) for f in SCENE_FIELDS] + [
            dstate.grad_accum, dstate.count, dstate.visit_count]

        def body(*flat):
            return run(GaussianScene(*flat[:n]), DensifyState(*flat[n:]))

        return graphs(axis_name, inputs, body, mesh=mesh)

    densify_fn.graphs = graphs
    return densify_fn


def fit_gaussian_sharded(
    scene: GaussianScene,
    cameras,
    targets,
    cfg: RenderConfig,
    mesh: Mesh,
    steps: int = 100,
    lr: float = 1e-2,
    batch: int = 1,
    ssim_weight: float = 0.2,
    seed: int = 0,
    log_every: int = 10,
    densify_every: int = 0,
    densify_grad_threshold: float = 2e-4,
    densify_until: int | None = None,
    axis_name: str = "gauss",
    per_dest_capacity: int | None = None,
    overflow_policy: str = "raise",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
):
    """Gaussian-sharded training loop, called alike by every rank of the
    mesh with the whole scene (whose capacity, padded with
    `GaussianScene.pad_to`, must divide by the axis), the views (a sequence
    of Cameras) and their targets (V, H, W, 3). Returns (this rank's trained
    shard, metrics list). checkpoint_path is a directory of per-shard files
    (`save_sharded_checkpoint`)."""
    from gsplat_tpu_torch.train.densify import (
        accumulate_grads,
        init_densify_state,
        mask_opt_moments,
    )

    if overflow_policy not in ("raise", "warn", "ignore"):
        raise ValueError(f"unknown overflow_policy {overflow_policy!r}")
    d = mesh.size_of(axis_name)
    capacity = scene.num_gaussians
    local, optimizer = shard_train_state(scene, mesh, axis_name, lr)
    params = [getattr(local, f) for f in SCENE_FIELDS]
    step_fn = make_gaussian_sharded_train_step(
        cfg, mesh, optimizer, capacity, ssim_weight=ssim_weight,
        axis_name=axis_name, per_dest_capacity=per_dest_capacity)
    densify_fn = make_gaussian_sharded_densify(
        mesh, axis_name, grad_threshold=densify_grad_threshold)
    dev = local.means.device
    dstate = init_densify_state(local.num_gaussians, dev)

    # Targets padded to the tile grid; each rank keeps its band's rows.
    lcfg = local_tile_cfg(cfg, d)
    band = mesh.index(axis_name)
    padded = torch.nn.functional.pad(
        targets, (0, 0, 0, cfg.padded_width - targets.shape[2], 0,
                  cfg.padded_height - targets.shape[1]))
    bands = padded[:, band * lcfg.height:(band + 1) * lcfg.height]

    rng = np.random.default_rng(seed)
    metrics = []
    v = len(cameras)
    for it in range(steps):
        sel = rng.integers(0, v, size=batch)
        m, (screen_grads, visible) = step_fn(
            local, [cameras[i] for i in sel],
            bands[torch.as_tensor(sel, device=bands.device)])
        if densify_every:
            dstate = accumulate_grads(dstate, screen_grads, visible)
            until = densify_until if densify_until is not None else steps // 2
            if (it + 1) % densify_every == 0 and it + 1 <= until:
                new_scene, dstate, changed, _ = densify_fn(
                    GaussianScene(*(p.detach() for p in params)), dstate)
                with torch.no_grad():
                    for p, f in zip(params, SCENE_FIELDS):
                        p.copy_(getattr(new_scene, f))
                mask_opt_moments(optimizer, changed)
        if (it + 1) % log_every == 0 or it + 1 == steps:
            if bool(m["overflow"]):
                msg = ("gaussian-sharded stream saturated (per-dest capacity "
                       f"{per_dest_capacity or cfg.max_intersections // d}); "
                       "gradients are truncated")
                if overflow_policy == "raise":
                    raise RuntimeError(msg)
                if overflow_policy == "warn" and mesh.rank == 0:
                    print(f"WARNING: {msg}")
            metrics.append({"step": it + 1, "loss": float(m["loss"]),
                            "overflow": bool(m["overflow"])})
        if checkpoint_path and checkpoint_every and (
            (it + 1) % checkpoint_every == 0 or it + 1 == steps
        ):
            save_sharded_checkpoint(checkpoint_path, local, optimizer, it + 1,
                                    mesh, axis_name)
    return GaussianScene(*(p.detach() for p in params)), metrics


def save_sharded_checkpoint(dir_path: str, scene: GaussianScene, optimizer,
                            step: int, mesh: Mesh,
                            axis_name: str = "gauss") -> None:
    """Per-shard checkpoint files, in `utils/checkpoint.py`'s names: this
    rank's rows of every per-slot array to `<dir>/shard_{k:05d}.npz`; the
    step, the Adam step counts and the shard layout to `<dir>/meta.npz`,
    written by the primary rank (rank 0) only. Each rank writes only what
    it holds. Every rank of the axis calls it; it returns when every file
    is written (a collective closes it)."""
    arrays = checkpoint_arrays(scene, optimizer, step)
    k, d = mesh.index(axis_name), mesh.size_of(axis_name)
    atomic_savez(os.path.join(dir_path, f"shard_{k:05d}.npz"),
                 {n: a for n, a in arrays.items() if n not in _SCALAR_KEYS})
    if mesh.rank == 0:
        meta = {n: arrays[n] for n in _SCALAR_KEYS}
        meta["__shards__"] = np.asarray(d)
        meta["__rows__"] = np.asarray(scene.num_gaussians)
        atomic_savez(os.path.join(dir_path, "meta.npz"), meta)
    all_reduce(torch.zeros((1,), device=scene.means.device), mesh, axis_name)


def load_sharded_checkpoint(dir_path: str, scene: GaussianScene, optimizer,
                            mesh: Mesh, axis_name: str = "gauss") -> int:
    """Restore `save_sharded_checkpoint`'s files into this rank's shard (the
    optimizer's parameters, in place) and its Adam state, reading only
    meta.npz and this rank's shard file. Raises ValueError if the
    checkpoint was saved for another shard layout. Returns the step."""
    d = mesh.size_of(axis_name)
    with np.load(os.path.join(dir_path, "meta.npz")) as m:
        meta = {k: m[k] for k in m.files}
    if int(meta["__shards__"]) != d or int(meta["__rows__"]) != \
            scene.num_gaussians:
        raise ValueError(
            f"checkpoint was saved for {int(meta['__shards__'])} shards x "
            f"{int(meta['__rows__'])} rows; mesh wants {d} x "
            f"{scene.num_gaussians}")
    k = mesh.index(axis_name)
    with np.load(os.path.join(dir_path, f"shard_{k:05d}.npz")) as z:
        arrays = {n: z[n] for n in z.files}
    return restore_arrays(arrays | meta, scene, optimizer)


def load_gaussian_sharded_checkpoint(path: str, scene: GaussianScene,
                                     optimizer, mesh: Mesh,
                                     axis_name: str = "gauss") -> int:
    """Restore a single-file checkpoint of the single-device fit
    (`utils/checkpoint.py`) into this rank's shard: its rows of every
    per-slot array. Returns the step."""
    with np.load(path) as z:
        arrays = {n: z[n] if n in _SCALAR_KEYS else
                  shard_rows(torch.from_numpy(z[n]), mesh, axis_name).numpy()
                  for n in z.files}
    return restore_arrays(arrays, scene, optimizer)

