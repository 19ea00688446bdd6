"""The tile-sharded training step: data-parallel over views x tile-parallel
within each view (port of `gsplat_tpu.parallel.train_step`).

Layout on a ('data', 'tiles') mesh, one process per rank:
  - the scene and Adam's state: replicated; every rank applies the same
    update to the same all-reduced gradients, so the copies stay bit for
    bit alike;
  - views: rank (d, t) renders views [d b, (d + 1) b) of the batch, and only
    the tile rows of band t, and holds only that band of their targets
    (`shard_batch`);
  - the loss and the gradients: per-rank partials, summed over both axes in
    one all_reduce of one flat buffer after the backward (the `psum` over
    'tiles' and `pmean` over 'data' of the JAX step), and the flags in one
    int32 MAX all_reduce.

The step is one CUDA graph per rank on an NCCL mesh, collectives inside
(`make_sharded_train_step`); `make_eager_sharded_train_step` runs the same
body op by op.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.parallel.sharding import (
    Mesh,
    _render_local_tiles,
    all_reduce,
    all_reduce_,
    halo_exchange_rows,
    local_tile_cfg,
)
from gsplat_tpu_torch.train.loop import (
    captured_step,
    eager_step,
    masked_step,
    sh_mask_fn,
    zero_grads_,
)
from gsplat_tpu_torch.train.losses import SSIM_HALO, ssim_map
from gsplat_tpu_torch.utils.trace import stage


def band_mask(cfg: RenderConfig, lcfg: RenderConfig, band: int,
              device) -> torch.Tensor:
    """(h, W, 1) float mask of the true image's pixels in tile band `band`
    of the padded image (the ragged edge tiles render pixels outside it)."""
    ys = band * lcfg.height + torch.arange(lcfg.height, device=device)
    xs = torch.arange(lcfg.width, device=device)
    return ((ys[:, None] < cfg.height) & (xs[None, :] < cfg.width))[
        ..., None].to(torch.float32)


def band_loss(img, target_band, mask, cfg: RenderConfig, lcfg: RenderConfig,
              mesh: Mesh, axis: str, ssim_weight: float) -> torch.Tensor:
    """This band's share of the (1 - w) L1 + w DSSIM loss of the whole
    image: the masked L1 over the true pixel count, and the SSIM map of the
    band extended by the neighbours' halo rows, so that the sum of the
    bands' shares is the single-device loss up to summation order."""
    true_pixels = cfg.height * cfg.width * 3
    loss = torch.sum(torch.abs(img - target_band) * mask) / true_pixels
    if ssim_weight > 0.0:
        ext_a = halo_exchange_rows(img * mask, mesh, axis, SSIM_HALO)
        ext_b = halo_exchange_rows(target_band * mask, mesh, axis, SSIM_HALO)
        smap = ssim_map(ext_a, ext_b)[SSIM_HALO: SSIM_HALO + lcfg.height]
        ssim_partial = torch.sum(smap * mask) / true_pixels
        loss = (1.0 - ssim_weight) * loss + ssim_weight * (
            1.0 / mesh.size_of(axis) - ssim_partial)
    return loss


def check_band_height(lcfg: RenderConfig, ssim_weight: float) -> None:
    if ssim_weight > 0.0 and lcfg.height < SSIM_HALO:
        raise ValueError(
            f"tile bands of {lcfg.height} rows are shorter than the SSIM "
            f"halo ({SSIM_HALO}); use fewer tile shards or ssim_weight=0"
        )


def _sharded_step_body(cfg: RenderConfig, mesh: Mesh, optimizer,
                       ssim_weight: float, data_axis: str, tile_axis: str):
    """(body, band_mask, params) of the tile-sharded step, the contract of
    `train.loop._train_step_body`: body(scene, cameras, targets, mask=None)
    -> (loss, aux, (tap_grads, visible)). The state a capture reads at fixed
    addresses is made once: the band's pixel mask, the `tap` leaf, the flat
    all-reduce buffer (every field's gradient, the tap's, the loss); the
    gradients are zeroed and accumulated in place and the all-reduced ones
    copied back into them."""
    n_tiles = mesh.size_of(tile_axis)
    n_data = mesh.size_of(data_axis)
    lcfg = local_tile_cfg(cfg, n_tiles)
    check_band_height(lcfg, ssim_weight)
    params = [group["params"][0] for group in optimizer.param_groups]
    dev = params[0].device
    band = mesh.index(tile_axis)
    mask = band_mask(cfg, lcfg, band, dev)
    n = params[0].shape[0]
    tap = torch.zeros((n, 2), device=dev, requires_grad=True)
    flat = torch.empty((sum(p.numel() for p in params) + 2 * n + 1,),
                       device=dev)

    def body(scene: GaussianScene, cameras, targets, sh_mask=None):
        zero_grads_(optimizer, tap)
        if sh_mask is not None:
            scene = dataclasses.replace(scene, sh=scene.sh * sh_mask)
        losses, overflow, n_int, visible = [], [], [], []
        for camera, target_band in zip(cameras, targets):
            with stage("train.forward"):
                img, _, ovf, ni, proj = _render_local_tiles(
                    scene, camera, cfg, lcfg, band, uv_tap=tap)
            with stage("train.loss"):
                losses.append(band_loss(img, target_band, mask, cfg, lcfg,
                                        mesh, tile_axis, ssim_weight))
            overflow.append(ovf)
            n_int.append(ni)
            visible.append(proj.counts > 0)
        with stage("train.loss"):
            loss = torch.stack(losses).mean()
        with stage("train.backward"):
            loss.backward()
        with stage("train.allreduce"):
            # One flat buffer: every field's gradient, the tap's, the loss;
            # summed over both axes, then averaged over the data shards.
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            torch.cat([g.reshape(-1) for g in grads]
                      + [tap.grad.reshape(-1), loss.detach()[None]], out=flat)
            all_reduce_(flat, mesh).div_(n_data)
            i = 0
            for p, g in zip(params, grads):
                reduced = flat[i:i + g.numel()].view_as(p)
                if p.grad is None:
                    p.grad = reduced.clone()
                else:
                    p.grad.copy_(reduced)
                i += g.numel()
            tap_grads = flat[i:i + 2 * n].view(n, 2)
            flags = torch.cat([
                torch.stack(overflow).any().to(torch.int32)[None],
                torch.stack(n_int).max().to(torch.int32)[None],
                torch.stack(visible).any(0).to(torch.int32)])
            flags = all_reduce(flags, mesh, op="max")
        with stage("train.optimizer"):
            leaf_ok = torch.stack([torch.isfinite(p.grad).all()
                                   for p in params])
            optimizer.step()
        aux = {
            "overflow": flags[0] > 0,
            "num_intersections": flags[1],
            "grads_finite": leaf_ok.all(),
            "grads_finite_leaves": leaf_ok,
            "tier_members": torch.zeros((0,), dtype=torch.int32, device=dev),
        }
        return flat[-1].clone(), aux, (tap_grads, flags[2:] > 0)

    body.tap = tap
    return body, sh_mask_fn(params), params


def make_eager_sharded_train_step(
    cfg: RenderConfig,
    mesh: Mesh,
    optimizer,
    ssim_weight: float = 0.2,
    data_axis: str = "data",
    tile_axis: str = "tiles",
):
    """`make_sharded_train_step`'s step run eagerly, op by op, on every
    backend: the body the captured step captures, with the same interface
    (the reference `chip_smoke.py` holds the captured step to)."""
    return eager_step(*_sharded_step_body(cfg, mesh, optimizer, ssim_weight,
                                          data_axis, tile_axis))


def make_sharded_train_step(
    cfg: RenderConfig,
    mesh: Mesh,
    optimizer,
    ssim_weight: float = 0.2,
    data_axis: str = "data",
    tile_axis: str = "tiles",
):
    """Returns step(scene, cameras, targets, active_sh_degree=None) ->
    (loss, aux, (tap_grads, visible)): the contract of the single-device
    `train.loop.make_train_step`, so that `fit(mesh=...)` drives it
    unchanged. scene's tensors are the `SceneAdam`'s parameters, updated in
    place, alike on every rank.

    Dispatched as one program per rank, as the JAX step is a `jax.jit` of a
    `shard_map`: on an NCCL mesh on the card a CUDA graph with the
    collectives inside (the gradient all_reduce, the flags', the SSIM
    halo's all_gathers and their transposes), captured on the first call
    for (cfg, B, capacity, ssim_weight, SH masking on or off) and replayed
    after; on gloo and on the CPU the same body eagerly
    (`utils/graphs.py`).

    cameras: this rank's views (a sequence of its data shard's b views);
    targets: (b, band_h, padded_W, 3), their rows of this rank's tile band
    (`shard_batch`). loss is the batch mean, the same on every rank; aux:
    "overflow" (any rank), "num_intersections" (the largest per-shard demand:
    the capacity is per shard), "grads_finite(_leaves)" and an empty
    "tier_members" (no pool re-sizing under sharding, as in the JAX fit);
    tap_grads the all-reduced screen-space gradient and visible the OR over
    views of "touched >= 1 tile" (global tile counts, alike on every tile
    shard)."""
    body, band_mask, params = _sharded_step_body(
        cfg, mesh, optimizer, ssim_weight, data_axis, tile_axis)
    return masked_step(captured_step(
        body, params, "sharded_train_step",
        (cfg, float(ssim_weight), data_axis, tile_axis), mesh), band_mask)


def shard_batch(cameras, targets, mesh: Mesh, data_axis: str = "data",
                tile_axis: str = "tiles"):
    """This rank's part of a (cameras, targets) batch, as the step takes
    it: its data shard's views and, of their targets (B, padded_H,
    padded_W, 3), its tile band's rows."""
    n_data, n_tiles = mesh.size_of(data_axis), mesh.size_of(tile_axis)
    b = len(cameras) // n_data
    d, t = mesh.index(data_axis), mesh.index(tile_axis)
    h = targets.shape[1] // n_tiles
    return (list(cameras[d * b:(d + 1) * b]),
            targets[d * b:(d + 1) * b, t * h:(t + 1) * h])
