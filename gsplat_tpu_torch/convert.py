"""Carry state across from the JAX package: plain numpy arrays in (e.g.
`np.asarray` of each leaf of a `gsplat_tpu` GaussianScene or Camera), port
tensors out, so both packages compute on the same parameters; a scene and
its Adam state together, so that a fit begun in JAX can go on in the port,
also one shard of a Gaussian-sharded fit from the JAX package's per-shard
checkpoint directory; and a scene's tensors back out as numpy, so that both
packages' results can be compared."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.camera import Camera


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32),
                        device=torch.device(device))


def scene_from_numpy(means, log_scales, quats, opacity_logits, sh,
                     device="cuda") -> GaussianScene:
    return GaussianScene(
        means=_tensor(means, device),
        log_scales=_tensor(log_scales, device),
        quats=_tensor(quats, device),
        opacity_logits=_tensor(opacity_logits, device),
        sh=_tensor(sh, device),
    )


def scene_adam_from_numpy(scene: dict, mu: dict, nu: dict, count: int,
                          lr: float = 1e-2, device="cuda", **opt_kw):
    """(GaussianScene, SceneAdam) from numpy arrays: `scene` maps each field
    to its values, `mu` and `nu` each field to Adam's first and second
    moments (optax's `mu` and `nu`), and `count` is the updates made so far
    (optax's count, shared by every field). `lr` and `opt_kw` are
    `make_optimizer`'s; the position-lr schedule resumes at `count`."""
    from gsplat_tpu_torch.train.loop import make_optimizer
    from gsplat_tpu_torch.utils.checkpoint import set_adam_state

    out = scene_from_numpy(**scene, device=device)
    optimizer = make_optimizer(out, lr, **opt_kw)
    for group in optimizer.param_groups:
        name, param = group["name"], group["params"][0]
        set_adam_state(optimizer, param, mu[name], nu[name], float(count))
    optimizer.updates = int(count)
    return out, optimizer


_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def _jax_leaf_numbers() -> tuple[dict, dict, int]:
    """The `leaf_i` numbers of a JAX `TrainState(scene, opt_state, step)`
    flattened with `make_optimizer`'s default (constant-lr) multi-transform:
    the five scene fields in field order; then per label, in sorted order,
    Adam's count, mu and nu; then the step."""
    scene = {f: i for i, f in enumerate(_FIELDS)}
    adam, i = {}, len(_FIELDS)
    for label in sorted(_FIELDS):
        adam[label] = (i, i + 1, i + 2)
        i += 3
    return scene, adam, i


def scene_adam_from_jax_sharded_checkpoint(dir_path: str, shard: int,
                                           lr: float = 1e-2, device="cuda",
                                           **opt_kw):
    """Shard `shard`'s (GaussianScene, SceneAdam, step) from a checkpoint
    directory of `gsplat_tpu.parallel.gaussian_train.save_sharded_checkpoint`
    (`shard_{k:05d}.npz` with the per-slot leaves, `meta.npz` with the
    scalars and `__shards__`), written with the default optimizer; `lr` and
    `opt_kw` are `make_optimizer`'s. Only meta.npz and the shard's own file
    are read."""
    scene_ids, adam_ids, step_id = _jax_leaf_numbers()
    with np.load(os.path.join(dir_path, "meta.npz")) as m:
        meta = {k: m[k] for k in m.files}
    leaves = {int(k[5:]) for k in meta if k.startswith("leaf_")}
    if max(leaves) != step_id:
        raise ValueError(
            f"{dir_path}: {max(leaves) + 1} leaves, not the {step_id + 1} of "
            "a TrainState with the default optimizer")
    if not 0 <= shard < int(meta["__shards__"]):
        raise ValueError(f"shard {shard} of a {int(meta['__shards__'])}-shard "
                         "checkpoint")
    with np.load(os.path.join(dir_path, f"shard_{shard:05d}.npz")) as z:
        rows = {k: z[k] for k in z.files}
    scene = {f: rows[f"leaf_{i}"] for f, i in scene_ids.items()}
    mu = {f: rows[f"leaf_{adam_ids[f][1]}"] for f in _FIELDS}
    nu = {f: rows[f"leaf_{adam_ids[f][2]}"] for f in _FIELDS}
    count = int(meta[f"leaf_{adam_ids['means'][0]}"])
    out, optimizer = scene_adam_from_numpy(scene, mu, nu, count, lr, device,
                                           **opt_kw)
    return out, optimizer, int(meta[f"leaf_{step_id}"])


def scene_to_numpy(scene: GaussianScene) -> dict[str, np.ndarray]:
    """{field: float32 array} of a scene, on the host, detached."""
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(scene)}


def camera_from_numpy(view, proj, full_proj, cam_pos, focal, tan_fov, znear,
                      device="cuda") -> Camera:
    return Camera(
        view=_tensor(view, device),
        proj=_tensor(proj, device),
        full_proj=_tensor(full_proj, device),
        cam_pos=_tensor(cam_pos, device),
        focal=_tensor(focal, device),
        tan_fov=_tensor(tan_fov, device),
        znear=_tensor(znear, device),
    )
