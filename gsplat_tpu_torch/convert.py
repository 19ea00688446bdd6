"""Carry state across from the JAX package: plain numpy arrays in (e.g.
`np.asarray` of each leaf of a `gsplat_tpu` GaussianScene or Camera), port
tensors out, so both packages compute on the same parameters; a scene and
its Adam state together, so that a fit begun in JAX can go on in the port;
and a scene's tensors back out as numpy, so that both packages' results can
be compared."""

from __future__ import annotations

import dataclasses

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

    out = scene_from_numpy(**scene, device=device)
    optimizer = make_optimizer(out, lr, **opt_kw)
    for group in optimizer.param_groups:
        name, param = group["name"], group["params"][0]
        optimizer.state[param] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _tensor(mu[name], device),
            "exp_avg_sq": _tensor(nu[name], device),
        }
    optimizer.updates = int(count)
    return out, optimizer


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
