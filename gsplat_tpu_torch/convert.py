"""Carry state across from the JAX package: plain numpy arrays in (e.g.
`np.asarray` of each leaf of a `gsplat_tpu` GaussianScene or Camera), port
tensors out, so both packages compute on the same parameters; and a scene's
tensors back out as numpy, so that both packages' results can be
compared."""

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
