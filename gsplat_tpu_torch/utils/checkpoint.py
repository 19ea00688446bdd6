"""Checkpoint and resume of a fit (port of `gsplat_tpu.utils.checkpoint`).

The JAX module flattens a `TrainState` pytree into numbered leaves. The port
has no pytree: a checkpoint is a plain `.npz` of named arrays,

  scene.<field>               the five scene fields;
  adam.<field>.exp_avg        per `SceneAdam` group (named by its field),
  adam.<field>.exp_avg_sq     Adam's moments and its step count;
  adam.<field>.step
  adam.updates                `SceneAdam.updates`, the position-lr counter;
  step                        the fit's step.

It is written atomically (a temp file, then `os.replace`), so a crash never
leaves a half-written checkpoint under the final name.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from gsplat_tpu_torch.models.gaussians import GaussianScene

MOMENTS = ("exp_avg", "exp_avg_sq")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _adam_state(optimizer, param) -> dict:
    """The Adam state of one parameter; zero moments and step 0 before the
    first update (torch creates the state lazily)."""
    st = optimizer.state.get(param)
    if not st:
        zeros = np.zeros(tuple(param.shape), np.float32)
        return {"exp_avg": zeros, "exp_avg_sq": zeros, "step": np.float32(0)}
    return {"exp_avg": _host(st["exp_avg"]),
            "exp_avg_sq": _host(st["exp_avg_sq"]),
            "step": np.float32(float(st["step"]))}


def save_checkpoint(path: str, scene: GaussianScene, optimizer,
                    step: int) -> None:
    """Atomically save the scene, the `SceneAdam` state and the fit's step
    to an .npz."""
    atomic_savez(path, checkpoint_arrays(scene, optimizer, step))


def checkpoint_arrays(scene: GaussianScene, optimizer, step: int) -> dict:
    """The named host arrays of a checkpoint."""
    payload = {}
    for group in optimizer.param_groups:
        name, param = group["name"], group["params"][0]
        if getattr(scene, name) is not param:
            raise ValueError(f"save_checkpoint: scene.{name} is not the "
                             "optimizer's parameter")
        payload[f"scene.{name}"] = _host(param)
        for k, v in _adam_state(optimizer, param).items():
            payload[f"adam.{name}.{k}"] = v
    payload["adam.updates"] = np.int64(optimizer.updates)
    payload["step"] = np.int64(step)
    return payload


def atomic_savez(path: str, payload: dict) -> None:
    """np.savez to a temp file beside `path`, then `os.replace` onto it."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def checkpoint_step(path: str) -> int:
    """The fit's step stored in a checkpoint, without loading the rest."""
    with np.load(path) as data:
        if "step" not in data.files:
            raise ValueError(f"{path} has no 'step' array: not a checkpoint "
                             "of gsplat_tpu_torch's fit")
        return int(data["step"])


def load_checkpoint(path: str, scene: GaussianScene, optimizer) -> int:
    """Restore a checkpoint in place into `scene`'s tensors (the optimizer's
    parameters) and the optimizer's state. Raises ValueError, and changes
    nothing, if an array's shape differs from its tensor's. Returns the
    fit's step."""
    with np.load(path) as data:
        return restore_arrays({k: data[k] for k in data.files}, scene,
                              optimizer)


def restore_arrays(arrays: dict, scene: GaussianScene, optimizer) -> int:
    """`load_checkpoint` from the named arrays of a checkpoint."""
    restore = []
    for group in optimizer.param_groups:
        name, param = group["name"], group["params"][0]
        if getattr(scene, name) is not param:
            raise ValueError(f"load_checkpoint: scene.{name} is not the "
                             "optimizer's parameter")
        for key in (f"scene.{name}",) + tuple(f"adam.{name}.{m}"
                                               for m in MOMENTS):
            if arrays[key].shape != tuple(param.shape):
                raise ValueError(
                    f"checkpoint array {key} shape {arrays[key].shape} != "
                    f"expected {tuple(param.shape)}"
                )
        restore.append((name, param))
    with torch.no_grad():
        for name, param in restore:
            param.copy_(torch.from_numpy(arrays[f"scene.{name}"]))
            set_adam_state(optimizer, param,
                           *(arrays[f"adam.{name}.{m}"] for m in MOMENTS),
                           float(arrays[f"adam.{name}.step"]))
    optimizer.updates = int(arrays["adam.updates"])
    return int(arrays["step"])


@torch.no_grad()
def set_adam_state(optimizer, param, exp_avg, exp_avg_sq, step: float):
    """Write one parameter's Adam moments (host arrays) and step count.
    A state that exists is written in place, so a captured train step
    keeps reading it; a new one is made as torch makes it: the step a
    float32 tensor on the parameter's device when the optimizer is
    capturable, on the host otherwise."""
    st = optimizer.state[param]
    moments = {"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    if st:
        for m, x in moments.items():
            st[m].copy_(torch.from_numpy(np.array(x)))
        st["step"].fill_(step)
        return
    capturable = optimizer.param_groups[0].get("capturable", False)
    for m, x in moments.items():
        st[m] = torch.from_numpy(np.array(x)).to(param.device, param.dtype)
    st["step"] = torch.tensor(step, dtype=torch.float32,
                              device=param.device if capturable else "cpu")
