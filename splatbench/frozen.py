"""Frozen copies of what the benchmark's inputs are made with.

The scene generators (`gsplat_tpu_torch/models/gaussians.py::random_scene`
and `realistic_scene`), `look_at` and the pose of `Camera.default`
(`gsplat_tpu_torch/ops/camera.py`), the perspective matrix, and
`device_name` (`gsplat_tpu_torch/utils/bench.py`), copied so that a later
change of the program cannot change the yardstick. They draw what the
originals drew when they were copied, for the same seed and device
(`tests/test_splatbench_frozen.py` holds them to it). A scene is a dict of
the five fields of the program's `GaussianScene`, in its order.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")

# The view matrix of `Camera.default`, given column-major (transposed
# before use), with focal = (W, H) px, znear 0.2 and zfar 10.
DEFAULT_VIEW_COLMAJOR = (
    (0.582345724105835, -0.3235852122306824, 0.7372694611549377, 0.0),
    (0.23868794739246368, 0.9381394982337952, 0.22253619134426117, 0.0),
    (-0.7680802941322327, 0.04477229341864586, 0.6242981553077698, 0.0),
    (0.13517332077026367, -1.1848870515823364, 3.3873789310455322, 1.0),
)
DEFAULT_ZNEAR = 0.2
DEFAULT_ZFAR = 10.0


def default_view() -> np.ndarray:
    """(4, 4) float32 world -> camera matrix of the default pose."""
    return np.array(DEFAULT_VIEW_COLMAJOR, dtype=np.float32).T.copy()


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->camera view matrix with +z forward."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    rot = np.stack([right, true_up, fwd], axis=0)
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view.astype(np.float32)


def perspective_matrix(znear: float, zfar: float, fov_x: float,
                       fov_y: float) -> np.ndarray:
    """Row-major perspective matrix (symmetric frustum), NDC depth in
    [0, 1], w' = z_view."""
    tan_x = math.tan(fov_x / 2.0)
    tan_y = math.tan(fov_y / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def _uniform(shape, lo, hi, kw):
    return torch.rand(shape, **kw) * (hi - lo) + lo


def random_scene(num: int, sh_degree: int, generator: torch.Generator,
                 device, extent: float = 1.0, depth_range=(2.0, 6.0),
                 scale_range=(-4.5, -2.5)) -> dict:
    """The uniform synthetic scene in front of the +z camera."""
    kw = dict(device=torch.device(device), generator=generator,
              dtype=torch.float32)
    xy = _uniform((num, 2), -extent, extent, kw)
    z = _uniform((num, 1), depth_range[0], depth_range[1], kw)
    means = torch.cat([xy * z / depth_range[0], z], dim=-1)
    log_scales = _uniform((num, 3), scale_range[0], scale_range[1], kw)
    quats = torch.randn((num, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacity_logits = _uniform((num,), -1.0, 3.0, kw)
    k = (sh_degree + 1) ** 2
    dc = _uniform((num, 1, 3), 0.0, 2.0, kw)
    sh = torch.cat([dc, 0.1 * torch.randn((num, k - 1, 3), **kw)], dim=1)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacity_logits=opacity_logits, sh=sh)


def realistic_scene(num: int, sh_degree: int, generator: torch.Generator,
                    device, extent: float = 1.0, depth_range=(2.0, 20.0),
                    log_scale_mu: float = -4.2, log_scale_sigma: float = 1.0,
                    aniso_sigma: float = 0.6, fat_fraction: float = 0.02,
                    fat_log_scale_mu: float = -1.6) -> dict:
    """The heavy-tailed synthetic scene with the statistics of trained
    captures: log-normal anisotropic scales with a fat tail, bimodal
    opacity, log-uniform depth."""
    kw = dict(device=torch.device(device), generator=generator,
              dtype=torch.float32)
    z = depth_range[0] * torch.exp(
        torch.rand((num, 1), **kw) * math.log(depth_range[1] / depth_range[0]))
    xy = _uniform((num, 2), -extent, extent, kw)
    means = torch.cat([xy * z / depth_range[0], z], dim=-1)
    base = log_scale_mu + log_scale_sigma * torch.randn((num, 1), **kw)
    fat = torch.rand((num, 1), **kw) < fat_fraction
    base = torch.where(
        fat, fat_log_scale_mu + 0.5 * torch.randn((num, 1), **kw), base)
    log_scales = base + aniso_sigma * torch.randn((num, 3), **kw)
    quats = torch.randn((num, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    low = _uniform((num,), -4.0, -1.0, kw)
    high = _uniform((num,), 0.5, 6.0, kw)
    opacity_logits = torch.where(torch.rand((num,), **kw) < 0.35, low, high)
    k = (sh_degree + 1) ** 2
    sh = _uniform((num, 1, 3), 0.0, 2.0, kw)
    if k > 1:
        sh = torch.cat([sh, 0.1 * torch.randn((num, k - 1, 3), **kw)], dim=1)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacity_logits=opacity_logits, sh=sh)


SCENES = {"random": random_scene, "realistic": realistic_scene}


def device_name(index: int) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (the name alone, said so,
    where nvidia-smi cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        return out.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
