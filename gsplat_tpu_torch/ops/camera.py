"""Camera model: the matrix conventions of `gsplat_tpu.ops.camera`.

Row-major math matrices applied as ``M @ [x, 1]``; +z forward, NDC depth in
[0, 1], ``w' = z_view``. The matrices are built in numpy exactly as the JAX
package builds them, then become float32 tensors on `device`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def perspective_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """Row-major perspective matrix (symmetric frustum)."""
    tan_x = math.tan(fov_x / 2.0)
    tan_y = math.tan(fov_y / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


@dataclasses.dataclass
class Camera:
    """A single camera; every field is a float32 tensor on one device.
    Image dimensions live in RenderConfig."""

    view: torch.Tensor       # (4, 4) world -> camera
    proj: torch.Tensor       # (4, 4) perspective (camera -> clip)
    full_proj: torch.Tensor  # (4, 4) = proj @ view
    cam_pos: torch.Tensor    # (3,) camera center in world space
    focal: torch.Tensor      # (2,) [fx, fy] in pixels
    tan_fov: torch.Tensor    # (2,) [tan(fovx/2), tan(fovy/2)]
    znear: torch.Tensor      # () near plane (also the frustum cull depth)

    @classmethod
    def create(
        cls,
        view: np.ndarray,
        width: int,
        height: int,
        fx: float,
        fy: float,
        znear: float = 0.2,
        zfar: float = 100.0,
        device="cuda",
    ) -> "Camera":
        view = np.asarray(view, dtype=np.float32)
        fov_x = focal2fov(fx, width)
        fov_y = focal2fov(fy, height)
        proj = perspective_matrix(znear, zfar, fov_x, fov_y)
        # Camera world position = translation of the inverse view matrix.
        cam_pos = np.linalg.inv(view)[:3, 3]

        def t(x):
            return torch.as_tensor(
                np.asarray(x, dtype=np.float32), device=torch.device(device)
            )

        return cls(
            view=t(view),
            proj=t(proj),
            full_proj=t(proj @ view),
            cam_pos=t(cam_pos),
            focal=t([fx, fy]),
            tan_fov=t([math.tan(fov_x / 2), math.tan(fov_y / 2)]),
            znear=t(znear),
        )

    @classmethod
    def from_rt(
        cls,
        rotation: np.ndarray,   # (3, 3) world->camera rotation
        position: np.ndarray,   # (3,) camera center in world space
        width: int,
        height: int,
        fx: float,
        fy: float,
        znear: float = 0.2,
        zfar: float = 100.0,
        device="cuda",
    ) -> "Camera":
        """graphdeco ``cameras.json`` (R, t) convention:
        ``view @ x = R @ (x - t)``."""
        rotation = np.asarray(rotation, dtype=np.float32)
        position = np.asarray(position, dtype=np.float32)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = rotation
        view[:3, 3] = -rotation @ position
        return cls.create(view, width, height, fx, fy, znear, zfar, device)

    @classmethod
    def default(cls, width: int = 800, height: int = 800,
                device="cuda") -> "Camera":
        """The JAX package's default pose: focal = (W, H) px, znear 0.2,
        zfar 10, fixed view matrix (given column-major, transposed here)."""
        view_colmajor = np.array(
            [
                [0.582345724105835, -0.3235852122306824, 0.7372694611549377, 0.0],
                [0.23868794739246368, 0.9381394982337952, 0.22253619134426117, 0.0],
                [-0.7680802941322327, 0.04477229341864586, 0.6242981553077698, 0.0],
                [0.13517332077026367, -1.1848870515823364, 3.3873789310455322, 1.0],
            ],
            dtype=np.float32,
        )
        return cls.create(view_colmajor.T, width, height, fx=float(width),
                          fy=float(height), znear=0.2, zfar=10.0,
                          device=device)


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
    rot = np.stack([right, true_up, fwd], axis=0)  # rows: x right, y up, z fwd
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view.astype(np.float32)


def orbit_cameras(
    center,
    radius: float,
    num: int,
    width: int,
    height: int,
    fx: float,
    fy: float,
    elevation: float = 0.3,
    znear: float = 0.2,
    zfar: float = 100.0,
    device="cuda",
):
    """An orbit of cameras around a scene."""
    center = np.asarray(center, dtype=np.float64)
    cams = []
    for i in range(num):
        theta = 2.0 * math.pi * i / num
        eye = center + radius * np.array(
            [math.cos(theta), elevation, math.sin(theta)]
        )
        cams.append(
            Camera.create(look_at(eye, center), width, height, fx, fy, znear,
                          zfar, device)
        )
    return cams
