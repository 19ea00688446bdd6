"""K8, the per-Gaussian projection and SH colour (CUDA kernel
`csrc/project.cu`, `project_fwd_kernel`), and K9, its backward
(`project_bwd_kernel`): one thread a Gaussian each, every intermediate in
registers. K9 recomputes the forward from the scene's fields, so the
forward saves nothing but its inputs.

Their plain versions, which CPU tensors take, are `ops/projection.py`'s
`_project_plain` and `project_backward`; `project_gaussians` there is the
autograd function over both routes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import INT, PTR

CAMERA_FIELDS = ("view", "full_proj", "cam_pos", "focal", "tan_fov", "znear")


class _Config(ctypes.Structure):
    """`GsplatProjectConfig` of csrc/project.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "ndc_limit", "lowpass", "eigen_clamp", "radius_sigma",
        "max_screen_radius", "alpha_min", "inv_alpha_min", "scale_modifier",
        "width", "height", "inv_tile")] + [
        (name, ctypes.c_int) for name in ("tiles_x", "tiles_y", "kmax")]


# The entry points: N, the scene's SH coefficients, the degree, then arrays
# of pointers (scene, tap, camera; or scene, camera, config, gradients) and
# the outputs' pointers.
_K8 = _build.kernel("project", "gsplat_project_fwd",
                    [INT, INT, INT, PTR, PTR, PTR, _Config, PTR], "K8")
_K9 = _build.kernel("project", "gsplat_project_bwd",
                    [INT, INT, INT, PTR, PTR, _Config, PTR, PTR], "K9")


def _config(cfg: RenderConfig) -> _Config:
    # PyTorch's CUDA division of a tensor by a host scalar is a product by
    # the scalar's reciprocal, taken in double and rounded to float32.
    def inv(x):
        return float(np.float32(1.0 / x))

    return _Config(
        cfg.frustum_ndc_limit, cfg.lowpass, cfg.eigen_clamp,
        cfg.radius_sigma, cfg.max_screen_radius, cfg.alpha_min,
        inv(cfg.alpha_min), cfg.scale_modifier, float(cfg.width),
        float(cfg.height), inv(cfg.tile_size), cfg.tiles_x, cfg.tiles_y,
        cfg.max_tiles_per_gaussian)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _checked(fields, camera, dev) -> tuple[list, list]:
    """The scene's five fields and the camera's six tensors, float32,
    contiguous and on `dev`, or a ValueError."""
    fields = [t.contiguous() for t in fields]
    camera = [t.contiguous() for t in camera]
    n = fields[0].shape[0]
    for name, t, shape in zip(
            ("means", "log_scales", "quats", "opacity_logits", "sh"), fields,
            ((n, 3), (n, 3), (n, 4), (n,), (n, None, 3))):
        _build.expect(t, f"project: {name}", dtype=torch.float32,
                      shape=shape, device=dev)
    if fields[4].shape[1] not in (1, 4, 9, 16):
        raise ValueError(f"project: sh must be (N, 1|4|9|16, 3), got "
                         f"{tuple(fields[4].shape)}")
    for name, t in zip(CAMERA_FIELDS, camera):
        _build.expect(t, f"project: camera.{name}", dtype=torch.float32,
                      device=dev)
    return fields, camera


def project_fwd_cuda(fields, uv_tap, camera, cfg: RenderConfig, degree: int):
    """Launch K8. fields: (means, log_scales, quats, opacity_logits, sh);
    camera: its CAMERA_FIELDS tensors; uv_tap: (N, 2) or None; degree: the
    SH degree evaluated (at most the scene's). Returns (mask, uv, conic,
    depth, color, opacity, radius, rect, counts, overflow), as
    `ProjectedGaussians` orders them."""
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]
    if uv_tap is not None:
        uv_tap = uv_tap.contiguous()
        _build.expect(uv_tap, "project: uv_tap", dtype=torch.float32,
                      shape=(n, 2), device=dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    mask = empty(n, dtype=torch.bool)
    outs = [empty(n, 2), empty(n, 3), empty(n), empty(n, 3), empty(n),
            empty(n), empty(n, 4, dtype=torch.int32),
            empty(n, dtype=torch.int32), mask,
            torch.zeros((), dtype=torch.bool, device=dev)]
    _K8(dev, n, fields[4].shape[1], degree, _pointers(fields),
        None if uv_tap is None else uv_tap.data_ptr(), _pointers(camera),
        _config(cfg), _pointers(outs))
    return (mask, *outs[:8], outs[9])


def project_bwd_cuda(fields, camera, cfg: RenderConfig, degree: int, g_uv,
                     g_conic, g_color, g_opacity):
    """Launch K9: the upstream gradients of uv (N, 2), conic (N, 3), color
    (N, 3) and opacity (N,) -> the gradients of (means, log_scales, quats,
    opacity_logits, sh), zero on every Gaussian whose upstream gradients
    are all zero."""
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]
    grads = []
    for name, g, shape in (("uv", g_uv, (n, 2)), ("conic", g_conic, (n, 3)),
                           ("color", g_color, (n, 3)),
                           ("opacity", g_opacity, (n,))):
        grads.append(g.contiguous())
        _build.expect(grads[-1], f"project: the {name} gradient",
                      dtype=torch.float32, shape=shape, device=dev)
    outs = [torch.empty_like(t) for t in fields]
    _K9(dev, n, fields[4].shape[1], degree, _pointers(fields),
        _pointers(camera), _config(cfg), _pointers(grads), _pointers(outs))
    return tuple(outs)
