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
from gsplat_tpu_torch.ops.cuda import _build, counters

# K8 and K9 launches: project_fwd_cuda and project_bwd_cuda add one per
# launch, nowhere else.
launches = 0
bwd_launches = 0
counters.register(__name__, "launches", "bwd_launches")

CAMERA_FIELDS = ("view", "full_proj", "cam_pos", "focal", "tan_fov", "znear")


class _Config(ctypes.Structure):
    """`GsplatProjectConfig` of csrc/project.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "ndc_limit", "lowpass", "eigen_clamp", "radius_sigma",
        "max_screen_radius", "alpha_min", "inv_alpha_min", "scale_modifier",
        "width", "height", "inv_tile")] + [
        (name, ctypes.c_int) for name in ("tiles_x", "tiles_y", "kmax")]


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
    n = fields[0].shape[0]
    shapes = ((n, 3), (n, 3), (n, 4), (n,), None)
    for t, shape in zip(fields, shapes):
        if t.dtype != torch.float32 or t.device != dev or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(
                f"project: scene fields must be float32 (N, 3), (N, 3), "
                f"(N, 4), (N,), (N, K, 3) on {dev}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    sh = fields[4]
    if sh.dim() != 3 or sh.shape[0] != n or sh.shape[2] != 3 or \
            sh.shape[1] not in (1, 4, 9, 16):
        raise ValueError(f"project: sh must be (N, 1|4|9|16, 3), got "
                         f"{tuple(sh.shape)}")
    for name, t in zip(CAMERA_FIELDS, camera):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"project: camera.{name} must be float32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    return ([t.contiguous() for t in fields],
            [t.contiguous() for t in camera])


def project_fwd_cuda(fields, uv_tap, camera, cfg: RenderConfig, degree: int):
    """Launch K8. fields: (means, log_scales, quats, opacity_logits, sh);
    camera: its CAMERA_FIELDS tensors; uv_tap: (N, 2) or None; degree: the
    SH degree evaluated (at most the scene's). Returns (mask, uv, conic,
    depth, color, opacity, radius, rect, counts, overflow), as
    `ProjectedGaussians` orders them."""
    global launches
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]
    if uv_tap is not None:
        if uv_tap.dtype != torch.float32 or tuple(uv_tap.shape) != (n, 2) \
                or uv_tap.device != dev:
            raise ValueError("project: uv_tap must be a float32 (N, 2) "
                             "tensor on the scene's device")
        uv_tap = uv_tap.contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    mask = empty(n, dtype=torch.bool)
    outs = [empty(n, 2), empty(n, 3), empty(n), empty(n, 3), empty(n),
            empty(n), empty(n, 4, dtype=torch.int32),
            empty(n, dtype=torch.int32), mask,
            torch.zeros((), dtype=torch.bool, device=dev)]
    fn = _build.load("project").gsplat_project_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, _Config, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(n, fields[4].shape[1], degree, _pointers(fields),
                 None if uv_tap is None else uv_tap.data_ptr(),
                 _pointers(camera), _config(cfg), _pointers(outs), cuda_stream)
    _build.check(err, "gsplat_project_fwd")
    launches += 1
    return (mask, *outs[:8], outs[9])


def project_bwd_cuda(fields, camera, cfg: RenderConfig, degree: int, g_uv,
                     g_conic, g_color, g_opacity):
    """Launch K9: the upstream gradients of uv (N, 2), conic (N, 3), color
    (N, 3) and opacity (N,) -> the gradients of (means, log_scales, quats,
    opacity_logits, sh), zero on every Gaussian whose upstream gradients
    are all zero."""
    global bwd_launches
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]
    grads = []
    for name, g, shape in (("uv", g_uv, (n, 2)), ("conic", g_conic, (n, 3)),
                           ("color", g_color, (n, 3)),
                           ("opacity", g_opacity, (n,))):
        if g.dtype != torch.float32 or tuple(g.shape) != shape or \
                g.device != dev:
            raise ValueError(f"project: the {name} gradient must be a "
                             f"float32 {shape} tensor on {dev}, got "
                             f"{tuple(g.shape)} {g.dtype}")
        grads.append(g.contiguous())
    outs = [torch.empty_like(t) for t in fields]
    fn = _build.load("project").gsplat_project_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, _Config, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(n, fields[4].shape[1], degree, _pointers(fields),
                 _pointers(camera), _config(cfg), _pointers(grads),
                 _pointers(outs), cuda_stream)
    _build.check(err, "gsplat_project_bwd")
    bwd_launches += 1
    return tuple(outs)
