"""K10-K13, the kernels of 2D Gaussian splatting's surfels (Huang et al.
2024, arXiv:2403.17888): K12 the surfel projection and K13 its backward
(`csrc/surfel_project.cu`), K10 the ray-splat blend (`csrc/surfel_fwd.cu`)
and K11 its backward (`csrc/surfel_bwd.cu`), with their shared pair
arithmetic in `csrc/surfel.cuh`. Their plain versions, which CPU tensors
take, and the autograd functions over both routes are in `ops/surfels.py`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.cuda import _build
from gsplat_tpu_torch.ops.cuda._build import FLOAT, INT, INT64, PTR

CAMERA_FIELDS = ("view", "full_proj", "cam_pos", "focal", "tan_fov", "znear")


class _Config(ctypes.Structure):
    """`GsplatSurfelConfig` of csrc/surfel_project.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "alpha_min", "inv_alpha_min", "scale_modifier", "half_width",
        "half_height", "inv_width", "inv_height", "inv_tile",
        "filter_inv_square", "grow", "margin")] + [
        (name, ctypes.c_int) for name in ("tiles_x", "tiles_y", "kmax")]


_K12 = _build.kernel("surfel_project", "gsplat_surfel_project_fwd",
                     [INT, INT, INT, PTR, PTR, _Config, PTR], "K12")
_K13 = _build.kernel("surfel_project", "gsplat_surfel_project_bwd",
                     [INT, INT, INT, PTR, PTR, _Config, PTR, PTR], "K13")
_BLEND = [INT, INT, INT, INT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT]
_K10 = _build.kernel("surfel_fwd", "gsplat_surfel_fwd",
                     [PTR, PTR, PTR, INT, *_BLEND, PTR], "K10")
_K11 = _build.kernel("surfel_bwd", "gsplat_surfel_bwd",
                     [PTR, PTR, PTR, INT64, INT, *_BLEND, PTR, PTR, PTR],
                     "K11")


def _inv(x: float) -> float:
    """PyTorch's CUDA division by a host scalar: a product by its
    reciprocal, taken in double and rounded to float32."""
    return float(np.float32(1.0 / x))


def _config(cfg: RenderConfig) -> _Config:
    from gsplat_tpu_torch.ops import surfels as S

    return _Config(
        cfg.alpha_min, _inv(cfg.alpha_min), cfg.scale_modifier,
        0.5 * cfg.width, 0.5 * cfg.height, _inv(cfg.width),
        _inv(cfg.height), _inv(cfg.tile_size), S.FILTER_INV_SQUARE, S.GROW,
        S.MARGIN_PX, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_gaussian)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _checked(fields, camera, dev) -> tuple[list, list]:
    fields = [t.contiguous() for t in fields]
    camera = [t.contiguous() for t in camera]
    n = fields[0].shape[0]
    for name, t, shape in zip(
            ("means", "log_scales", "quats", "opacity_logits", "sh"), fields,
            ((n, 3), (n, 2), (n, 4), (n,), (n, None, 3))):
        _build.expect(t, f"surfels: {name}", dtype=torch.float32,
                      shape=shape, device=dev)
    if fields[4].shape[1] not in (1, 4, 9, 16):
        raise ValueError(f"surfels: sh must be (N, 1|4|9|16, 3), got "
                         f"{tuple(fields[4].shape)}")
    for name, t in zip(CAMERA_FIELDS, camera):
        _build.expect(t, f"surfels: camera.{name}", dtype=torch.float32,
                      device=dev)
    return fields, camera


def surfel_project_fwd_cuda(fields, camera, cfg: RenderConfig, degree: int):
    """Launch K12. fields: (means, log_scales (N, 2), quats,
    opacity_logits, sh); camera: its CAMERA_FIELDS tensors. Returns
    (transform (N, 9), center (N, 2), color (N, 3), opacity (N,), normal
    (N, 3), mask, uv, conic, depth, radius, rect, counts, overflow)."""
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = [empty(n, 9), empty(n, 2), empty(n, 3), empty(n), empty(n, 3),
            empty(n, dtype=torch.bool), empty(n, 2), empty(n, 3), empty(n),
            empty(n), empty(n, 4, dtype=torch.int32),
            empty(n, dtype=torch.int32),
            torch.zeros((), dtype=torch.bool, device=dev)]
    _K12(dev, n, fields[4].shape[1], degree, _pointers(fields),
         _pointers(camera), _config(cfg), _pointers(outs))
    return tuple(outs)


def surfel_project_bwd_cuda(fields, camera, cfg: RenderConfig, degree: int,
                            g_t, g_c, g_color, g_opacity, g_normal):
    """Launch K13: the gradients of transform (N, 9), center (N, 2), color
    (N, 3), opacity (N,) and normal (N, 3) -> those of (means, log_scales,
    quats, opacity_logits, sh), zero on every surfel whose upstream
    gradients are all zero."""
    dev = fields[0].device
    fields, camera = _checked(fields, camera, dev)
    n = fields[0].shape[0]
    grads = []
    for name, g, shape in (("transform", g_t, (n, 9)), ("center", g_c, (n, 2)),
                           ("color", g_color, (n, 3)),
                           ("opacity", g_opacity, (n,)),
                           ("normal", g_normal, (n, 3))):
        grads.append(g.contiguous())
        _build.expect(grads[-1], f"surfels: the {name} gradient",
                      dtype=torch.float32, shape=shape, device=dev)
    outs = [torch.empty_like(t) for t in fields]
    _K13(dev, n, fields[4].shape[1], degree, _pointers(fields),
         _pointers(camera), _config(cfg), _pointers(grads), _pointers(outs))
    return tuple(outs)


def _blend_args(cfg: RenderConfig) -> list:
    from gsplat_tpu_torch.ops import surfels as S

    return [cfg.tiles_x, cfg.tile_size, cfg.width, cfg.height,
            cfg.alpha_clamp, cfg.alpha_min, cfg.transmittance_min,
            S.FILTER_INV_SQUARE, S.DEPTH_NEAR,
            S.DEPTH_FAR / (S.DEPTH_FAR - S.DEPTH_NEAR)]


def _check_stream(table, gid, ranges, cfg: RenderConfig) -> None:
    dev = table.device
    _build.expect(table, "surfels: the table (N, 18)", dtype=torch.float32,
                  shape=(None, 18), device=dev)
    _build.expect(gid, "surfels: gid (max_I,)", dtype=torch.int32,
                  shape=(None,), device=dev)
    _build.expect(ranges, "surfels: ranges", dtype=torch.int32,
                  shape=(cfg.num_tiles + 1,), device=dev)


def surfel_fwd_cuda(table, gid, ranges, cfg: RenderConfig):
    """Launch K10: ((image (H, W, 3), trans (H, W), normal sum (H, W, 3),
    depth sum (H, W), distortion (H, W)), aux (H, W, 3): each pixel's
    final sums of w, w m and w m^2, which K11 reads)."""
    _check_stream(table, gid, ranges, cfg)
    dev = table.device
    h, w = cfg.height, cfg.width

    def empty(*shape):
        return torch.empty((h, w) + shape, dtype=torch.float32, device=dev)

    outs = (empty(3), empty(), empty(3), empty(), empty())
    aux = empty(3)
    _K10(dev, table.data_ptr(), gid.data_ptr(), ranges.data_ptr(),
         cfg.num_tiles, *_blend_args(cfg), _pointers([*outs, aux]))
    return outs, aux


def surfel_bwd_cuda(table, gid, ranges, outs, aux, grads,
                    cfg: RenderConfig):
    """Launch K11: K10's outputs and aux and the gradients of the five
    maps -> the (18, max_I) float32 slot gradients of the table's columns,
    zero on every slot no pixel applied."""
    _check_stream(table, gid, ranges, cfg)
    dev = table.device
    for i, (o, g) in enumerate(zip(outs, grads)):
        _build.expect(g, f"surfels: the gradient of map {i}",
                      dtype=torch.float32, shape=tuple(o.shape), device=dev)
    max_i = gid.shape[0]
    dslot = torch.zeros((18, max_i), dtype=torch.float32, device=dev)
    _K11(dev, table.data_ptr(), gid.data_ptr(), ranges.data_ptr(), max_i,
         cfg.num_tiles, *_blend_args(cfg), _pointers([*outs, aux]),
         _pointers(grads), dslot.data_ptr())
    return dslot
