"""Per-Gaussian projection: frustum cull, EWA 2D covariance, conic, screen
rect, SH color, opacity -- `gsplat_tpu.ops.projection` in PyTorch, with the
same unrolled algebra and the same clamps (0.3 low-pass, 1.3 tan_fov,
eigen_clamp, the tau-AABB rect). Plain elementwise torch over (N,) tensors
on any device.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.sh import eval_sh


@dataclasses.dataclass
class ProjectedGaussians:
    mask: torch.Tensor      # (N,) bool, survives frustum cull & valid cov
    uv: torch.Tensor        # (N, 2) in [0, 1]^2 (ndc*0.5 + 0.5)
    conic: torch.Tensor     # (N, 3) (A, B, C) of the inverse 2D covariance
    depth: torch.Tensor     # (N,) view-space z (sort key)
    color: torch.Tensor     # (N, 3) RGB from SH
    opacity: torch.Tensor   # (N,)
    radius: torch.Tensor    # (N,) screen-space radius in pixels
    rect: torch.Tensor      # (N, 4) int32 (tx0, ty0, tx1, ty1), tile coords,
    #                       #   half-open [tx0, tx1) x [ty0, ty1)
    counts: torch.Tensor    # (N,) int32 tiles touched (clipped to K_max)
    overflow: torch.Tensor  # () bool: some Gaussian's rect exceeded K_max


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) (w,x,y,z) unnormalized -> (N, 3, 3)."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def compute_cov3d(log_scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T, s = exp(log_scale) * modifier: (N, 3, 3)."""
    s = torch.exp(log_scales) * scale_modifier
    rot = quat_to_rotmat(quats)
    m = rot * s[..., None, :]            # R @ diag(s)
    return m @ m.transpose(-1, -2)       # R S^2 R^T


def _affine(pos: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pos (N, 3) through the (R, 4) rows of a row-major affine matrix:
    pos @ rows[:, :3].T + rows[:, 3] -> (N, R)."""
    return (pos[:, 0:1] * rows[:, 0] + pos[:, 1:2] * rows[:, 1]
            + pos[:, 2:3] * rows[:, 2]) + rows[:, 3]


def project_gaussians(
    scene, camera: Camera, cfg: RenderConfig, uv_tap=None
) -> ProjectedGaussians:
    """uv_tap: optional (N, 2) zeros added to the screen-space uv -- the
    gradient tap of the densification trigger. Zero-valued, so the image is
    unchanged."""
    pos = scene.means  # (N, 3)

    # View / clip transforms, as elementwise products and sums: a matmul
    # would round in TF32 wherever a caller has enabled it for cuBLAS.
    p_view = _affine(pos, camera.view[:3])           # (N, 3)
    p_hom = _affine(pos, camera.full_proj[:3])       # (N, 3)
    w_hom = _affine(pos, camera.full_proj[3:])[:, 0]  # (N,)
    inv_w = 1.0 / (w_hom + 1e-7)
    ndc = p_hom[:, :2] * inv_w[:, None]

    tz = p_view[:, 2]
    lim = cfg.frustum_ndc_limit
    in_frustum = (
        (tz > camera.znear)
        & (torch.abs(ndc[:, 0]) < lim)
        & (torch.abs(ndc[:, 1]) < lim)
    )
    uv = ndc * 0.5 + 0.5
    if uv_tap is not None:
        uv = uv + uv_tap

    # EWA 2D covariance, unrolled into (N,)-vector arithmetic.
    tz_safe = torch.where(in_frustum, tz, torch.ones_like(tz))
    lim_xy = 1.3 * camera.tan_fov  # (2,)
    txy = torch.clamp(
        p_view[:, :2] / tz_safe[:, None], -lim_xy, lim_xy
    ) * tz_safe[:, None]
    fx, fy = camera.focal[0], camera.focal[1]
    inv_tz = 1.0 / tz_safe
    inv_tz2 = inv_tz * inv_tz
    # J rows: [fx/tz, 0, -fx*tx/tz^2], [0, fy/tz, -fy*ty/tz^2].
    ja = fx * inv_tz
    jb = -fx * txy[:, 0] * inv_tz2
    jc = fy * inv_tz
    jd = -fy * txy[:, 1] * inv_tz2
    w = camera.view[:3, :3]
    # T2 = J @ W: row 0 = ja * W[0] + jb * W[2]; row 1 = jc * W[1] + jd * W[2].
    t0 = [ja * w[0, k] + jb * w[2, k] for k in range(3)]
    t1 = [jc * w[1, k] + jd * w[2, k] for k in range(3)]

    # Sigma = R diag(s^2) R^T, entries sig[i][j] = sum_k s2_k R[:,i,k] R[:,j,k].
    rot = quat_to_rotmat(scene.quats)
    s2 = torch.square(torch.exp(scene.log_scales) * cfg.scale_modifier)
    sig = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            acc = s2[:, 0] * rot[:, i, 0] * rot[:, j, 0]
            acc = acc + s2[:, 1] * rot[:, i, 1] * rot[:, j, 1]
            acc = acc + s2[:, 2] * rot[:, i, 2] * rot[:, j, 2]
            sig[i][j] = sig[j][i] = acc

    def quad(u, v):
        # u @ Sigma @ v for 3-vectors of (N,) components.
        return sum(u[i] * sum(sig[i][j] * v[j] for j in range(3)) for i in range(3))

    c00 = quad(t0, t0) + cfg.lowpass
    c01 = quad(t0, t1)
    c11 = quad(t1, t1) + cfg.lowpass

    det = c00 * c11 - c01 * c01
    valid = in_frustum & (det > 0.0)
    det_safe = torch.where(valid, det, torch.ones_like(det))

    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det_safe, cfg.eigen_clamp))
    if cfg.max_screen_radius:
        # Screen-footprint clamp: isotropic shrink by f <= 1 so the 3-sigma
        # radius lands at the bound (a projection-time guard: no gradient).
        r_raw = cfg.radius_sigma * torch.sqrt(lambda1)
        # (A scalar over a tensor would be a reciprocal and a product in
        # torch: divide tensor by tensor to round like the JAX package.)
        bound = torch.full_like(r_raw, cfg.max_screen_radius)
        f = (torch.clamp_max(
            bound / torch.clamp_min(r_raw, 1e-6), 1.0
        ) ** 2).detach()
        c00 = c00 * f
        c01 = c01 * f
        c11 = c11 * f
        det_safe = det_safe * f * f
        lambda1 = lambda1 * f

    inv_det = 1.0 / det_safe
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], -1)
    radius = torch.ceil(cfg.radius_sigma * torch.sqrt(lambda1))

    opacity = torch.sigmoid(scene.opacity_logits)  # numerically stable

    # Tile rect, clamped to the grid: the circle rect intersected with the
    # AABB of the reachable-alpha ellipse {q <= tau}, tau = 2 ln(op/alpha_min).
    tau = 2.0 * torch.log(torch.clamp_min(opacity / cfg.alpha_min, 1e-12))
    rtau = torch.sqrt(torch.clamp_min(tau, 0.0))
    ext_x = torch.minimum(radius, torch.ceil(rtau * torch.sqrt(torch.clamp_min(c00, 0.0))))
    ext_y = torch.minimum(radius, torch.ceil(rtau * torch.sqrt(torch.clamp_min(c11, 0.0))))
    ext = torch.stack([ext_x, ext_y], -1)
    ext = torch.where((opacity > cfg.alpha_min)[:, None], ext,
                      torch.full_like(ext, -1.0))  # empty rect
    ext = ext.detach()  # rect is ordering-only (ints downstream)
    pix = uv * torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                            device=uv.device)
    ts = float(cfg.tile_size)
    ntx, nty = cfg.tiles_x, cfg.tiles_y
    lo = torch.floor((pix - ext) / ts)
    hi = torch.floor((pix + ext) / ts) + 1.0
    tx0 = torch.clamp(lo[:, 0], 0, ntx).to(torch.int32)
    ty0 = torch.clamp(lo[:, 1], 0, nty).to(torch.int32)
    tx1 = torch.clamp(hi[:, 0], 0, ntx).to(torch.int32)
    ty1 = torch.clamp(hi[:, 1], 0, nty).to(torch.int32)
    rect = torch.stack([tx0, ty0, tx1, ty1], -1)
    area = torch.clamp_min(tx1 - tx0, 0) * torch.clamp_min(ty1 - ty0, 0)
    area = torch.where(valid, area, torch.zeros_like(area))
    valid = valid & (area > 0)
    counts = torch.clamp_max(area, cfg.max_tiles_per_gaussian)
    overflow = torch.any(area > cfg.max_tiles_per_gaussian)

    # Color.
    dirs = pos - camera.cam_pos
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
    degree = min(cfg.sh_degree, int(round(scene.sh.shape[1] ** 0.5)) - 1)
    color = eval_sh(scene.sh, dirs, degree)

    return ProjectedGaussians(
        mask=valid,
        uv=uv,
        conic=conic,
        depth=tz,
        color=color,
        opacity=opacity,
        radius=radius,
        rect=rect,
        counts=counts,
        overflow=overflow,
    )
