"""Per-Gaussian projection: frustum cull, EWA 2D covariance, conic, screen
rect, SH color, opacity -- `gsplat_tpu.ops.projection` in PyTorch, with the
same unrolled algebra and the same clamps (0.3 low-pass, 1.3 tan_fov,
eigen_clamp, the tau-AABB rect).

`project_gaussians` is one autograd function over two routes. On CUDA
tensors its forward is kernel K8 and its backward kernel K9
(`ops/cuda/project.py`, `csrc/project.cu`); on CPU tensors they are the
plain versions here: `_project_plain`, elementwise torch over (N,) tensors
in the order K8 rounds in, and `project_backward`, the hand-derived chain
of its autograd that K9 computes. The forward saves only its inputs: each
backward recomputes what it needs.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops import sh as sh_mod
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda import project as kernels


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


def sh_degree(scene, cfg: RenderConfig) -> int:
    """The SH degree the colour is evaluated at: the config's, at most the
    scene's."""
    return min(cfg.sh_degree, int(round(scene.sh.shape[1] ** 0.5)) - 1)


def _affine(pos: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pos (N, 3) through the (R, 4) rows of a row-major affine matrix:
    pos @ rows[:, :3].T + rows[:, 3] -> (N, R)."""
    return (pos[:, 0:1] * rows[:, 0] + pos[:, 1:2] * rows[:, 1]
            + pos[:, 2:3] * rows[:, 2]) + rows[:, 3]


def _project_plain(scene, camera: Camera, cfg: RenderConfig, uv_tap=None,
                   terms: dict | None = None) -> ProjectedGaussians:
    """The plain version of K8 (differentiable by autograd). `terms`, where
    given, receives the intermediates `project_backward` reads."""
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
    c_pre, valid_det, f = (c00, c01, c11), valid, None

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
    # Scaled by Python floats, not a tensor built here: that would be a copy
    # from the host on every frame (width and height are exact in float32,
    # so the products are the same).
    pix = torch.stack([uv[:, 0] * float(cfg.width),
                       uv[:, 1] * float(cfg.height)], -1)
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
    rel = pos - camera.cam_pos
    rel_norm = torch.linalg.norm(rel, dim=-1, keepdim=True)
    dirs = rel / rel_norm.clamp(min=1e-12)
    color_raw = sh_mod.eval_sh_unclamped(scene.sh, dirs, sh_degree(scene, cfg))
    color = torch.clamp_min(color_raw, 0.0)

    if terms is not None:
        terms.update(
            p_view=p_view, p_hom=p_hom, inv_w=inv_w, in_frustum=in_frustum,
            tz_safe=tz_safe, lim_xy=lim_xy, txy=txy, inv_tz=inv_tz,
            inv_tz2=inv_tz2, t0=t0, t1=t1, rot=rot, s2=s2, sig=sig, c=c_pre,
            valid_det=valid_det, f=f, k=(c00, c01, c11), inv_det=inv_det,
            opacity=opacity, rel=rel, rel_norm=rel_norm[:, 0], dirs=dirs,
            color_raw=color_raw)

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


def _sh_basis(dirs: torch.Tensor, degree: int):
    """The factor of each SH coefficient in `eval_sh` at the unit
    directions dirs (N, 3), and its gradient in the direction: (N, B) and
    (N, B, 3), B = (degree + 1)**2."""
    x, y, z = dirs.unbind(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    c1, c2, c3 = sh_mod.SH_C1, sh_mod.SH_C2, sh_mod.SH_C3
    rows = [(sh_mod.SH_C0 * one, (zero, zero, zero))]
    if degree >= 1:
        rows += [(-c1 * y, (zero, -c1 * one, zero)),
                 (c1 * z, (zero, zero, c1 * one)),
                 (-c1 * x, (-c1 * one, zero, zero))]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        rows += [
            (c2[0] * x * y, (c2[0] * y, c2[0] * x, zero)),
            (c2[1] * y * z, (zero, c2[1] * z, c2[1] * y)),
            (c2[2] * (2 * zz - xx - yy),
             (-2 * c2[2] * x, -2 * c2[2] * y, 4 * c2[2] * z)),
            (c2[3] * x * z, (c2[3] * z, zero, c2[3] * x)),
            (c2[4] * (xx - yy), (2 * c2[4] * x, -2 * c2[4] * y, zero)),
        ]
    if degree >= 3:
        rows += [
            (c3[0] * y * (3 * xx - yy),
             (6 * c3[0] * x * y, c3[0] * (3 * xx - 3 * yy), zero)),
            (c3[1] * x * y * z,
             (c3[1] * y * z, c3[1] * x * z, c3[1] * x * y)),
            (c3[2] * y * (4 * zz - xx - yy),
             (-2 * c3[2] * x * y, c3[2] * (4 * zz - xx - 3 * yy),
              8 * c3[2] * y * z)),
            (c3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             (-6 * c3[3] * x * z, -6 * c3[3] * y * z,
              c3[3] * (6 * zz - 3 * xx - 3 * yy))),
            (c3[4] * x * (4 * zz - xx - yy),
             (c3[4] * (4 * zz - 3 * xx - yy), -2 * c3[4] * x * y,
              8 * c3[4] * x * z)),
            (c3[5] * z * (xx - yy),
             (2 * c3[5] * x * z, -2 * c3[5] * y * z, c3[5] * (xx - yy))),
            (c3[6] * x * (xx - 3 * yy),
             (c3[6] * (3 * xx - 3 * yy), -6 * c3[6] * x * y, zero)),
        ]
    basis = torch.stack([b for b, _ in rows], -1)
    grad = torch.stack([torch.stack(g, -1) for _, g in rows], 1)
    return basis, grad


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row outer products of (N, 3) vectors: (N, 3, 3)."""
    return a[:, :, None] * b[:, None, :]


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row (N, 3, 3) @ (N, 3) as elementwise products and a sum (no
    matmul: TF32 where a caller enabled it)."""
    return (m * v[:, None, :]).sum(-1)


@torch.no_grad()
def project_backward(scene, camera: Camera, cfg: RenderConfig, g_uv, g_conic,
                     g_color, g_opacity):
    """The plain version of K9: the gradients of (means, log_scales, quats,
    opacity_logits, sh) from the upstream gradients of uv (N, 2), conic
    (N, 3), color (N, 3) and opacity (N,), the chain of `_project_plain`'s
    autograd written out (torch's conventions at every clamp and `where`:
    a clamp passes at equality; the screen-radius shrink, radius, rect and
    counts carry none). The uv tap's gradient is uv's. A Gaussian whose
    upstream gradients are all zero gets zeros."""
    t: dict = {}
    _project_plain(scene, camera, cfg, terms=t)
    degree = sh_degree(scene, cfg)
    sh = scene.sh
    nb = (degree + 1) ** 2

    # Colour: the clamp at 0 passes where color_raw >= 0.
    g_res = torch.where(t["color_raw"] >= 0, g_color, torch.zeros_like(g_color))
    basis, dbasis = _sh_basis(t["dirs"], degree)
    d_sh = torch.zeros_like(sh)
    d_sh[:, :nb] = basis[:, :, None] * g_res[:, None, :]
    v = (g_res[:, None, :] * sh[:, :nb]).sum(-1)            # (N, B)
    g_dir = (v[:, :, None] * dbasis).sum(1)                  # (N, 3)
    # dirs = rel / max(|rel|, 1e-12); the norm's backward is 0 at |rel| = 0.
    rel, n = t["rel"], t["rel_norm"]
    nc = n.clamp(min=1e-12)
    g_n = torch.where(n >= 1e-12, -(g_dir * rel).sum(-1) / (nc * nc),
                      torch.zeros_like(n))
    g_means = g_dir / nc[:, None] + rel * torch.where(
        n > 0, g_n / n, torch.zeros_like(n))[:, None]

    # Opacity.
    op = t["opacity"]
    d_logits = g_opacity * op * (1 - op)

    # Conic = (k11, -k01, k00) / det_s: k = f c, det_s = f^2 det where
    # valid (else f^2).
    k00, k01, k11 = t["k"]
    c00, c01, c11 = t["c"]
    inv_det = t["inv_det"]
    f = torch.ones_like(inv_det) if t["f"] is None else t["f"]
    ga, gb, gc = g_conic.unbind(-1)
    g_inv = ga * k11 - gb * k01 + gc * k00
    g_det = torch.where(t["valid_det"], -g_inv * inv_det * inv_det * f * f,
                        torch.zeros_like(g_inv))
    g00 = gc * inv_det * f + g_det * c11
    g01 = -gb * inv_det * f - 2 * g_det * c01
    g11 = ga * inv_det * f + g_det * c00

    # c00 = t0 S t0, c01 = t0 S t1, c11 = t1 S t1 (S symmetric).
    t0, t1 = torch.stack(t["t0"], -1), torch.stack(t["t1"], -1)
    sig = torch.stack([torch.stack(row, -1) for row in t["sig"]], 1)
    st0, st1 = _matvec(sig, t0), _matvec(sig, t1)
    g_t0 = 2 * g00[:, None] * st0 + g01[:, None] * st1
    g_t1 = 2 * g11[:, None] * st1 + g01[:, None] * st0
    m = (g00[:, None, None] * _outer(t0, t0) + g01[:, None, None] * _outer(t0, t1)
         + g11[:, None, None] * _outer(t1, t1))
    # S = R diag(s2) R^T: g_R = (M + M^T) R diag(s2), g_s2 = diag(R^T M R).
    rot, s2 = t["rot"], t["s2"]
    ms = m + m.transpose(1, 2)
    g_rot = (ms[:, :, :, None] * rot[:, None, :, :]).sum(2) * s2[:, None, :]
    g_s2 = (rot[:, :, None, :] * m[:, :, :, None] * rot[:, None, :, :]).sum((1, 2))
    d_log_scales = 2 * s2 * g_s2  # s2 = (exp(log_scale) * modifier)^2

    # R of the unit quaternion (w, x, y, z), then the normalisation.
    q = scene.quats
    nq = torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = (q / nq).unbind(-1)
    g = g_rot
    g_qn = 2 * torch.stack([
        -z * g[:, 0, 1] + y * g[:, 0, 2] + z * g[:, 1, 0] - x * g[:, 1, 2]
        - y * g[:, 2, 0] + x * g[:, 2, 1],
        y * g[:, 0, 1] + z * g[:, 0, 2] + y * g[:, 1, 0] - 2 * x * g[:, 1, 1]
        - w * g[:, 1, 2] + z * g[:, 2, 0] + w * g[:, 2, 1] - 2 * x * g[:, 2, 2],
        -2 * y * g[:, 0, 0] + x * g[:, 0, 1] + w * g[:, 0, 2] + x * g[:, 1, 0]
        + z * g[:, 1, 2] - w * g[:, 2, 0] + z * g[:, 2, 1] - 2 * y * g[:, 2, 2],
        -2 * z * g[:, 0, 0] - w * g[:, 0, 1] + x * g[:, 0, 2] + w * g[:, 1, 0]
        - 2 * z * g[:, 1, 1] + y * g[:, 1, 2] + x * g[:, 2, 0] + y * g[:, 2, 1],
    ], -1)
    qn = q / nq
    d_quats = (g_qn - qn * (g_qn * qn).sum(-1, keepdim=True)) / nq

    # T = J W, J = [fx/tz, 0, -fx tx/tz^2; 0, fy/tz, -fy ty/tz^2].
    view = camera.view
    fx, fy = camera.focal[0], camera.focal[1]
    g_ja = (g_t0 * view[0, :3]).sum(-1)
    g_jb = (g_t0 * view[2, :3]).sum(-1)
    g_jc = (g_t1 * view[1, :3]).sum(-1)
    g_jd = (g_t1 * view[2, :3]).sum(-1)
    inv_tz, inv_tz2, tz_safe = t["inv_tz"], t["inv_tz2"], t["tz_safe"]
    txy = t["txy"]
    g_txy = torch.stack([-fx * inv_tz2 * g_jb, -fy * inv_tz2 * g_jd], -1)
    g_inv_tz2 = -fx * txy[:, 0] * g_jb - fy * txy[:, 1] * g_jd
    g_inv_tz = fx * g_ja + fy * g_jc + 2 * inv_tz * g_inv_tz2
    g_tz = -g_inv_tz * inv_tz * inv_tz
    # txy = clamp(u, -lim, lim) tz_safe, u = p_view_xy / tz_safe; the clamp
    # passes inside [-lim, lim], ends included.
    lim = t["lim_xy"]
    u = t["p_view"][:, :2] / tz_safe[:, None]
    g_tz = g_tz + (g_txy * torch.clamp(u, -lim, lim)).sum(-1)
    g_u = torch.where((u >= -lim) & (u <= lim), g_txy * tz_safe[:, None],
                      torch.zeros_like(u))
    g_pview = torch.cat([
        g_u / tz_safe[:, None],
        torch.where(t["in_frustum"], g_tz - (g_u * u).sum(-1) / tz_safe,
                    torch.zeros_like(g_tz))[:, None]], -1)
    # uv = 0.5 p_hom_xy inv_w + 0.5, inv_w = 1 / (w_hom + 1e-7).
    g_ndc = 0.5 * g_uv
    inv_w = t["inv_w"]
    g_w = -(g_ndc * t["p_hom"][:, :2]).sum(-1) * inv_w * inv_w
    proj = camera.full_proj
    g_means = (g_means + (g_pview[:, :, None] * view[:3, :3]).sum(1)
               + ((g_ndc * inv_w[:, None])[:, :, None] * proj[:2, :3]).sum(1)
               + g_w[:, None] * proj[3, :3])

    live = ((g_uv != 0).any(-1) | (g_conic != 0).any(-1)
            | (g_color != 0).any(-1) | (g_opacity != 0))
    out = []
    for grad in (g_means, d_log_scales, d_quats, d_logits, d_sh):
        keep = live.view(-1, *([1] * (grad.dim() - 1)))
        out.append(torch.where(keep, grad, torch.zeros_like(grad)))
    return tuple(out)


class _Project(torch.autograd.Function):
    """`project_gaussians` as one node of the graph: K8 and K9 for CUDA
    tensors, `_project_plain` and `project_backward` for CPU ones. Saves
    its inputs alone, and those only when a gradient can be asked for."""

    @staticmethod
    def forward(ctx, cfg, degree, save, uv_tap, *tensors):
        ctx.set_materialize_grads(False)
        fields, camera = tensors[:5], tensors[5:]
        if fields[0].device.type == "cpu":
            p = _project_plain(GaussianScene(*fields), _camera(camera), cfg,
                               uv_tap)
            outs = tuple(getattr(p, name) for name in PROJECTED_FIELDS)
        else:
            outs = kernels.project_fwd_cuda(fields, uv_tap, camera, cfg,
                                            degree)
        ctx.mark_non_differentiable(*(
            o for o, name in zip(outs, PROJECTED_FIELDS)
            if name not in DIFFERENTIABLE))
        if save:
            ctx.save_for_backward(*tensors)
        ctx.cfg, ctx.degree = cfg, degree
        return outs

    @staticmethod
    def backward(ctx, *grads):
        g = dict(zip(PROJECTED_FIELDS, grads))
        tensors = ctx.saved_tensors
        fields, camera = tensors[:5], tensors[5:]
        if all(g[name] is None for name in DIFFERENTIABLE):
            return (None,) * (4 + len(tensors))
        g_uv, g_conic, g_color, g_opacity = (
            torch.zeros_like(o) if g[name] is None else g[name]
            for name, o in zip(DIFFERENTIABLE,
                               (fields[0][:, :2], fields[0], fields[0],
                                fields[3])))
        if fields[0].device.type == "cpu":
            d = project_backward(GaussianScene(*fields), _camera(camera),
                                 ctx.cfg, g_uv, g_conic, g_color, g_opacity)
        else:
            d = kernels.project_bwd_cuda(fields, camera, ctx.cfg, ctx.degree,
                                         g_uv, g_conic, g_color, g_opacity)
        g_tap = g_uv if ctx.needs_input_grad[3] else None
        return (None, None, None, g_tap, *d, *(None,) * len(camera))


# The fields of ProjectedGaussians in order, and those with a gradient.
PROJECTED_FIELDS = tuple(f.name for f in dataclasses.fields(ProjectedGaussians))
DIFFERENTIABLE = ("uv", "conic", "color", "opacity")


def _camera(tensors) -> Camera:
    """A Camera of `kernels.CAMERA_FIELDS` (the projection matrix alone
    is not read)."""
    return Camera(proj=None, **dict(zip(kernels.CAMERA_FIELDS, tensors)))


def project_gaussians(
    scene, camera: Camera, cfg: RenderConfig, uv_tap=None
) -> ProjectedGaussians:
    """uv_tap: optional (N, 2) zeros added to the screen-space uv -- the
    gradient tap of the densification trigger. Zero-valued, so the image is
    unchanged. CUDA tensors run K8 (and K9 for the gradient); CPU tensors
    the plain versions."""
    fields = tuple(getattr(scene, f.name)
                   for f in dataclasses.fields(GaussianScene))
    camera_tensors = tuple(getattr(camera, name)
                           for name in kernels.CAMERA_FIELDS)
    inputs = (*fields, *camera_tensors) + (() if uv_tap is None else (uv_tap,))
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    outs = _Project.apply(cfg, sh_degree(scene, cfg), save, uv_tap, *fields,
                          *camera_tensors)
    return ProjectedGaussians(**dict(zip(PROJECTED_FIELDS, outs)))
