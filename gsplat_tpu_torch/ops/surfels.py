"""2D Gaussian splatting (Huang et al. 2024, "2D Gaussian Splatting for
Geometrically Accurate Radiance Fields", arXiv:2403.17888): the surfel
projection, its binning proxy and the ray-splat blend with its depth,
normal and distortion maps.

A surfel has a centre p, tangent axes t_u, t_v (the first two columns of
R(q)), scales s_u, s_v and the normal t_w = t_u x t_v. The projection
forms the 3x3 homography T = K [W | t] [s_u t_u, s_v t_v, p] (K the
intrinsics in the port's pixel convention: x = fx x_v / z + W / 2, pixel
centres at integer coordinates), the projected centre c = (T_02, T_12) /
T_22, the view-space normal flipped to face the camera, the SH colour
and the opacity. A pixel (x, y) meets the surfel's plane at (u, v) =
(c_0, c_1) / c_2, c = h_u x h_v, h_u = x T_2 - T_0, h_v = y T_2 - T_1
(T_i the rows of T); the object-space low-pass filter takes rho =
min(u^2 + v^2, FILTER_INV_SQUARE |(x, y) - c|^2), alpha = min(alpha_clamp,
o exp(-rho / 2)), and the pair's depth is T_2 . (u, v, 1) where the surfel
term wins, T_22 where the filter does; a pair nearer than DEPTH_NEAR is
skipped (the authors' rasterizer). Front to back per pixel, with 3DGS's
cut-offs (alpha >= alpha_min, transmittance >= transmittance_min), the
blend accumulates the colour, the normal map sum w n, the depth sum
sum w z and the distortion sum_i w_i sum_{j<i} w_j (m_i - m_j)^2 from
the running sums of w, w m and w m^2, m = FAR / (FAR - NEAR) (1 - NEAR /
z) the depth mapped to [0, 1] (the authors' CUDA code: squared
distances over ordered pairs, half the symmetric double sum).

The binning takes a `ProjectedGaussians` proxy: the surfel's reachable
region, the image of the disk u^2 + v^2 <= tau (tau = 2 ln(o /
alpha_min)) under T together with the filter's disk of radius sqrt(tau /
FILTER_INV_SQUARE) about c, lies inside the ellipse of covariance
Sigma_E + R^2 I about the image ellipse's centre e (Sigma_E that ellipse's,
from the dual conic T diag(tau, tau, -1) T^T in a frame centred on c; R
= |e - c| plus the filter's radius), widened by 0.1% and 0.01 px. Its
conic (tau times the inverse covariance) feeds K3's exact tile cull and
its bounding box the tile rect, so no pair that reaches alpha_min is
dropped. A surfel whose disk crosses the camera's plane (the dual conic
is no ellipse), or whose centre lies before znear, is culled.

The surfel table (N, 18) float32 is what the blend reads by each slot's
surfel id: T (9, row-major), c (2), the colour (3), the opacity, the
normal (3). CUDA tensors run K12 and K13 (`ops/cuda/surfels.py`,
`csrc/surfel_project.cu`) for the projection and K10 and K11
(`csrc/surfel_fwd.cu`, `csrc/surfel_bwd.cu`) for the blend, whose slot
gradients the gather backward sums per surfel (kernel K4, two passes of 9
rows); CPU tensors run the plain versions here, differentiated by
autograd.
"""

from __future__ import annotations

import dataclasses

import torch

from gsplat_tpu_torch.config import RenderConfig, cdiv
from gsplat_tpu_torch.models.gaussians import SurfelScene
from gsplat_tpu_torch.ops import sh as sh_mod
from gsplat_tpu_torch.ops.binning import gather_slots_bwd, kmax_eff
from gsplat_tpu_torch.ops.blend import tile_pixel_coords
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.ops.cuda import surfels as kernels
from gsplat_tpu_torch.ops.projection import (
    ProjectedGaussians,
    _affine,
    quat_to_rotmat,
    sh_degree,
)
from gsplat_tpu_torch.ops.raster_torch import (
    _tiles_to_image,
    _tiles_to_scalar_image,
)

# The object-space low-pass filter's 1 / sigma^2 (sigma = sqrt(2) / 2),
# and the depth range the distortion maps to [0, 1] (the authors' code).
FILTER_INV_SQUARE = 2.0
DEPTH_NEAR = 0.2
DEPTH_FAR = 100.0
# The binning proxy's widening: a relative share of the covariance and
# pixels added to R, for the roundings between it and the blend's test.
GROW = 1.001
MARGIN_PX = 0.01

# Columns of the surfel table (N, 18).
TAB_T, TAB_C, TAB_RGB, TAB_OP, TAB_N = 0, 9, 11, 14, 15


@dataclasses.dataclass
class ProjectedSurfels(ProjectedGaussians):
    """A projection of surfels: the binning's proxy fields of
    ProjectedGaussians (uv the reachable ellipse's centre over (W, H),
    conic its tau-scaled inverse covariance, depth the centre's view
    depth, radius its larger half-extent, rect, counts, mask, overflow),
    and what the blend reads."""

    transform: torch.Tensor = None  # (N, 9) T, row-major
    center: torch.Tensor = None     # (N, 2) c in pixels
    normal: torch.Tensor = None     # (N, 3) view-space, facing the camera


# The differentiable fields of ProjectedSurfels, in the table's order.
SURFEL_OUTPUTS = ("transform", "center", "color", "opacity", "normal")


def _homography(scene, camera: Camera, cfg: RenderConfig):
    """(T as 3 rows of 3 (N,) tensors, p_view (N, 3), the view-space
    normal before its flip as 3 (N,) tensors)."""
    p_view = _affine(scene.means, camera.view[:3])
    rot = quat_to_rotmat(scene.quats)
    s = torch.exp(scene.log_scales) * cfg.scale_modifier
    w = camera.view[:3, :3]

    def axis(k):  # W R[:, :, k], elementwise: no TF32 matmul
        return [w[i, 0] * rot[:, 0, k] + w[i, 1] * rot[:, 1, k]
                + w[i, 2] * rot[:, 2, k] for i in range(3)]

    au = [a * s[:, 0] for a in axis(0)]
    av = [a * s[:, 1] for a in axis(1)]
    cols = (au, av, [p_view[:, 0], p_view[:, 1], p_view[:, 2]])
    fx, fy = camera.focal[0], camera.focal[1]
    cxk, cyk = 0.5 * cfg.width, 0.5 * cfg.height
    t = [[fx * c[0] + cxk * c[2] for c in cols],
         [fy * c[1] + cyk * c[2] for c in cols],
         [c[2] for c in cols]]
    return t, p_view, axis(2)


@torch.no_grad()
def binning_proxy(t, center, tz, opacity, camera: Camera, cfg: RenderConfig):
    """(uv, conic, radius, rect, counts, mask, overflow) of surfels with
    homography rows t (3 rows of 3 (N,) tensors), centre (N, 2), centre
    depth tz and opacity (see the module's notes)."""
    tau = 2.0 * torch.log(torch.clamp_min(opacity / cfg.alpha_min, 1e-12))
    cx, cy = center[:, 0], center[:, 1]
    a0 = t[0][0] - cx * t[2][0]
    a1 = t[0][1] - cx * t[2][1]
    b0 = t[1][0] - cy * t[2][0]
    b1 = t[1][1] - cy * t[2][1]
    c0, c1, c2 = t[2]
    d00 = tau * (a0 * a0 + a1 * a1)
    d01 = tau * (a0 * b0 + a1 * b1)
    d11 = tau * (b0 * b0 + b1 * b1)
    d02 = tau * (a0 * c0 + a1 * c1)
    d12 = tau * (b0 * c0 + b1 * c1)
    d22 = tau * (c0 * c0 + c1 * c1) - c2 * c2
    bounded = d22 < 0.0
    d22s = torch.where(bounded, d22, torch.full_like(d22, -1.0))
    ex = d02 / d22s
    ey = d12 / d22s
    sxx = ex * ex - d00 / d22s
    syy = ey * ey - d11 / d22s
    sxy = ex * ey - d01 / d22s
    rf = torch.sqrt(torch.clamp_min(tau, 0.0) / FILTER_INV_SQUARE)
    r = torch.sqrt(ex * ex + ey * ey) + rf + MARGIN_PX
    r2 = r * r
    fxx = (sxx + r2) * GROW
    fyy = (syy + r2) * GROW
    fxy = sxy * GROW
    det = fxx * fyy - fxy * fxy
    det_s = torch.where(det > 0.0, det, torch.ones_like(det))
    conic = torch.stack([tau * fyy / det_s, -tau * fxy / det_s,
                         tau * fxx / det_s], -1)
    ext = torch.stack([torch.ceil(torch.sqrt(torch.clamp_min(fxx, 0.0))),
                       torch.ceil(torch.sqrt(torch.clamp_min(fyy, 0.0)))], -1)
    pix = torch.stack([cx + ex, cy + ey], -1)
    ts = float(cfg.tile_size)
    lo = torch.floor((pix - ext) / ts)
    hi = torch.floor((pix + ext) / ts) + 1.0
    tx0 = torch.clamp(lo[:, 0], 0, cfg.tiles_x).to(torch.int32)
    ty0 = torch.clamp(lo[:, 1], 0, cfg.tiles_y).to(torch.int32)
    tx1 = torch.clamp(hi[:, 0], 0, cfg.tiles_x).to(torch.int32)
    ty1 = torch.clamp(hi[:, 1], 0, cfg.tiles_y).to(torch.int32)
    rect = torch.stack([tx0, ty0, tx1, ty1], -1)
    valid = (bounded & (tz > camera.znear) & (opacity > cfg.alpha_min)
             & (det > 0.0) & torch.isfinite(pix).all(-1))
    area = torch.clamp_min(tx1 - tx0, 0) * torch.clamp_min(ty1 - ty0, 0)
    area = torch.where(valid, area, torch.zeros_like(area))
    uv = torch.stack([pix[:, 0] / float(cfg.width),
                      pix[:, 1] / float(cfg.height)], -1)
    return (uv, conic, ext.amax(-1), rect,
            torch.clamp_max(area, cfg.max_tiles_per_gaussian),
            valid & (area > 0), torch.any(area > cfg.max_tiles_per_gaussian))


def _project_surfels_plain(scene, camera: Camera,
                           cfg: RenderConfig) -> ProjectedSurfels:
    """The plain version of K12, differentiable by autograd."""
    t, p_view, nv = _homography(scene, camera, cfg)
    tz = p_view[:, 2]
    z_s = torch.where(tz > camera.znear, tz, torch.ones_like(tz))
    center = torch.stack([t[0][2] / z_s, t[1][2] / z_s], -1)
    dot = nv[0] * p_view[:, 0] + nv[1] * p_view[:, 1] + nv[2] * p_view[:, 2]
    flip = torch.where(dot < 0.0, 1.0, -1.0).detach()
    normal = torch.stack(nv, -1) * flip[:, None]
    opacity = torch.sigmoid(scene.opacity_logits)
    rel = scene.means - camera.cam_pos
    dirs = rel / torch.linalg.norm(rel, dim=-1, keepdim=True).clamp(min=1e-12)
    color = torch.clamp_min(
        sh_mod.eval_sh_unclamped(scene.sh, dirs, sh_degree(scene, cfg)), 0.0)
    uv, conic, radius, rect, counts, mask, overflow = binning_proxy(
        [[x.detach() for x in row] for row in t], center.detach(),
        tz.detach(), opacity.detach(), camera, cfg)
    transform = torch.stack([x for row in t for x in row], -1)
    return ProjectedSurfels(
        mask=mask, uv=uv, conic=conic, depth=tz.detach(), color=color,
        opacity=opacity, radius=radius, rect=rect, counts=counts,
        overflow=overflow, transform=transform, center=center,
        normal=normal)


_PROXY = ("mask", "uv", "conic", "depth", "radius", "rect", "counts",
          "overflow")


class _ProjectSurfels(torch.autograd.Function):
    """K12 forward and K13 backward (CUDA tensors). Saves its inputs alone
    (K13 recomputes the forward)."""

    @staticmethod
    def forward(ctx, cfg, degree, *tensors):
        ctx.set_materialize_grads(False)
        fields, camera = tensors[:5], tensors[5:]
        outs = kernels.surfel_project_fwd_cuda(fields, camera, cfg, degree)
        ctx.mark_non_differentiable(*outs[len(SURFEL_OUTPUTS):])
        ctx.save_for_backward(*tensors)
        ctx.cfg, ctx.degree = cfg, degree
        return outs

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        fields, camera = tensors[:5], tensors[5:]
        outs = grads[:len(SURFEL_OUTPUTS)]
        if all(g is None for g in outs):
            return (None,) * (2 + len(tensors))
        n = fields[0].shape[0]
        shapes = ((n, 9), (n, 2), (n, 3), (n,), (n, 3))
        g = [torch.zeros(s, device=fields[0].device) if x is None else x
             for x, s in zip(outs, shapes)]
        d = kernels.surfel_project_bwd_cuda(fields, camera, ctx.cfg,
                                            ctx.degree, *g)
        return (None, None, *d, *(None,) * len(camera))


def project_surfels(scene: SurfelScene, camera: Camera,
                    cfg: RenderConfig) -> ProjectedSurfels:
    """The surfels' projection: K12 (and K13 for the gradient) on CUDA
    tensors, the plain version on CPU ones."""
    if scene.means.device.type == "cpu":
        return _project_surfels_plain(scene, camera, cfg)
    fields = tuple(getattr(scene, f.name)
                   for f in dataclasses.fields(SurfelScene))
    cam = tuple(getattr(camera, name) for name in kernels.CAMERA_FIELDS)
    outs = _ProjectSurfels.apply(cfg, sh_degree(scene, cfg), *fields, *cam)
    k = len(SURFEL_OUTPUTS)
    vals = dict(zip(SURFEL_OUTPUTS, outs[:k]))
    vals.update(zip(_PROXY, outs[k:]))
    return ProjectedSurfels(**vals)


def surfel_table(proj: ProjectedSurfels) -> torch.Tensor:
    """The (N, 18) float32 table the blend reads by surfel id."""
    return torch.cat([proj.transform, proj.center, proj.color,
                      proj.opacity[:, None], proj.normal], 1).contiguous()


def _pair_terms(rec, px, py, cfg: RenderConfig):
    """The ray-splat terms of pixels (..., P, 1) against table rows rec
    (..., 1, G, 18): (rho, z, alpha_u, alpha, surf), each (..., P, G)."""
    def col(i):
        return rec[..., i]

    t = [[col(TAB_T + 3 * r + k) for k in range(3)] for r in range(3)]
    hu = [px * t[2][k] - t[0][k] for k in range(3)]
    hv = [py * t[2][k] - t[1][k] for k in range(3)]
    c0 = hu[1] * hv[2] - hu[2] * hv[1]
    c1 = hu[2] * hv[0] - hu[0] * hv[2]
    c2 = hu[0] * hv[1] - hu[1] * hv[0]
    dx = col(TAB_C) - px
    dy = col(TAB_C + 1) - py
    rho_f = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    with torch.no_grad():
        surf = (c2 != 0.0) & ((c0 * c0 + c1 * c1) <= rho_f * (c2 * c2))
    c2s = torch.where(surf, c2, torch.ones_like(c2))
    u = torch.where(surf, c0 / c2s, torch.zeros_like(c0))
    v = torch.where(surf, c1 / c2s, torch.zeros_like(c1))
    rho = torch.where(surf, u * u + v * v, rho_f)
    z = torch.where(surf, u * t[2][0] + v * t[2][1] + t[2][2], t[2][2])
    alpha_u = col(TAB_OP) * torch.exp(-0.5 * rho)
    alpha = torch.clamp_max(alpha_u, cfg.alpha_clamp)
    return rho, z, alpha, surf


def depth_to_m(z: torch.Tensor) -> torch.Tensor:
    """The distortion's depth in [0, 1]: FAR / (FAR - NEAR) (1 - NEAR / z)."""
    return DEPTH_FAR / (DEPTH_FAR - DEPTH_NEAR) * (1.0 - DEPTH_NEAR / z)


def _walk_plain(table, gid, ranges, cfg: RenderConfig, tally=None,
                tile_offset: int = 0):
    """The plain version of K10: the tiles' walk in blocks of
    cfg.block_size slots, differentiable by autograd in `table`; `ranges`
    (T + 1,) are those of the tiles from `tile_offset` on. Returns per-tile
    (T, P, k) planes: colour (3), trans (1), normal (3), depth sum (1),
    distortion (1)."""
    dev = table.device
    max_i = gid.shape[0]
    num_tiles = ranges.shape[0] - 1
    g = cfg.block_size
    start = ranges[:-1].long()[:, None]
    end = ranges[1:].long()[:, None]
    longest = int((end - start).max()) if num_tiles else 0
    px, py = tile_pixel_coords(
        torch.arange(num_tiles, device=dev) + tile_offset, cfg)
    p = cfg.pixels_per_tile
    z1 = torch.zeros((num_tiles, p, 1), device=dev)
    trans, acc, m1, m2 = z1 + 1.0, z1, z1, z1
    done = torch.zeros((num_tiles, p, 1), dtype=torch.bool, device=dev)
    color, normal = torch.zeros((num_tiles, p, 3), device=dev), \
        torch.zeros((num_tiles, p, 3), device=dev)
    dsum, dist = z1, z1
    lane = torch.arange(g, device=dev)[None, :]
    for i in range(cdiv(longest, g)):
        idx = start + i * g + lane                          # (T, G)
        in_range = (idx < end)[:, None, :]                  # (T, 1, G)
        rec = table[gid[idx.clamp(0, max_i - 1)].long()][:, None]
        rho, z, alpha, surf = _pair_terms(rec, px, py, cfg)
        ok = ((z >= DEPTH_NEAR) & (alpha >= cfg.alpha_min) & in_range
              & ~done)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        l1 = torch.log1p(-a)
        t_before = trans * torch.exp(torch.cumsum(l1, -1) - l1)
        p_incl = t_before * (1.0 - a)
        valid = p_incl >= cfg.transmittance_min
        w = torch.where(valid, a * t_before, torch.zeros_like(a))
        zs = torch.where(ok, z, torch.ones_like(z))
        m = depth_to_m(zs)
        wm = w * m
        wm2 = wm * m
        a_b = acc + torch.cumsum(w, -1) - w
        m1_b = m1 + torch.cumsum(wm, -1) - wm
        m2_b = m2 + torch.cumsum(wm2, -1) - wm2
        dist = dist + (w * (m * m * a_b + m2_b - 2.0 * m * m1_b)).sum(
            -1, keepdim=True)
        rgb = rec[..., 0, :, TAB_RGB:TAB_RGB + 3]           # (T, G, 3)
        nrm = rec[..., 0, :, TAB_N:TAB_N + 3]
        color = color + (w[..., None] * rgb[:, None]).sum(-2)
        normal = normal + (w[..., None] * nrm[:, None]).sum(-2)
        dsum = dsum + (w * zs).sum(-1, keepdim=True)
        acc = acc + w.sum(-1, keepdim=True)
        m1 = m1 + wm.sum(-1, keepdim=True)
        m2 = m2 + wm2.sum(-1, keepdim=True)
        trigger = (a > 0.0) & ~valid
        if tally is not None:
            tr = trigger.to(torch.int32)
            walked = (in_range & ~done
                      & (torch.cumsum(tr, -1) - tr == 0))
            tally["walked"] += int(walked.sum())
            tally["applied"] += int((valid & (a > 0.0)).sum())
        trans = torch.minimum(trans, torch.where(
            valid, p_incl, torch.full_like(p_incl, float("inf"))).amin(
                -1, keepdim=True))
        done = done | trigger.any(-1, keepdim=True)
    return color, trans, normal, dsum, dist


def blend_surfels_plain(table, gid, ranges, cfg: RenderConfig, tally=None):
    """(image (H, W, 3), trans (H, W), normal sum (H, W, 3), depth sum
    (H, W), distortion (H, W)) of the table's surfels in the binned
    lists, by the plain walk (differentiable by autograd)."""
    color, trans, normal, dsum, dist = _walk_plain(table, gid, ranges, cfg,
                                                   tally)

    def img(x):
        return _tiles_to_image(x.permute(0, 2, 1), cfg)

    def scalar(x):
        return _tiles_to_scalar_image(x[..., 0], cfg)

    return img(color), scalar(trans), img(normal), scalar(dsum), scalar(dist)


class _RasterizeSurfels(torch.autograd.Function):
    """K10's maps, differentiable in the surfel table; backward K11 (the
    18 slot gradients) and the gather backward's per-surfel sums (K4 over
    float32 rows, 9 at a time)."""

    @staticmethod
    def forward(ctx, table, gid, gidk, offsets, counts, ranges, cfg):
        outs, aux = kernels.surfel_fwd_cuda(table, gid, ranges, cfg)
        ctx.save_for_backward(table, gid, gidk, offsets, counts, ranges,
                              *outs, aux)
        ctx.cfg = cfg
        return outs

    @staticmethod
    def backward(ctx, *grads):
        table, gid, gidk, offsets, counts, ranges, *outs = ctx.saved_tensors
        outs, aux = outs[:-1], outs[-1]
        grads = [torch.zeros_like(o) if g is None else g.contiguous()
                 for g, o in zip(grads, outs)]
        dslot = kernels.surfel_bwd_cuda(table, gid, ranges, outs, aux, grads,
                                        ctx.cfg)
        kmax = kmax_eff(ctx.cfg)
        halves = [gather_slots_bwd(dslot[r:r + 9], gidk, offsets, counts,
                                   kmax, "variadic", "f32")
                  for r in (0, 9)]
        dtable = torch.cat(halves, 0).T
        return dtable, None, None, None, None, None, None


def rasterize_surfels(table, binned, cfg: RenderConfig):
    """(image (H, W, 3), trans (H, W), normal sum (H, W, 3), depth sum
    (H, W), distortion (H, W)) of the binned surfels, differentiable in
    the table: K10 and K11 on CUDA tensors, the plain walk on CPU ones.
    Needs the gidk stream (any binning but 'scatter')."""
    if table.device.type == "cpu":
        return blend_surfels_plain(table, binned.sorted_gid, binned.ranges,
                                   cfg)
    if binned.sorted_gidk is None:
        raise ValueError("surfels: binning='scatter' has no gidk stream to "
                         "sum the slot gradients by")
    return _RasterizeSurfels.apply(table, binned.sorted_gid,
                                   binned.sorted_gidk, binned.gauss_offsets,
                                   binned.gauss_counts, binned.ranges, cfg)


def expected_depth(dsum: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """sum w z / sum w (as 1 - T), 0 where nothing was blended."""
    hit = alpha > 0.0
    return torch.where(hit, dsum / torch.where(hit, alpha,
                                               torch.ones_like(alpha)),
                       torch.zeros_like(dsum))
