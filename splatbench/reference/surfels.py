"""The reference of 2D Gaussian splatting (Huang et al. 2024, "2D Gaussian
Splatting for Geometrically Accurate Radiance Fields", arXiv:2403.17888),
in plain PyTorch and float32 (TF32 off), on top of `reference/render.py`'s
binning, tiles and SH and `reference/train.py`'s L1 + DSSIM and Adam.

- Primitive (section 3): a surfel has a centre p, tangent axes t_u, t_v
  (the first two columns of R(q)), scales s_u, s_v (two log-scales) and
  the normal t_w = t_u x t_v.
- Projection (section 4.1): the homography T = K [W | t] [s_u t_u, s_v
  t_v, p], K the default pose's intrinsics (x = fx x_v / z + W / 2, pixel
  centres at integer coordinates), the centre c = (T_02, T_12) / T_22, the
  view-space normal W t_w turned to face the camera, the SH colour (+ 0.5,
  >= 0) and the opacity.
- Ray-splat intersection: for pixel (x, y), h_u = x T_2 - T_0, h_v = y T_2
  - T_1, c = h_u x h_v, (u, v) = (c_0, c_1) / c_2; the object-space
  low-pass filter rho = min(u^2 + v^2, F |(x, y) - c|^2), F =
  `filter_inv_square`; alpha = min(alpha_clamp, o exp(-rho / 2)); the
  pair's depth T_2 . (u, v, 1) where the surfel term is the smaller, T_22
  where the filter's is.
- Blend: front to back per pixel with 3DGS's cut-offs (a pair skipped
  below alpha_min, a pixel finished where its transmittance would fall
  below transmittance_min, that surfel left out); the colour, alpha = 1 -
  T, the normal map sum w n, the expected depth sum w z / alpha, and the
  distortion.
- Regularisers (section 4.2): L = L1 + DSSIM + lambda_dist mean(distortion)
  + lambda_normal mean(1 - N_r . N_d), N_d the normal of the expected depth
  map's points (central differences, cross product, normalised; 0 on the
  border) times alpha, detached.

Departures from the paper, as the authors' code is recalled where the
paper is silent, or as this benchmark chose:
- The distortion is the authors' CUDA code's, sum_i w_i sum_{j<i} w_j
  (m_i - m_j)^2 with m = far / (far - near) (1 - near / z), near 0.2 and
  far 100: squared distances of the depth mapped to [0, 1] over ordered
  pairs (half the symmetric double sum), not the paper's |z_i - z_j|.
- A pair nearer than `near` is skipped (the authors' rasterizer); where c_2
  = 0, or c_0^2 + c_1^2 > rho_f c_2^2, the filter's rho is taken.
- A surfel whose disk u^2 + v^2 <= tau (where alpha can reach alpha_min,
  tau = 2 ln(o / alpha_min)) crosses the camera's plane, or whose centre
  lies before znear, is culled. The rest are binned by a bound of this
  module's own (`bin_tiles`): every tile of the box that holds the disk's
  image (the authors' AABB of the dual conic, in pixel coordinates) and
  the filter's disk about c, widened by 1% and LOOSE_PX, with no conic
  cull; a pair outside the region reaches no alpha_min and leaves every
  sum as it is. Pairs whose depth keys tie in a tile come in the order the
  program's binning emits them where it lists the pair (its proxy, an
  ellipse bounding both regions, `_proxy`, culled by K3's test: order
  alone), the pairs it does not list after them by surfel id; so a pair
  the proxy dropped but which reaches alpha_min shows in the maps.
- The normals are compared in view space (the dot product is the world's).
- Expected depth, not median depth; both regularisers from step 0 (the
  published schedule starts them at 3,000 and 7,000 of 30,000 steps).
- No densification; the scene is synthetic and rendered at the
  configuration's own resolution, not the paper's datasets'.

Everything runs in blocks of tiles so that a 1080p frame fits. `tally`
counts the program's work: its slots, and the walked and the applied pairs
among the pairs its binning lists, and of those the applied pairs whose
rho the filter set (`filtered`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from splatbench.frozen import SCENE_FIELDS
from splatbench.reference import render as R
from splatbench.reference import train as T

FIELDS = SCENE_FIELDS
# (pixel, slot) lanes a block of tiles may hold (autograd keeps about 40
# floats a lane), and slots per chunk of a tile's list.
LANES = 1 << 24
CHUNK = 128
# Per-tile outputs: colour (3), transmittance, normal sum (3), depth sum,
# distortion.
OUT = 9
# The proxy's widening (the program's, so that ties are ordered alike).
GROW = 1.001
MARGIN_PX = 0.01
# This module's own bound: the boxes' half-extents times LOOSE_GROW plus
# LOOSE_PX pixels, over the float32 roundings of the box in pixel
# coordinates (about 1 px^2 in a squared extent at 2000 px).
LOOSE_GROW = 1.01
LOOSE_PX = 2.0

# Faults planted in the reference put in the program's place: the filter
# taken out (rho = u^2 + v^2 alone), the distortion left out of the loss,
# the normal left facing where its rotation puts it, the image loss over
# the first half of the rows.
FAULTS = ("no_filter", "no_distortion", "no_flip", "half")


def project(scene: dict, cam: dict, rc: dict, fault: str | None = None
            ) -> dict:
    """Per surfel: `table` (N, 18) float32 [T (9, row-major), c (2), rgb
    (3), opacity, normal (3)], differentiable in the scene; and, detached,
    the proxy's binning inputs of `render.bin_tiles`: `feats` (rows 0-4:
    the bounding ellipse's centre in pixels and its conic), `tau`,
    `depth`, `rect` (N, 4) int64 and `valid`; and this module's own bound,
    `own_rect` (N, 4) int64 and `valid_own` (`bin_tiles`). Elementwise, in
    the program's order of operations (the depth key and the proxy's
    rounding then agree)."""
    pos = scene["means"]
    view = cam["view"]
    vx, vy, tz = (R._rows(pos, view, i) for i in range(3))
    rot = R.rotation(scene["quats"])
    s = torch.exp(scene["log_scales"]) * rc["scale_modifier"]
    w = view[:3, :3]

    def axis(k):
        return [w[i, 0] * rot[:, 0, k] + w[i, 1] * rot[:, 1, k]
                + w[i, 2] * rot[:, 2, k] for i in range(3)]

    au = [a * s[:, 0] for a in axis(0)]
    av = [a * s[:, 1] for a in axis(1)]
    cols = (au, av, [vx, vy, tz])
    fx, fy = cam["focal"][0], cam["focal"][1]
    hw, hh = 0.5 * rc["width"], 0.5 * rc["height"]
    t = [[fx * c[0] + hw * c[2] for c in cols],
         [fy * c[1] + hh * c[2] for c in cols],
         [c[2] for c in cols]]
    zs = torch.where(tz > cam["znear"], tz, torch.ones_like(tz))
    cx, cy = t[0][2] / zs, t[1][2] / zs
    nv = axis(2)
    dot = nv[0] * vx + nv[1] * vy + nv[2] * tz
    sign = torch.where(dot < 0.0, 1.0, -1.0).detach()
    if fault == "no_flip":
        sign = torch.ones_like(sign)
    normal = torch.stack(nv, -1) * sign[:, None]
    opacity = torch.sigmoid(scene["opacity_logits"])
    dirs = pos - cam["cam_pos"]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
    degree = min(rc["sh_degree"], int(round(scene["sh"].shape[1] ** 0.5)) - 1)
    rgb = R.sh_rgb(scene["sh"], dirs, degree)
    table = torch.cat([torch.stack([x for row in t for x in row], -1),
                       torch.stack([cx, cy], -1), rgb, opacity[:, None],
                       normal], 1)
    with torch.no_grad():
        rows = [[x.detach() for x in row] for row in t]
        out = _proxy(rows, cx.detach(), cy.detach(), tz.detach(),
                     opacity.detach(), cam, rc)
        own = _own_rect(rows, cx.detach(), cy.detach(), out["tau"], rc)
        area = (own[:, 2] - own[:, 0]) * (own[:, 3] - own[:, 1])
        out.update(own_rect=own, valid_own=(
            (area > 0) & (tz.detach() > cam["znear"])
            & (opacity.detach() > rc["alpha_min"])))
    out.update(table=table, depth=tz.detach())
    return out


def _own_rect(t, cx, cy, tau, rc) -> torch.Tensor:
    """(N, 4) int64 tile rects of this module's own bound: the box of the
    image of u^2 + v^2 <= tau under T (the authors' AABB: the dual conic D
    = T diag(tau, tau, -1) T^T, centre (D_02, D_12) / D_22, squared
    half-extents its square minus (D_00, D_11) / D_22) joined with the
    box of the filter's disk about c, each half-extent widened by
    LOOSE_GROW and LOOSE_PX; empty where the image is no ellipse
    (D_22 >= 0) or alpha never reaches alpha_min (tau < 0)."""
    def dual(i, j):
        return tau * (t[i][0] * t[j][0] + t[i][1] * t[j][1]) \
            - t[i][2] * t[j][2]

    d22 = dual(2, 2)
    ok = (d22 < 0.0) & (tau >= 0.0)
    d22s = torch.where(ok, d22, torch.full_like(d22, -1.0))
    ex, ey = dual(0, 2) / d22s, dual(1, 2) / d22s
    hx = torch.sqrt(torch.clamp_min(ex * ex - dual(0, 0) / d22s, 0.0))
    hy = torch.sqrt(torch.clamp_min(ey * ey - dual(1, 1) / d22s, 0.0))
    rf = torch.sqrt(torch.clamp_min(tau, 0.0) / rc["surfel_filter"])

    def widen(h):
        return h * LOOSE_GROW + LOOSE_PX

    lo_x = torch.minimum(ex - widen(hx), cx - widen(rf))
    hi_x = torch.maximum(ex + widen(hx), cx + widen(rf))
    lo_y = torch.minimum(ey - widen(hy), cy - widen(rf))
    hi_y = torch.maximum(ey + widen(hy), cy + widen(rf))
    ts = float(rc["tile_size"])
    ntx, nty, _ = R.grid(rc)
    rect = torch.stack([
        torch.clamp(torch.floor(lo_x / ts), 0, ntx),
        torch.clamp(torch.floor(lo_y / ts), 0, nty),
        torch.clamp(torch.floor(hi_x / ts) + 1.0, 0, ntx),
        torch.clamp(torch.floor(hi_y / ts) + 1.0, 0, nty)], 1)
    finite = torch.isfinite(rect).all(-1) & ok
    rect = torch.where(finite[:, None], rect, torch.zeros_like(rect))
    return rect.to(torch.int64)


def bin_tiles(proj: dict, rc: dict) -> dict:
    """The depth-ordered list of each tile over this module's own bound
    (`_own_rect`, every tile of it): `gid`, `counts`, `starts` as
    `render.bin_tiles` gives them, and `listed` (S,) bool, whether the
    program's binning lists the pair. Pairs order by the depth key; among
    ties, the pairs the program lists in its order (`render.bin_tiles` of
    the proxy, whose `rect_lanes`, `largest_rect` and `slots` count the
    program's work), then the others by surfel id. A surfel takes part
    where `valid_own`: its disk's image is an ellipse, its centre lies past
    znear and its opacity above alpha_min."""
    prog = R.bin_tiles(proj, rc)
    ntx, nty, depth_bits = R.grid(rc)
    n = proj["depth"].shape[0]
    dev = proj["depth"].device
    rect = proj["own_rect"]
    ids = torch.nonzero(proj["valid_own"]).flatten()
    w = (rect[ids, 2] - rect[ids, 0]).clamp_min(0)
    area = w * (rect[ids, 3] - rect[ids, 1]).clamp_min(0)
    gid = torch.repeat_interleave(ids, area)
    first = torch.repeat_interleave(torch.cumsum(area, 0) - area, area)
    rep_w = torch.repeat_interleave(w, area)
    k = torch.arange(gid.shape[0], device=dev) - first
    tile = (rect[gid, 1] + torch.div(k, rep_w, rounding_mode="floor")) \
        * ntx + rect[gid, 0] + k % rep_w
    del first, rep_w, k
    # Each pair's place in the program's lists, where they hold it.
    p_tile = torch.repeat_interleave(
        torch.arange(ntx * nty, device=dev), prog["counts"])
    p_pair = p_tile * n + prog["gid"]
    pair = tile * n + gid
    if p_pair.numel():
        p_sorted, p_pos = torch.sort(p_pair)
        at = torch.searchsorted(p_sorted, pair).clamp_max(p_pair.numel() - 1)
        listed = p_sorted[at] == pair
        rank = torch.where(listed, p_pos[at], p_pair.numel() + gid)
    else:
        listed = torch.zeros_like(pair, dtype=torch.bool)
        rank = gid
    bits = proj["depth"].float().contiguous().view(torch.int32).to(
        torch.int64)
    dq = (bits & 0xFFFFFFFF) >> (31 - depth_bits)
    key = (tile << depth_bits) | dq[gid]
    order = torch.sort(rank, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    counts = torch.bincount(tile, minlength=ntx * nty)
    return dict(gid=gid[order], listed=listed[order], counts=counts,
                starts=torch.cumsum(counts, 0) - counts,
                slots=int(prog["gid"].numel()),
                rect_lanes=prog["rect_lanes"],
                largest_rect=prog["largest_rect"])


def _proxy(t, cx, cy, tz, opacity, cam, rc) -> dict:
    """The bounding ellipse of each surfel's reachable region: the image
    of u^2 + v^2 <= tau (the dual conic T diag(tau, tau, -1) T^T, in a
    frame centred on c) and the filter's disk of radius sqrt(tau / F)
    about c lie in the ellipse of covariance Sigma + R^2 I about the
    image's centre e, R = |e - c| + sqrt(tau / F)."""
    amin = rc["alpha_min"]
    tau = 2.0 * torch.log(torch.clamp_min(opacity / amin, 1e-12))
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
    ex, ey = d02 / d22s, d12 / d22s
    sxx = ex * ex - d00 / d22s
    syy = ey * ey - d11 / d22s
    sxy = ex * ey - d01 / d22s
    rf = torch.sqrt(torch.clamp_min(tau, 0.0) / rc["surfel_filter"])
    r = torch.sqrt(ex * ex + ey * ey) + rf + MARGIN_PX
    r2 = r * r
    fxx, fyy, fxy = (sxx + r2) * GROW, (syy + r2) * GROW, sxy * GROW
    det = fxx * fyy - fxy * fxy
    det_s = torch.where(det > 0.0, det, torch.ones_like(det))
    conic = torch.stack([tau * fyy / det_s, -tau * fxy / det_s,
                         tau * fxx / det_s], 0)
    ext = torch.stack([torch.ceil(torch.sqrt(torch.clamp_min(fxx, 0.0))),
                       torch.ceil(torch.sqrt(torch.clamp_min(fyy, 0.0)))], -1)
    pix = torch.stack([cx + ex, cy + ey], -1)
    ts = float(rc["tile_size"])
    ntx, nty, _ = R.grid(rc)
    lo = torch.floor((pix - ext) / ts)
    hi = torch.floor((pix + ext) / ts) + 1.0
    rect = torch.stack([
        torch.clamp(lo[:, 0], 0, ntx), torch.clamp(lo[:, 1], 0, nty),
        torch.clamp(hi[:, 0], 0, ntx), torch.clamp(hi[:, 1], 0, nty),
    ], 1).to(torch.int64)
    area = ((rect[:, 2] - rect[:, 0]).clamp_min(0)
            * (rect[:, 3] - rect[:, 1]).clamp_min(0))
    seen = opacity > amin
    valid = (bounded & (tz > cam["znear"]) & seen & (det > 0.0)
             & torch.isfinite(pix).all(-1) & (area > 0))
    # The program hands K3 the centre as uv and scales it back by the
    # image's size: the same float32 steps here.
    gx = (pix[:, 0] / float(rc["width"])) * float(rc["width"])
    gy = (pix[:, 1] / float(rc["height"])) * float(rc["height"])
    feats = torch.cat([gx[None], gy[None], conic], 0)
    return dict(feats=feats, tau=torch.where(seen, tau, -1.0), rect=rect,
                valid=valid)


def blend(rec: torch.Tensor, in_range: torch.Tensor, tiles: torch.Tensor,
          rc: dict, sc: dict, dtype=torch.float32, fault: str | None = None,
          tally: dict | None = None,
          listed: torch.Tensor | None = None) -> torch.Tensor:
    """The per-tile outputs (B, P, 9) of a block: rec (B, L, 18) the table
    rows of its slots in list order (zero past each list), in_range (B,
    L), and listed (B, L), the slots the tally counts. `dtype`: the
    blend's weights and sums in it (the control); the intersection itself
    stays float32."""
    ts = rc["tile_size"]
    ntx = R.grid(rc)[0]
    dev = rec.device
    nb, length = in_range.shape
    p = torch.arange(ts * ts, device=dev)
    px = ((tiles % ntx) * ts).float()[:, None, None] + (p % ts).float()[
        None, :, None]
    py = (torch.div(tiles, ntx, rounding_mode="floor") * ts).float()[
        :, None, None] + (p // ts).float()[None, :, None]
    amin, aclamp, tmin = rc["alpha_min"], rc["alpha_clamp"], \
        rc["transmittance_min"]
    filt, near, far = sc["filter_inv_square"], sc["near"], sc["far"]

    def z1():
        return torch.zeros((nb, ts * ts, 1), device=dev, dtype=dtype)

    trans, acc, m1, m2 = z1() + 1.0, z1(), z1(), z1()
    done = torch.zeros((nb, ts * ts, 1), device=dev, dtype=torch.bool)
    color = torch.zeros((nb, ts * ts, 3), device=dev, dtype=dtype)
    normal = torch.zeros((nb, ts * ts, 3), device=dev, dtype=dtype)
    dsum, dist = z1(), z1()
    for s0 in range(0, length, CHUNK):
        g = rec[:, None, s0:s0 + CHUNK]                  # (B, 1, C, 18)
        rng = in_range[:, None, s0:s0 + CHUNK]

        def col(i):
            return g[..., i]

        tr = [[col(3 * r + k) for k in range(3)] for r in range(3)]
        hu = [px * tr[2][k] - tr[0][k] for k in range(3)]
        hv = [py * tr[2][k] - tr[1][k] for k in range(3)]
        c0 = hu[1] * hv[2] - hu[2] * hv[1]
        c1 = hu[2] * hv[0] - hu[0] * hv[2]
        c2 = hu[0] * hv[1] - hu[1] * hv[0]
        dx = col(9) - px
        dy = col(10) - py
        rho_f = filt * (dx * dx + dy * dy)
        with torch.no_grad():
            surf = (c2 != 0.0) & (
                (fault == "no_filter") | ((c0 * c0 + c1 * c1)
                                          <= rho_f * (c2 * c2)))
        c2s = torch.where(surf, c2, torch.ones_like(c2))
        u = torch.where(surf, c0 / c2s, torch.zeros_like(c0))
        v = torch.where(surf, c1 / c2s, torch.zeros_like(c1))
        big = torch.full_like(rho_f, float("inf"))
        rho = torch.where(surf, u * u + v * v,
                          big if fault == "no_filter" else rho_f).to(dtype)
        z = torch.where(surf, u * tr[2][0] + v * tr[2][1] + tr[2][2],
                        tr[2][2]).to(dtype)
        op = col(14).to(dtype)
        alpha = torch.clamp_max(op * torch.exp(-0.5 * rho), aclamp)
        ok = (z >= near) & (alpha >= amin) & rng & ~done
        a_ = torch.where(ok, alpha, torch.zeros_like(alpha))
        incl = trans * torch.cumprod(1.0 - a_, -1)
        valid = (incl >= tmin).detach()
        before = torch.cat([trans, incl[..., :-1]], -1)
        w = torch.where(valid, a_ * before, torch.zeros_like(a_))
        zs = torch.where(ok, z, torch.ones_like(z))
        m = far / (far - near) * (1.0 - near / zs)
        wm = w * m
        wm2 = wm * m
        a_b = acc + torch.cumsum(w, -1) - w
        m1_b = m1 + torch.cumsum(wm, -1) - wm
        m2_b = m2 + torch.cumsum(wm2, -1) - wm2
        dist = dist + (w * (m * m * a_b + m2_b - 2.0 * m * m1_b)).sum(
            -1, keepdim=True)
        rgb = g[:, 0, :, 11:14].to(dtype)                # (B, C, 3)
        nrm = g[:, 0, :, 15:18].to(dtype)
        with R.full_fp32():
            color = color + torch.einsum("bpc,bck->bpk", w, rgb)
            normal = normal + torch.einsum("bpc,bck->bpk", w, nrm)
        dsum = dsum + (w * zs).sum(-1, keepdim=True)
        acc = acc + w.sum(-1, keepdim=True)
        m1 = m1 + wm.sum(-1, keepdim=True)
        m2 = m2 + wm2.sum(-1, keepdim=True)
        trigger = (a_ > 0) & ~valid
        if tally is not None:
            t = trigger.to(torch.int32)
            lst = listed[:, None, s0:s0 + CHUNK]
            walked = rng & lst & ~done & (torch.cumsum(t, -1) - t == 0)
            applied = valid & (a_ > 0) & lst
            tally["walked"] += int(walked.sum())
            tally["applied"] += int(applied.sum())
            tally["filtered"] += int((applied & ~surf).sum())
        inf = torch.full_like(incl, float("inf"))
        trans = torch.minimum(trans, torch.where(valid, incl, inf).amin(
            -1, keepdim=True))
        done = done | trigger.any(-1, keepdim=True)
        if bool(done.all()):
            break
    return torch.cat([color, trans, normal, dsum, dist], -1)


def tile_blocks(binned: dict, rc: dict):
    """`render.tile_blocks` at this module's lane budget: blocks of tiles,
    heaviest first, (tiles (B,), slots (B, L) int64, -1 past each list)."""
    pixels = rc["tile_size"] ** 2
    counts = binned["counts"]
    order = torch.argsort(counts, descending=True)
    c_host = counts[order].tolist()
    i = 0
    while i < len(c_host) and c_host[i] > 0:
        longest = c_host[i]
        b = max(1, min(len(c_host) - i, LANES // (pixels * longest)))
        tiles = order[i:i + b]
        ar = torch.arange(longest, device=counts.device)
        slots = binned["starts"][tiles, None] + ar
        yield tiles, torch.where(ar < counts[tiles, None], slots, -1)
        i += b


def _rows_of(table: torch.Tensor, binned: dict, slots: torch.Tensor):
    """(B, L, 18) table rows of a block's slots (zero past each list), the
    in-range mask and the slots the program's binning lists."""
    in_range = slots >= 0
    gid = binned["gid"][slots.clamp_min(0)]
    listed = binned["listed"][slots.clamp_min(0)] & in_range
    return table[gid] * in_range[..., None], in_range, listed


def _to_image(tiles: torch.Tensor, rc: dict) -> torch.Tensor:
    """(T, P, K) -> (H, W, K)."""
    ts = rc["tile_size"]
    ntx, nty, _ = R.grid(rc)
    k = tiles.shape[-1]
    img = tiles.reshape(nty, ntx, ts, ts, k).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * ts, ntx * ts, k)[:rc["height"], :rc["width"]]


def _to_tiles(image: torch.Tensor, rc: dict) -> torch.Tensor:
    """(H, W, K) -> (T, P, K), zero on the edge tiles' padding."""
    ts = rc["tile_size"]
    ntx, nty, _ = R.grid(rc)
    k = image.shape[-1]
    pad = image.new_zeros((nty * ts, ntx * ts, k))
    pad[:rc["height"], :rc["width"]] = image
    return pad.reshape(nty, ts, ntx, ts, k).permute(0, 2, 1, 3, 4).reshape(
        nty * ntx, ts * ts, k)


def maps_of(table: torch.Tensor, binned: dict, rc: dict, sc: dict,
            dtype=torch.float32, fault=None, tally=None) -> torch.Tensor:
    """The (H, W, 9) per-pixel outputs of the binned lists, block by
    block, without gradient."""
    ts = rc["tile_size"]
    ntx, nty, _ = R.grid(rc)
    out = torch.zeros((ntx * nty, ts * ts, OUT), device=table.device)
    out[..., 3] = 1.0
    with torch.no_grad():
        for tiles, slots in tile_blocks(binned, rc):
            rec, in_range, listed = _rows_of(table, binned, slots)
            out[tiles] = blend(rec, in_range, tiles, rc, sc, dtype, fault,
                               tally, listed).float()
    return _to_image(out, rc)


def finish(raw: torch.Tensor) -> dict:
    """The named maps of (H, W, 9) outputs: image, alpha, normals, depth
    (expected), distortion."""
    image, trans, normals = raw[..., :3], raw[..., 3], raw[..., 4:7]
    dsum, dist = raw[..., 7], raw[..., 8]
    alpha = 1.0 - trans
    hit = alpha > 0.0
    depth = torch.where(hit, dsum / torch.where(hit, alpha,
                                                torch.ones_like(alpha)),
                        torch.zeros_like(dsum))
    return dict(image=image, alpha=alpha, normals=normals, depth=depth,
                distortion=dist)


def render(scene: dict, cam: dict, rc: dict, sc: dict, dtype=torch.float32,
           fault: str | None = None, tally: dict | None = None) -> dict:
    """The maps of the surfels from `cam` (`finish`'s names), with the
    projection and the binned lists."""
    rc = dict(rc, surfel_filter=sc["filter_inv_square"])
    with torch.no_grad():
        proj = project(scene, cam, rc, fault)
        binned = bin_tiles(proj, rc)
    if tally is not None:
        tally.update(walked=0, applied=0, filtered=0,
                     slots=binned["slots"],
                     rect_lanes=binned["rect_lanes"],
                     largest_rect=binned["largest_rect"])
    out = finish(maps_of(proj["table"], binned, rc, sc, dtype, fault, tally))
    out.update(proj=proj, binned=binned)
    return out


def depth_to_normal(depth: torch.Tensor, cam: dict) -> torch.Tensor:
    """View-space normals (H, W, 3) of the expected depth map's points:
    pixel (x, y) at depth z is z ((x - W / 2) / fx, (y - H / 2) / fy, 1);
    central differences along the rows and the columns, crossed,
    normalised; 0 on the border."""
    h, w = depth.shape
    dev = depth.device
    rx = (torch.arange(w, device=dev, dtype=torch.float32) - 0.5 * w) \
        / cam["focal"][0]
    ry = (torch.arange(h, device=dev, dtype=torch.float32) - 0.5 * h) \
        / cam["focal"][1]
    pts = torch.stack([depth * rx[None, :], depth * ry[:, None], depth], -1)
    n = F.normalize(torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1],
                                       pts[1:-1, 2:] - pts[1:-1, :-2]),
                    dim=-1)
    out = torch.zeros_like(pts)
    out[1:-1, 1:-1] = n
    return out


def loss_fn(maps: dict, target: torch.Tensor, cam: dict, tc: dict, sc: dict,
            rows: int | None = None, fault: str | None = None):
    """L1 + DSSIM (over the first `rows` rows where given) + lambda_dist
    mean(distortion) + lambda_normal mean(1 - N_r . N_d)."""
    loss = T.loss_fn(maps["image"][:rows], target[:rows], tc["ssim_weight"])
    n_d = depth_to_normal(maps["depth"], cam) * maps["alpha"].detach()[
        ..., None]
    normal_loss = (1.0 - (maps["normals"] * n_d).sum(-1)).mean()
    if fault != "no_distortion":
        loss = loss + sc["lambda_dist"] * maps["distortion"].mean()
    return loss + sc["lambda_normal"] * normal_loss


def render_vjp(table: torch.Tensor, binned: dict, g_raw: torch.Tensor,
               rc: dict, sc: dict, dtype=torch.float32, fault=None):
    """d loss / d the (N, 18) table, given d loss / d the (H, W, 9)
    outputs: each block's blend re-run with its slots' rows as the leaf,
    the slots' gradients summed per surfel in float32."""
    g_tiles = _to_tiles(g_raw, rc)
    dtable = torch.zeros_like(table)
    for tiles, slots in tile_blocks(binned, rc):
        with torch.no_grad():
            rec, in_range, _ = _rows_of(table, binned, slots)
        rec.requires_grad_(True)
        with torch.enable_grad():
            out = blend(rec, in_range, tiles, rc, sc, dtype, fault)
            (d,) = torch.autograd.grad(out, rec, g_tiles[tiles].to(out.dtype))
        gid = binned["gid"][slots.clamp_min(0)].flatten()
        keep = in_range.flatten()
        dtable.index_add_(0, gid[keep], d.float().reshape(-1, 18)[keep])
    return dtable


def loss_and_grads(params: dict, cam: dict, target: torch.Tensor, rc: dict,
                   tc: dict, sc: dict, dtype=torch.float32,
                   rows: int | None = None, fault: str | None = None
                   ) -> tuple[float, dict]:
    """The step's loss and d loss / d each scene field."""
    rc = dict(rc, surfel_filter=sc["filter_inv_square"])
    leaves = {k: params[k].detach().requires_grad_(True) for k in FIELDS}
    with torch.enable_grad(), R.full_fp32():
        proj = project(leaves, cam, rc, fault)
        binned = bin_tiles(proj, rc)
        table = proj["table"]
        raw = maps_of(table.detach(), binned, rc, sc, dtype,
                      fault).requires_grad_(True)
        loss = loss_fn(finish(raw), target, cam, tc, sc, rows, fault)
        (g_raw,) = torch.autograd.grad(loss, raw)
        dtable = render_vjp(table.detach(), binned, g_raw, rc, sc, dtype,
                            fault)
        grads = torch.autograd.grad(table, list(leaves.values()), dtable,
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(leaves, grads)}
    return float(loss.detach()), grads


def run(scene: dict, cams: list, targets: torch.Tensor, rc: dict, tc: dict,
        sc: dict, dtype=torch.float32, rows: int | None = None,
        fault: str | None = None) -> dict:
    """len(cams) steps from `scene`, one view a step, as `train.run`: each
    step's loss, the first step's gradient norm per field and the norm of
    each field's change over all the steps."""
    params = {k: scene[k].detach().clone() for k in FIELDS}
    start = {k: v.clone() for k, v in params.items()}
    opt = T.Adam(params, {k: tc["lr"] * tc["lr_scales"][k] for k in params},
                 tuple(tc["betas"]), tc["eps"])
    losses, grad1 = [], None
    for cam, target in zip(cams, targets):
        loss, grads = loss_and_grads(opt.params, cam, target, rc, tc, sc,
                                     dtype, rows, fault)
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
        opt.step(grads)
    change = {k: float(torch.linalg.vector_norm(opt.params[k] - start[k]))
              for k in params}
    return dict(losses=losses, grad_norms=grad1, change_norms=change)
