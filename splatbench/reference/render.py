"""The reference render: 3D Gaussian splatting (Kerbl et al. 2023) in plain
PyTorch, from the configuration file's `render` section.

- Projection: the EWA splat, Sigma = R diag(s^2) R^T, the 2D covariance
  J W Sigma W^T J^T plus `lowpass` on its diagonal, the view-space tangent
  clamped at 1.3 tan(fov / 2), culled outside `frustum_ndc_limit` and
  behind znear; the conic, the `radius_sigma` radius of the larger
  eigenvalue (clamped by `eigen_clamp`), and the tile rect: that radius,
  cut to the box where alpha can still reach `alpha_min`.
- Colour: real SH of degree 3 (the graphdeco constants), + 0.5, >= 0.
- Binning: every tile of the rect whose pixel centres the splat can reach
  with alpha >= alpha_min (the least quadratic form over the tile), ordered
  by the 32-bit key (tile << depth_bits | the top depth_bits of the f32
  view depth); splats whose keys tie in a tile keep the order in which the
  configuration's binning emits them (splat order, or the tiered route's
  tiers and rankings). A rect past the configuration's largest walk, or a
  tier past its rows, is the program's overflow; the reference renders
  every rect whole.
- Stream: the features the configuration's `stream_format` carries
  (ops/stream16 in the program; here written from the format's own
  statement): u16 pixel positions over 1.1x the image, bf16 conic and
  opacity, bf16 or 11/11/10-bit colours; gradients pass straight through.
- Blend: front to back per pixel, pixel centres at integer coordinates,
  power = -q / 2, alpha = min(alpha_clamp, opacity exp(power)), a pair
  skipped where power > 0 or alpha < alpha_min, a pixel finished for good
  where its transmittance would fall below `transmittance_min` (that
  Gaussian left out).

The projection is evaluated in the order of operations of the method's
unrolled algebra (the JAX package's, which the program keeps), so that the
keys (and the order of Gaussians whose depths tie in them) and the values
the stream rounds agree bit for bit: a position one u16 step off moves a
splat by 1.1 W / 65535 px (0.064 px at 4K), and float32 cancellation in the
2D covariance of a large thin splat can put its conic on the other side of
a bf16 rounding, which moves its alpha by up to 1% over its whole
footprint. Everything runs in blocks of tiles so that it fits.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from splatbench import frozen

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# (pixel, Gaussian) lanes a block of tiles may hold at once, and Gaussians
# per chunk of a tile's list.
LANES = 1 << 26
CHUNK = 256


@contextlib.contextmanager
def full_fp32():
    """float32 matmuls and convolutions without TF32."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def camera(view: np.ndarray, width: int, height: int, device,
           znear: float = frozen.DEFAULT_ZNEAR,
           zfar: float = frozen.DEFAULT_ZFAR) -> dict:
    """A pose with the default intrinsics (focal W, H px) as float32
    tensors."""
    fx, fy = float(width), float(height)
    fov_x, fov_y = frozen.focal2fov(fx, width), frozen.focal2fov(fy, height)
    proj = frozen.perspective_matrix(znear, zfar, fov_x, fov_y)
    view = np.asarray(view, dtype=np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=torch.device(device))

    return dict(view=t(view), full_proj=t(proj @ view),
                cam_pos=t(np.linalg.inv(view)[:3, 3]), focal=t([fx, fy]),
                tan_fov=t([math.tan(fov_x / 2), math.tan(fov_y / 2)]),
                znear=t(znear))


def _rows(pos, m, i):
    """Row i of the affine matrix m applied to pos, summed left to right."""
    return (pos[:, 0] * m[i, 0] + pos[:, 1] * m[i, 1]
            + pos[:, 2] * m[i, 2]) + m[i, 3]


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of unnormalised (w, x, y, z) quaternions."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def sh_rgb(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, K, 3) coefficients at unit directions (N, 3) -> (N, 3), the
    bands summed in turn."""
    c = sh.unbind(-2)
    x, y, z = (dirs[:, i:i + 1] for i in range(3))
    rgb = SH_C0 * c[0]
    if degree >= 1:
        rgb = rgb + SH_C1 * (-y * c[1] + z * c[2] - x * c[3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        rgb = rgb + (SH_C2[0] * xy * c[4] + SH_C2[1] * yz * c[5]
                     + SH_C2[2] * (2.0 * zz - xx - yy) * c[6]
                     + SH_C2[3] * xz * c[7] + SH_C2[4] * (xx - yy) * c[8])
    if degree >= 3:
        rgb = rgb + (SH_C3[0] * y * (3.0 * xx - yy) * c[9]
                     + SH_C3[1] * xy * z * c[10]
                     + SH_C3[2] * y * (4.0 * zz - xx - yy) * c[11]
                     + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c[12]
                     + SH_C3[4] * x * (4.0 * zz - xx - yy) * c[13]
                     + SH_C3[5] * z * (xx - yy) * c[14]
                     + SH_C3[6] * x * (xx - 3.0 * yy) * c[15])
    return torch.clamp_min(rgb + 0.5, 0.0)


def _cov2d_unrolled(t0, t1, rot, s2, lowpass):
    """The 2D covariance T Sigma T^T (+ lowpass on its diagonal), Sigma =
    R diag(s^2) R^T, entry by entry."""
    sig = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            acc = s2[:, 0] * rot[:, i, 0] * rot[:, j, 0]
            acc = acc + s2[:, 1] * rot[:, i, 1] * rot[:, j, 1]
            sig[i][j] = sig[j][i] = acc + s2[:, 2] * rot[:, i, 2] * rot[:, j, 2]

    def quad(u, v):
        return sum(u[i] * sum(sig[i][j] * v[j] for j in range(3))
                   for i in range(3))

    return (quad(t0, t0) + lowpass, quad(t0, t1), quad(t1, t1) + lowpass)


ORDERS = ("unrolled", "matmul")


def project(scene: dict, cam: dict, rc: dict,
            order: str = "unrolled") -> dict:
    """Per Gaussian: `feats` (9, N) float32 [x px, y px, conic a, b, c, r,
    g, b, opacity], differentiable in the scene; `depth` (N,), `rect`
    (N, 4) int64 tile box [x0, y0, x1, y1), `valid` (N,) and `tau` (N,),
    the largest quadratic form at which alpha reaches alpha_min, detached.
    Elementwise, in the order of operations of the method's unrolled
    algebra: rounding the conic to the stream's bf16 magnifies any other
    order's float32 differences (a bf16 step moves a large splat's alpha
    over its whole footprint). `order` "matmul" evaluates Sigma and the
    2D covariance as batched matrix products instead, in float32: a sound
    reordering of the same arithmetic, which shows how far one moves the
    numbers that `correct` compares."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r} is not one of {ORDERS}")
    if rc.get("max_screen_radius", 0.0):
        raise ValueError("the reference has no max_screen_radius clamp")
    w_img, h_img, ts = rc["width"], rc["height"], rc["tile_size"]
    pos = scene["means"]
    view, fp = cam["view"], cam["full_proj"]
    vx, vy, tz = (_rows(pos, view, i) for i in range(3))
    inv_w = 1.0 / (_rows(pos, fp, 3) + 1e-7)
    ndc_x = _rows(pos, fp, 0) * inv_w
    ndc_y = _rows(pos, fp, 1) * inv_w
    lim = rc["frustum_ndc_limit"]
    in_frustum = ((tz > cam["znear"]) & (torch.abs(ndc_x) < lim)
                  & (torch.abs(ndc_y) < lim))

    # The Jacobian J of the perspective at the (clamped) view point, and
    # T = J W: row 0 = ja W[0] + jb W[2], row 1 = jc W[1] + jd W[2].
    zs = torch.where(in_frustum, tz, torch.ones_like(tz))
    lim_xy = 1.3 * cam["tan_fov"]
    cx = torch.clamp(vx / zs, -lim_xy[0], lim_xy[0]) * zs
    cy = torch.clamp(vy / zs, -lim_xy[1], lim_xy[1]) * zs
    fx, fy = cam["focal"][0], cam["focal"][1]
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    ja, jb = fx * inv_z, -fx * cx * inv_z2
    jc, jd = fy * inv_z, -fy * cy * inv_z2
    w = view[:3, :3]
    t0 = [ja * w[0, k] + jb * w[2, k] for k in range(3)]
    t1 = [jc * w[1, k] + jd * w[2, k] for k in range(3)]
    rot = rotation(scene["quats"])
    s2 = torch.square(torch.exp(scene["log_scales"]) * rc["scale_modifier"])
    if order == "matmul":
        t = torch.stack([torch.stack(t0, -1), torch.stack(t1, -1)], 1)
        with full_fp32():
            sig = (rot * s2[:, None, :]) @ rot.transpose(1, 2)
            cov = t @ sig @ t.transpose(1, 2)
        c00 = cov[:, 0, 0] + rc["lowpass"]
        c01 = cov[:, 0, 1]
        c11 = cov[:, 1, 1] + rc["lowpass"]
    else:
        c00, c01, c11 = _cov2d_unrolled(t0, t1, rot, s2, rc["lowpass"])
    det = c00 * c11 - c01 * c01
    valid = in_frustum & (det > 0.0)
    det = torch.where(valid, det, torch.ones_like(det))
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, rc["eigen_clamp"]))
    inv_det = 1.0 / det
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], 0)
    radius = torch.ceil(rc["radius_sigma"] * torch.sqrt(lam))
    opacity = torch.sigmoid(scene["opacity_logits"])

    # The rect: the radius, cut to the box of the ellipse q <= tau where
    # alpha can reach alpha_min, tau = 2 ln(opacity / alpha_min).
    amin = rc["alpha_min"]
    tau = 2.0 * torch.log(torch.clamp_min(opacity / amin, 1e-12))
    rtau = torch.sqrt(torch.clamp_min(tau, 0.0))
    ext = torch.stack([
        torch.minimum(radius, torch.ceil(rtau * torch.sqrt(c00.clamp_min(0)))),
        torch.minimum(radius, torch.ceil(rtau * torch.sqrt(c11.clamp_min(0)))),
    ], -1)
    seen = opacity > amin
    ext = torch.where(seen[:, None], ext, torch.full_like(ext, -1.0)).detach()
    px = (ndc_x * 0.5 + 0.5) * float(w_img)
    py = (ndc_y * 0.5 + 0.5) * float(h_img)
    pix = torch.stack([px, py], -1).detach()
    ntx, nty = -(-w_img // ts), -(-h_img // ts)
    lo = torch.floor((pix - ext) / float(ts))
    hi = torch.floor((pix + ext) / float(ts)) + 1.0
    rect = torch.stack([
        torch.clamp(lo[:, 0], 0, ntx), torch.clamp(lo[:, 1], 0, nty),
        torch.clamp(hi[:, 0], 0, ntx), torch.clamp(hi[:, 1], 0, nty),
    ], 1).to(torch.int64)
    area = ((rect[:, 2] - rect[:, 0]).clamp_min(0)
            * (rect[:, 3] - rect[:, 1]).clamp_min(0))
    valid = valid & (area > 0)

    dirs = pos - cam["cam_pos"]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
    degree = min(rc["sh_degree"], int(round(scene["sh"].shape[1] ** 0.5)) - 1)
    rgb = sh_rgb(scene["sh"], dirs, degree)
    feats = torch.cat([px[None], py[None], conic, rgb.T, opacity[None]], 0)
    return dict(feats=feats, depth=tz.detach(), rect=rect, valid=valid,
                tau=torch.where(seen, tau, -1.0).detach())


def grid(rc: dict) -> tuple[int, int, int]:
    """(tiles_x, tiles_y, depth_bits) of the configuration's tile grid."""
    ntx = -(-rc["width"] // rc["tile_size"])
    nty = -(-rc["height"] // rc["tile_size"])
    return ntx, nty, 32 - (ntx * nty + 1).bit_length()


def reaches(feats, tau, gid, tx, ty, ts: int) -> torch.Tensor:
    """Whether splat gid reaches alpha_min at some pixel centre of tile
    (tx, ty): the least q = a dx^2 + 2 b dx dy + c dy^2 over the tile's
    centres (0 with the splat's centre inside, else the least of its four
    edges) is at most tau."""
    f = feats.detach()
    gx, gy = f[0][gid], f[1][gid]
    a, b, c = f[2][gid], f[3][gid], f[4][gid]
    x0 = (tx * ts).float() - gx
    x1 = x0 + (ts - 1.0)
    y0 = (ty * ts).float() - gy
    y1 = y0 + (ts - 1.0)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    ba = -b / a.clamp_min(1e-12)
    bc = -b / c.clamp_min(1e-12)
    qmin = torch.minimum(
        torch.minimum(q(x0, torch.clamp(bc * x0, y0, y1)),
                      q(x1, torch.clamp(bc * x1, y0, y1))),
        torch.minimum(q(torch.clamp(ba * y0, x0, x1), y0),
                      q(torch.clamp(ba * y1, x0, x1), y1)))
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    return qmin <= tau[gid]


def tier_plan(rc: dict, n: int) -> list:
    """The tiered route's base tiers [(k_lo, k_hi, rows or None)]: the
    configuration's ladder ((k_hi, divisor), ...), a divisor 0 a tier of
    every splat, else of the first n // divisor of a ranking; legacy
    (K0, div1, div2) = ((K0, 0), (4 K0, div1), (K_max, div2))."""
    kmax, spec = rc["max_tiles_per_gaussian"], rc["tier_spec"]
    if spec and not isinstance(spec[0], (list, tuple)):
        k0, d1, d2 = spec
        spec = [(k0, 0), (4 * k0, d1), (kmax, d2)]
    plan, k_lo = [], 0
    for k_hi, div in list(spec) + [(kmax, spec[-1][1])]:
        k_hi = min(int(k_hi), kmax)
        if k_hi > k_lo:
            plan.append((k_lo, k_hi, None if div == 0 else max(n // div, 1)))
            k_lo = k_hi
    return plan


def _rank(values: torch.Tensor) -> torch.Tensor:
    """Each splat's place in the ranking by `values`, largest first, ties
    in splat order."""
    order = torch.sort(-values.to(torch.int64), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def _emission_order(gid, k, c, area, valid, rc: dict) -> torch.Tensor:
    """Where each candidate comes in the tiered route's emission, which
    orders the splats whose keys tie in a tile: the base tiers, each in
    turn, then the jumbo tiers. A splat whose rect has at most K_max tiles
    is in the base tier of its rank c among its reached tiles; a tier of
    every splat emits them in splat order, a pool in the ranking by reached
    tiles. A larger rect (up to max_tiles_jumbo) is in the jumbo tier of its
    rect index k, in the ranking by rect area."""
    n = area.numel()
    kmax = rc["max_tiles_per_gaussian"]
    plan = tier_plan(rc, n)
    is_jumbo = area > kmax
    reached = torch.bincount(gid, minlength=n)
    pool_rank = _rank(torch.where(is_jumbo, 0, reached))
    tier = torch.zeros_like(c)
    for t, (k_lo, _, _) in enumerate(plan):
        tier = torch.where(c >= k_lo, t, tier)
    dense = torch.tensor([b is None for _, _, b in plan], device=gid.device)
    row = torch.where(dense[tier], gid, pool_rank[gid])
    if rc.get("max_tiles_jumbo"):
        jt = torch.zeros_like(k)
        k_lo = 0
        for j, (k_hi, _) in enumerate(rc["jumbo_tier_spec"]):
            jt = torch.where(k >= k_lo, j, jt)
            k_lo = k_hi
        jumbo = is_jumbo[gid]
        tier = torch.where(jumbo, len(plan) + jt, tier)
        row = torch.where(jumbo, _rank(torch.where(valid, area, 0))[gid], row)
    return tier * n + row


def bin_tiles(proj: dict, rc: dict) -> dict:
    """The depth-ordered list of each tile: `gid` (S,) int64 Gaussian per
    slot in (tile, key) order, `counts` and `starts` (T,) per tile,
    `rect_lanes` (the tiles of every rect, before the cull) and
    `largest_rect` (the tiles of the largest). Splats whose keys tie come
    in the order the configuration's binning emits them: splat order for
    'packed' and 'sort', the tiers' for 'tiered' (`_emission_order`)."""
    ntx, nty, depth_bits = grid(rc)
    ts = rc["tile_size"]
    rect = proj["rect"]
    ids = torch.nonzero(proj["valid"]).flatten()
    w = rect[ids, 2] - rect[ids, 0]
    area = w * (rect[ids, 3] - rect[ids, 1])
    gid = torch.repeat_interleave(ids, area)
    first = torch.repeat_interleave(torch.cumsum(area, 0) - area, area)
    rep_w = torch.repeat_interleave(w, area)
    k = torch.arange(gid.shape[0], device=gid.device) - first
    ty = rect[gid, 1] + torch.div(k, rep_w, rounding_mode="floor")
    tx = rect[gid, 0] + k % rep_w
    del rep_w
    keep = reaches(proj["feats"], proj["tau"], gid, tx, ty, ts)
    tile = ty * ntx + tx
    del tx, ty
    bits = proj["depth"].float().contiguous().view(torch.int32).to(torch.int64)
    dq = (bits & 0xFFFFFFFF) >> (31 - depth_bits)
    key = (tile << depth_bits) | dq[gid]
    if rc["binning"] == "tiered":
        # Each kept candidate's rank among its splat's kept tiles.
        kc = torch.cumsum(keep, 0)
        c = kc - kc[first] + keep[first].to(kc.dtype) - 1
        area_all = torch.zeros_like(proj["valid"], dtype=torch.int64)
        area_all[ids] = area
        emit = _emission_order(gid[keep], k[keep], c[keep], area_all,
                               proj["valid"], rc)
        order = torch.sort(emit, stable=True).indices
    else:
        order = torch.arange(int(keep.sum()), device=gid.device)
    gid, tile, key = gid[keep][order], tile[keep][order], key[keep][order]
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(tile, minlength=ntx * nty)
    return dict(gid=gid[order], counts=counts,
                starts=torch.cumsum(counts, 0) - counts,
                rect_lanes=int(area.sum()),
                largest_rect=int(area.max()) if area.numel() else 0)


def stream_values(feats: torch.Tensor, rc: dict) -> torch.Tensor:
    """The (9, N) values the configuration's stream carries."""
    fmt = rc["stream_format"]
    if fmt == "f32":
        return feats
    lim = rc["frustum_ndc_limit"]
    out = []
    for row, size in ((feats[0], rc["width"]), (feats[1], rc["height"])):
        lo = (1.0 - lim) / 2.0 * size
        s = 65535.0 / (lim * size)
        q = torch.clamp(torch.round((row - lo) * s), 0.0, 65535.0)
        out.append(q * (1.0 / s) + lo)
    bf = [feats[i].to(torch.bfloat16).float() for i in range(2, 9)]
    if fmt == "packed16":
        return torch.stack(out + bf, 0)
    if fmt != "packed4":
        raise ValueError(f"unknown stream_format {fmt!r}")
    top = (2047.0, 2047.0, 1023.0)
    rgb = [torch.clamp(torch.round(feats[5 + i] * (t / 4.0)), 0.0, t)
           * (4.0 / t) for i, t in enumerate(top)]
    return torch.stack(out + bf[:3] + rgb + bf[6:], 0)


def straight_through(feats: torch.Tensor, rc: dict) -> torch.Tensor:
    """The stream's values forward, the identity backward."""
    d = feats.detach()
    return feats + (stream_values(d, rc) - d)


def tile_blocks(binned: dict, rc: dict):
    """Blocks of tiles, heaviest first: (tiles (B,), slots (B, L) int64
    with -1 past each tile's list), at most LANES (pixel, slot) lanes."""
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
        slots = torch.where(ar < counts[tiles, None], slots, -1)
        yield tiles, slots
        i += b


def blend(f: torch.Tensor, in_range: torch.Tensor, tiles: torch.Tensor,
          rc: dict, dtype=torch.float32, tally: dict | None = None
          ) -> torch.Tensor:
    """Blend a block of tiles: f (9, B, L) float32 features in list order
    (zero past each list), in_range (B, L). Returns (B, P, 3) colours. The
    offsets from each tile's corner are taken in float32, the rest in
    `dtype`. `tally`, when given, gets the pairs each pixel walked (up to
    and with the Gaussian that finishes it) and the pairs applied."""
    ts = rc["tile_size"]
    ntx = grid(rc)[0]
    dev = f.device
    nb, length = in_range.shape
    p = torch.arange(ts * ts, device=dev)
    lx = (p % ts).float()[None, :, None]
    ly = (p // ts).float()[None, :, None]
    ox = ((tiles % ntx) * ts).float()[:, None]
    oy = (torch.div(tiles, ntx, rounding_mode="floor") * ts).float()[:, None]
    trans = torch.ones((nb, ts * ts), device=dev, dtype=dtype)
    done = torch.zeros((nb, ts * ts), device=dev, dtype=torch.bool)
    color = torch.zeros((nb, ts * ts, 3), device=dev, dtype=dtype)
    amin, aclamp, tmin = rc["alpha_min"], rc["alpha_clamp"], \
        rc["transmittance_min"]
    for c0 in range(0, length, CHUNK):
        g = f[:, :, c0:c0 + CHUNK]
        rng = in_range[:, None, c0:c0 + CHUNK]
        dx = (lx - (g[0] - ox)[:, None, :]).to(dtype)
        dy = (ly - (g[1] - oy)[:, None, :]).to(dtype)
        a, b, c, op = (g[i].to(dtype)[:, None, :] for i in (2, 3, 4, 8))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(op * torch.exp(torch.clamp_max(power, 0.0)),
                                aclamp)
        ok = (power <= 0) & (alpha >= amin) & rng & ~done[:, :, None]
        a_ = torch.where(ok, alpha, torch.zeros_like(alpha))
        incl = trans[:, :, None] * torch.cumprod(1.0 - a_, -1)
        valid = (incl >= tmin).detach()
        before = torch.cat([trans[:, :, None], incl[:, :, :-1]], -1)
        w = torch.where(valid, a_ * before, torch.zeros_like(a_))
        with full_fp32():
            color = color + torch.einsum(
                "bpg,bgc->bpc", w, g[5:8].to(dtype).permute(1, 2, 0))
        trigger = (a_ > 0) & ~valid
        if tally is not None:
            t = trigger.to(torch.int32)
            walked = rng & ~done[:, :, None] & (torch.cumsum(t, -1) - t == 0)
            tally["walked"] += int(walked.sum())
            tally["applied"] += int((valid & (a_ > 0)).sum())
        inf = torch.full_like(incl, float("inf"))
        trans = torch.minimum(trans, torch.where(valid, incl, inf).amin(-1))
        done = done | trigger.any(-1)
        if bool(done.all()):
            break
    return color


def _block_features(values: torch.Tensor, binned: dict, slots: torch.Tensor):
    """(9, B, L) features of a block's slots (zero past each list) and the
    in-range mask."""
    in_range = slots >= 0
    gid = binned["gid"][slots.clamp_min(0)]
    f = values[:, gid] * in_range
    return f, in_range


def image_of(values: torch.Tensor, binned: dict, rc: dict,
             dtype=torch.float32, tally: dict | None = None) -> torch.Tensor:
    """The (H, W, 3) image the binned lists blend to from the (9, N) stream
    values (black background), block by block."""
    ts = rc["tile_size"]
    ntx, nty, _ = grid(rc)
    rgb = torch.zeros((ntx * nty, ts * ts, 3), device=values.device)
    with torch.no_grad():
        for tiles, slots in tile_blocks(binned, rc):
            f, in_range = _block_features(values, binned, slots)
            rgb[tiles] = blend(f, in_range, tiles, rc, dtype, tally).float()
    img = rgb.reshape(nty, ntx, ts, ts, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * ts, ntx * ts, 3)[:rc["height"], :rc["width"]]


def _image_to_tiles(image: torch.Tensor, rc: dict) -> torch.Tensor:
    ts = rc["tile_size"]
    ntx, nty, _ = grid(rc)
    pad = image.new_zeros((nty * ts, ntx * ts, 3))
    pad[:rc["height"], :rc["width"]] = image
    return pad.reshape(nty, ts, ntx, ts, 3).permute(0, 2, 1, 3, 4).reshape(
        nty * ntx, ts * ts, 3)


def render(scene: dict, cam: dict, rc: dict, dtype=torch.float32,
           tally: dict | None = None, order: str = "unrolled") -> dict:
    """The (H, W, 3) image of the scene from `cam` (black background),
    with the projection (in `order`) and the binned lists it was made
    from. `tally` (a dict) gets "walked", "applied" and "slots"."""
    with torch.no_grad():
        proj = project(scene, cam, rc, order)
        binned = bin_tiles(proj, rc)
    if tally is not None:
        tally.update(walked=0, applied=0, slots=int(binned["gid"].numel()),
                     rect_lanes=binned["rect_lanes"],
                     largest_rect=binned["largest_rect"])
    image = image_of(stream_values(proj["feats"], rc), binned, rc, dtype,
                     tally)
    return dict(image=image, proj=proj, binned=binned)


def render_vjp(values: torch.Tensor, binned: dict, g_image: torch.Tensor,
               rc: dict, dtype=torch.float32, slot_dtype=None) -> torch.Tensor:
    """d loss / d the (9, N) stream values, given d loss / d image: each
    block's blend re-run with its slots' features as the leaf, each slot's
    gradient rounded to `slot_dtype` (the configuration's slot gradient
    precision, None for float32) and summed per Gaussian in float32."""
    g_tiles = _image_to_tiles(g_image, rc)
    dvals = torch.zeros_like(values)
    for tiles, slots in tile_blocks(binned, rc):
        with torch.no_grad():
            f, in_range = _block_features(values, binned, slots)
        f.requires_grad_(True)
        with torch.enable_grad():
            rgb = blend(f, in_range, tiles, rc, dtype)
            (df,) = torch.autograd.grad(rgb, f, g_tiles[tiles].to(rgb.dtype))
        df = df.float()
        if slot_dtype is not None:
            df = df.to(slot_dtype).float()
        gid = binned["gid"][slots.clamp_min(0)]
        keep = in_range.flatten()
        dvals.index_add_(1, gid.flatten()[keep], df.reshape(9, -1)[:, keep])
    return dvals
