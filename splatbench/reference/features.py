"""The reference of Feature 3DGS (Zhou et al. 2024, "Feature 3DGS:
Supercharging 3D Gaussian Splatting to Enable Distilled Feature Fields",
arXiv:2312.03203) with its speed-up module, in plain PyTorch and float32
(TF32 off), on top of `reference/render.py`'s projection, binning and
stream and `reference/train.py`'s L1 + DSSIM and Adam.

- Each Gaussian carries a view-independent feature f_i (C channels). A
  pixel's feature is blended front to back with the colour's own weights,
  F(p) = sum_i f_i alpha_i(p) T_i(p): the same pairs skipped, applied and
  stopping the pixel as the colour's (`blend`). The features are read as
  float32 (the stream's quantisation is the colour's and the geometry's
  alone).
- The rendered map (H, W, C) is resized to the teacher's size (h, w)
  bilinearly, corners aligned, and decoded by a 1x1 convolution, a (D, C)
  matrix and a (D,) bias, to the teacher's D channels (`decode`).
- The loss is L1 + DSSIM on the image plus gamma times the mean absolute
  difference between the decoded map and the teacher (read as float32).
- Adam trains the scene's five fields at their rates, the features and the
  decoder at rates of their own.

Departures from the paper: the scene and the teachers are synthetic (no
LSeg teacher runs here); the scene is rendered at the configuration's own
resolution, not the paper's datasets'; the resize's kind (bilinear,
corners aligned) is the configuration's assumption, as the published code
is recalled; everything else (tiles, culling, the stream's quantisation,
the blend's cut-offs) is the 3D Gaussian splatting of `reference/render.py`
that the program implements, not the original CUDA rasterizer's.

Everything runs in blocks of tiles (`render.tile_blocks`) so that a 1080p
frame of 128 channels fits. `tally` adds to render's counts the channels
(`channels`), so that the rooflines count the feature work from the
reference's own pass.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from splatbench.frozen import SCENE_FIELDS
from splatbench.reference import render as R
from splatbench.reference import train as T

# The fields Feature 3DGS adds to a scene, in order.
FEATURE_FIELDS = ("features", "decoder_weight", "decoder_bias")
FIELDS = SCENE_FIELDS + FEATURE_FIELDS


@contextlib.contextmanager
def matmuls(tf32: bool):
    """float32 matmuls and convolutions, TF32 on only where `tf32` (a
    fault: the decoder computed below the precision the configuration
    states)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def blend(f: torch.Tensor, fe: torch.Tensor, in_range: torch.Tensor,
          tiles: torch.Tensor, rc: dict, dtype=torch.float32,
          tally: dict | None = None) -> torch.Tensor:
    """`render.blend` over 3 + C channels: f (9, B, L) float32 stream
    features and fe (C, B, L) float32 feature rows in list order (zero past
    each list), in_range (B, L). Returns (B, P, 3 + C): the colour, then
    the features."""
    ts = rc["tile_size"]
    ntx = R.grid(rc)[0]
    dev = f.device
    nb, length = in_range.shape
    p = torch.arange(ts * ts, device=dev)
    lx = (p % ts).float()[None, :, None]
    ly = (p // ts).float()[None, :, None]
    ox = ((tiles % ntx) * ts).float()[:, None]
    oy = (torch.div(tiles, ntx, rounding_mode="floor") * ts).float()[:, None]
    values = torch.cat([f[5:8], fe], 0)  # (3 + C, B, L)
    trans = torch.ones((nb, ts * ts), device=dev, dtype=dtype)
    done = torch.zeros((nb, ts * ts), device=dev, dtype=torch.bool)
    out = torch.zeros((nb, ts * ts, values.shape[0]), device=dev, dtype=dtype)
    amin, aclamp, tmin = rc["alpha_min"], rc["alpha_clamp"], \
        rc["transmittance_min"]
    for c0 in range(0, length, R.CHUNK):
        g = f[:, :, c0:c0 + R.CHUNK]
        rng = in_range[:, None, c0:c0 + R.CHUNK]
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
        v = values[:, :, c0:c0 + R.CHUNK].to(dtype).permute(1, 2, 0)
        with R.full_fp32():
            out = out + torch.einsum("bpg,bgc->bpc", w, v)
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
    return out


def _block_rows(table: torch.Tensor, binned: dict, slots: torch.Tensor):
    """(C, B, L) feature rows of a block's slots, zero past each list."""
    in_range = slots >= 0
    gid = binned["gid"][slots.clamp_min(0)]
    return (table[gid] * in_range[..., None]).permute(2, 0, 1)


def _to_image(tiles: torch.Tensor, rc: dict) -> torch.Tensor:
    """(T, P, K) per-tile pixels -> (H, W, K)."""
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


def maps_of(values: torch.Tensor, table: torch.Tensor, binned: dict,
            rc: dict, dtype=torch.float32, tally: dict | None = None):
    """(image (H, W, 3), feature map (H, W, C)) the binned lists blend to
    from the (9, N) stream values and the (N, C) feature table, block by
    block."""
    ts = rc["tile_size"]
    ntx, nty, _ = R.grid(rc)
    out = torch.zeros((ntx * nty, ts * ts, 3 + table.shape[1]),
                      device=values.device)
    with torch.no_grad():
        for tiles, slots in R.tile_blocks(binned, rc):
            f, in_range = R._block_features(values, binned, slots)
            fe = _block_rows(table, binned, slots)
            out[tiles] = blend(f, fe, in_range, tiles, rc, dtype,
                               tally).float()
    img = _to_image(out, rc)
    return img[..., :3], img[..., 3:]


def render(scene: dict, cam: dict, rc: dict, dtype=torch.float32,
           tally: dict | None = None, rows_dtype=None) -> dict:
    """The image and the feature map of the scene (its five fields and
    `features`) from `cam`. `rows_dtype`: the feature rows rounded to it
    first (a fault). `tally` gets render's counts and "channels"."""
    with torch.no_grad():
        proj = R.project(scene, cam, rc)
        binned = R.bin_tiles(proj, rc)
    table = scene["features"].float()
    if rows_dtype is not None:
        table = table.to(rows_dtype).float()
    if tally is not None:
        tally.update(walked=0, applied=0, slots=int(binned["gid"].numel()),
                     rect_lanes=binned["rect_lanes"],
                     largest_rect=binned["largest_rect"],
                     channels=table.shape[1])
    image, fmap = maps_of(R.stream_values(proj["feats"], rc), table, binned,
                          rc, dtype, tally)
    return dict(image=image, features=fmap, proj=proj, binned=binned)


def render_vjp(values: torch.Tensor, table: torch.Tensor, binned: dict,
               g_image: torch.Tensor, g_fmap: torch.Tensor, rc: dict,
               dtype=torch.float32, slot_dtype=None):
    """(d loss / d the (9, N) stream values, d loss / d the (N, C) table),
    given d loss / d image and d loss / d the feature map: each block's
    blend re-run with its slots' stream features and feature rows as the
    leaves; each slot's stream gradient rounded to `slot_dtype` (None:
    float32) and summed per Gaussian in float32, as `render.render_vjp`;
    the feature rows' gradients summed per Gaussian in float32."""
    g_tiles = _to_tiles(torch.cat([g_image, g_fmap], -1), rc)
    dvals = torch.zeros_like(values)
    dtable = torch.zeros_like(table)
    c = table.shape[1]
    for tiles, slots in R.tile_blocks(binned, rc):
        with torch.no_grad():
            f, in_range = R._block_features(values, binned, slots)
            fe = _block_rows(table, binned, slots)
        f.requires_grad_(True)
        fe.requires_grad_(True)
        with torch.enable_grad():
            out = blend(f, fe, in_range, tiles, rc, dtype)
            df, dfe = torch.autograd.grad(out, (f, fe),
                                          g_tiles[tiles].to(out.dtype))
        df, dfe = df.float(), dfe.float()
        if slot_dtype is not None:
            df = df.to(slot_dtype).float()
        gid = binned["gid"][slots.clamp_min(0)].flatten()
        keep = in_range.flatten()
        dvals.index_add_(1, gid[keep], df.reshape(9, -1)[:, keep])
        dtable.index_add_(0, gid[keep], dfe.reshape(c, -1)[:, keep].T)
    return dvals, dtable


def decode(fmap: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           size) -> torch.Tensor:
    """The (D, h, w) decoding of an (H, W, C) feature map: resized
    bilinearly to `size` (corners aligned), then the 1x1 convolution."""
    x = F.interpolate(fmap.permute(2, 0, 1)[None], size=tuple(size),
                      mode="bilinear", align_corners=True)[0]
    return torch.einsum("dc,chw->dhw", weight, x) + bias[:, None, None]


def feature_loss(fmap, teacher, weight, bias) -> torch.Tensor:
    """mean |decode(fmap) - teacher|, the teacher read as float32."""
    return (decode(fmap, weight, bias, teacher.shape[-2:])
            - teacher.float()).abs().mean()


def loss_and_grads(params: dict, cam: dict, target: torch.Tensor,
                   teacher: torch.Tensor, rc: dict, tc: dict, fc: dict,
                   dtype=torch.float32, rows: int | None = None,
                   rows_dtype=None, tf32: bool = False
                   ) -> tuple[float, dict]:
    """The step's loss and d loss / d each field (FIELDS). `rows`: the
    image loss over its first rows alone (a fault); `rows_dtype`: the
    feature rows rounded to it in the blend (a fault); `tf32`: the decoder
    and its gradients in TF32 (a fault)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in FIELDS}
    geo = {k: leaves[k] for k in SCENE_FIELDS}
    with torch.enable_grad(), R.full_fp32():
        proj = R.project(geo, cam, rc)
        values = R.straight_through(proj["feats"], rc)
        binned = R.bin_tiles(proj, rc)
        vals = values.detach()
        table = leaves["features"].detach()
        if rows_dtype is not None:
            table = table.to(rows_dtype).float()
        image, fmap = maps_of(vals, table, binned, rc, dtype)
        image.requires_grad_(True)
        fmap.requires_grad_(True)
        with matmuls(tf32):
            loss = (T.loss_fn(image[:rows], target[:rows], tc["ssim_weight"])
                    + fc["gamma"] * feature_loss(
                        fmap, teacher, leaves["decoder_weight"],
                        leaves["decoder_bias"]))
            g_image, g_fmap, g_w, g_b = torch.autograd.grad(
                loss, (image, fmap, leaves["decoder_weight"],
                       leaves["decoder_bias"]))
        bf16_slots = rc.get("gather_backward") == "bf16"
        dvals, dtable = render_vjp(vals, table, binned, g_image, g_fmap, rc,
                                   dtype,
                                   torch.bfloat16 if bf16_slots else None)
        if rc.get("grad_readout") == "bf16":
            dvals = dvals.to(torch.bfloat16).float()
        grads = torch.autograd.grad(values, list(geo.values()), dvals,
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(geo[k]) if g is None else g)
             for k, g in zip(geo, grads)}
    grads.update(features=dtable, decoder_weight=g_w, decoder_bias=g_b)
    return float(loss.detach()), grads


def rates(tc: dict, fc: dict) -> dict:
    """Adam's rate per field: the scene's at lr times its scale, the
    features' and the decoder's their own."""
    r = {k: tc["lr"] * tc["lr_scales"][k] for k in SCENE_FIELDS}
    r.update(features=fc["lr"], decoder_weight=fc["decoder_lr"],
             decoder_bias=fc["decoder_lr"])
    return r


def run(scene: dict, cams: list, targets: torch.Tensor,
        teachers: torch.Tensor, rc: dict, tc: dict, fc: dict,
        dtype=torch.float32, rows: int | None = None, rows_dtype=None,
        tf32: bool = False) -> dict:
    """len(cams) steps from `scene` (FIELDS), one view a step, as
    `train.run`: each step's loss, the first step's gradient norm per field
    and the norm of each field's change over all the steps, and the first
    step's gradient of the decoder's weight (`decoder_grad`)."""
    params = {k: scene[k].detach().clone() for k in FIELDS}
    start = {k: v.clone() for k, v in params.items()}
    opt = T.Adam(params, rates(tc, fc), tuple(tc["betas"]), tc["eps"])
    losses, grad1 = [], None
    for cam, target, teacher in zip(cams, targets, teachers):
        loss, grads = loss_and_grads(opt.params, cam, target, teacher, rc, tc,
                                     fc, dtype, rows, rows_dtype, tf32)
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
            decoder_grad = grads["decoder_weight"].clone()
        opt.step(grads)
    change = {k: float(torch.linalg.vector_norm(opt.params[k] - start[k]))
              for k in params}
    return dict(losses=losses, grad_norms=grad1, change_norms=change,
                decoder_grad=decoder_grad)
