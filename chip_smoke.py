#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gsplat_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of `gsplat_tpu_torch/csrc/` (nvcc, sm_90a);
  3. K3 cull at the bench shape (1M Gaussians, 1920x1080, tile 32, K 64):
     the kernel's mask against the plain PyTorch version on the card,
     0 differing lanes allowed; both timed with CUDA events;
  4. K1 blend at the bench shape on the port's own binned stream: kernel
     against the plain tiled walk on the card, PSNR >= 60 dB and >= 99.99%
     of pixels within 1e-4 on image and transmittance (the serial product
     and the log-domain cumsum round differently at the 1e-4 termination
     threshold); both timed;
  5. K2 blend backward on the same stream, with N(0, 1) upstream gradients
     of image and transmittance: kernel (fed K1's outputs) against the plain
     re-walk (fed the plain forward's), each feature row within 1e-3
     relative L2 and >= 99.9% of the walked slots within rtol 2e-3 / atol
     2e-4 (the JAX per-slot tolerance); the slots past the stream exactly 0;
  6. K4 segmented suffix sum on K2's gradient stream sorted gid-major:
     kernel against the plain doubling, |error| <= 1e-6 + 1e-5 times the
     summed span's absolute sum (only the f32 addition order differs);
  7. golden: the JAX reference scene (tests/golden/scene_42_300.npz) through
     K3 and K1, above 55 dB against tests/golden/render_64.npz;
  8. main path, a server answering requests: `render` of the 1M-Gaussian
     SH-3 scene at 1920x1080 (the bench config of bench.py, f32 stream) for
     four views, with the launch counts set to 0 just before and read just
     after; every frame has no overflow, intersections, a finite non-black
     image, and K3 and K1 launched;
  9. main path, a trainer taking steps: the exact-gradient training step
     (L1 + 0.2 DSSIM, Adam at lr 1e-2) from a copy of that scene whose SH DC
     carries seeded noise, against renders of the scene itself at the four
     views, one view per step; a round of warm-up steps, then three measured
     rounds with the launch counts set to 0 just before and read just after;
     every step has no overflow, finite gradients and a finite loss, the
     last round's mean loss is below the first's, and all four kernels ran.
 10. golden gradients: `render_loss_and_grad` of the golden scene on the
     card (K3, K1, K2, K4) against the port's plain path on the CPU, which
     the CPU tests hold to JAX: every field within rtol 5e-3 / atol 1e-5;
Then one JSON line of kernel numbers, each kernel with its launches on each
main path (`launches` from the training path, `serve_launches` from the
serving path), and as the last line {"ok": true, "device": {...}}. Needs one CUDA card; exits
non-zero without.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# FLOP/s outside the tensor cores. A bound is the larger of bytes over the
# first and operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K3: FP32 operations the cull does, as csrc/cull.cu's note counts them:
# per (row, k) lane, k div/mod w 5, tile origin 2, pixel-rect offsets 8,
# inside test 4, four edges of 11, min and tests 7; per row, -b/a, -b/c and
# 2b: 5 (the kernel repeats them in every lane of the row; the function needs
# them once).
CULL_OPS_PER_LANE = 70
CULL_OPS_PER_ROW = 5
# K1: FP32 operations per (pixel, Gaussian) pair a pixel walks: 12 for the
# offset, the quadratic and its test on every walked pair, about 15 more
# (one exp) for the pairs that pass it -- about 20 on average.
BLEND_OPS_PER_PAIR = 20
# K2, as csrc/raster_bwd.cu counts them: 20 for every pair a pixel walks
# (blend.cuh's eval_pair); 33 more for every pair it applies (w, dL/dw, the
# prefix and da: 13; the 9 gradient terms: 11; their 9 adds into the pixel
# sums); 7 per slot to chain the sums into the 9 feature gradients.
BLEND_BWD_OPS_PER_WALKED = 20
BLEND_BWD_OPS_PER_APPLIED = 33
BLEND_BWD_OPS_PER_SLOT = 7
# K4: one add per element (a reverse scan within each run).
SEGSUM_OPS_PER_ELEMENT = 1

BENCH = dict(
    width=1920, height=1080, tile_size=32, max_intersections=4_100_000,
    block_size=32, max_per_tile=8192, binning="tiered",
    tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)),
    pallas_block_size=128, stream_format="f32",
)
GOLDEN = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=512)
NUM_GAUSSIANS = 1_000_000
# The training step's exact-f32 setting (bench.py --exact-grads).
EXACT = dict(gather_backward="variadic", grad_readout="f32",
             segment_sum="pallas", matmul_precision="highest")
TRAIN_LR = 1e-2
SSIM_WEIGHT = 0.2
DC_NOISE = 0.2       # std of the seeded noise on the trained scene's SH DC
TRAIN_ROUNDS = 4     # rounds of the four views: one warm-up, three measured


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean milliseconds per call of fn over `iters` calls, timed with CUDA
    events, after one warm-up call unless fn has just run."""
    import torch

    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def psnr(img, ref) -> float:
    mse = float(((img - ref) ** 2).mean())
    peak = max(float(ref.max()), 1.0)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def views(width: int, height: int, device):
    """The default camera and three look_at views near it: shifted 0.1
    right, down, and both, and turned a little the same way. They keep
    the default's up direction and the frame load within the bench's
    capacity (a view of the whole scene needs about 6.3M intersections)."""
    from gsplat_tpu_torch.ops.camera import Camera, look_at

    cams = [Camera.default(width, height, device=device)]
    rows = cams[0].view.cpu().numpy().astype(np.float64)
    right, down, fwd = rows[0, :3], rows[1, :3], rows[2, :3]
    eye = cams[0].cam_pos.cpu().numpy().astype(np.float64)
    for d in (right, down, right + down):
        e = eye + 0.1 * d
        view = look_at(e, e + fwd + 0.05 * d, up=-down)
        cams.append(Camera.create(view, width, height, fx=float(width),
                                  fy=float(height), znear=0.2, zfar=10.0,
                                  device=device))
    return cams


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card needs for the work, in ms, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def make_trainer(scene, cams, cfg, dev):
    """The training main path: targets rendered from `scene` at `cams`, a
    trained copy of `scene` whose SH DC carries seeded noise, and its train
    step. Returns (trained scene, targets (V, H, W, 3), step)."""
    import dataclasses

    import torch

    from gsplat_tpu_torch import GaussianScene, render
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step

    with torch.no_grad():
        targets = torch.stack([render(scene, cam, cfg).image for cam in cams])
    train = GaussianScene(**{f.name: getattr(scene, f.name).detach().clone()
                             for f in dataclasses.fields(scene)})
    gen = torch.Generator(device=dev).manual_seed(2)
    train.sh[:, 0, :] += DC_NOISE * torch.randn(
        train.sh[:, 0, :].shape, generator=gen, device=dev)
    opt = make_optimizer(train, TRAIN_LR)
    return train, targets, make_train_step(cfg, opt, ssim_weight=SSIM_WEIGHT)


def main() -> int:
    # Drive one card, so that the device count reported is the one used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    """Every phase on `dev`, the card."""
    import torch

    sys.path.insert(0, HERE)
    from gsplat_tpu_torch import Camera, RenderConfig, random_scene, render
    from gsplat_tpu_torch.convert import scene_from_numpy
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.cuda import _build, cull, raster, segsum
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import (
        _image_to_tiles,
        _raster_tiles,
        _raster_tiles_bwd_walk,
        _tiles_to_image,
        _tiles_to_scalar_image,
    )
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS, render_loss_and_grad

    # The plain versions contract in full float32 (no TF32 anywhere).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. Device.
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch: {kind}, capability "
        f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.3f} s wall, sources "
        f"{sorted(p.name for p in _build.CSRC.glob('*.cu'))}")

    cfg = RenderConfig(**BENCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    scene = random_scene(NUM_GAUSSIANS, sh_degree=3, generator=gen,
                         device=dev)
    cams = views(cfg.width, cfg.height, dev)
    kernels = {}

    # 3. K3 cull at the bench shape.
    with torch.no_grad():
        proj = project_gaussians(scene, cams[0], cfg)
        params = cull.cull_params(proj, cfg)
    kmax = cfg.max_tiles_per_gaussian
    mask_k = cull.cull_mask_from_params(params, kmax, cfg.tile_size)
    mask_p = cull.cull_mask_plain(params, kmax, cfg.tile_size)
    torch.cuda.synchronize()
    differ = int((mask_k != mask_p).sum())
    lanes = params.shape[1] * kmax
    log(f"[K3] {params.shape[1]} rows x K {kmax}: {int(mask_k.sum())} lanes "
        f"kept, {differ} lanes differ from the plain version")
    if differ:
        raise SystemExit("K3: kernel mask differs from the plain version")
    ms_k = cuda_ms(lambda: cull.cull_mask_from_params(params, kmax, cfg.tile_size), 50)
    ms_p = cuda_ms(lambda: cull.cull_mask_plain(params, kmax, cfg.tile_size), 5)
    cull_bytes = params.numel() * 4 + lanes
    cull_ops = lanes * CULL_OPS_PER_LANE + params.shape[1] * CULL_OPS_PER_ROW
    bound_ms, bound_by = bound(cull_bytes, cull_ops)
    kernels["cull"] = dict(
        name="cull", route="cuda", source="gsplat_tpu_torch/csrc/cull.cu",
        replaces="gsplat_tpu/ops/pallas/cull.py:31", launches=None,
        max_abs_err=float((mask_k.float() - mask_p.float()).abs().max()),
        ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
    )
    log(f"[K3] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms} ms "
        f"({cull_bytes} B, {cull_ops} ops, {bound_by})")
    del mask_k, mask_p

    # 4. K1 blend at the bench shape, on the port's own binned stream.
    with torch.no_grad():
        binned = binning.bin_gaussians(proj, cfg)
        features = binning.gather_features(proj, binned, cfg)
    ranges = binned.ranges
    col_k, tr_k = raster.raster_tiles_cuda(features, ranges, cfg)
    col_p, tr_p, pairs = _raster_tiles(features, ranges, 0, cfg)
    torch.cuda.synchronize()
    img_k, img_p = _tiles_to_image(col_k, cfg), _tiles_to_image(col_p, cfg)
    t_k, t_p = _tiles_to_scalar_image(tr_k, cfg), _tiles_to_scalar_image(tr_p, cfg)
    err_img = (img_k - img_p).abs()
    err_t = (t_k - t_p).abs()
    p_db = psnr(img_k, img_p)
    within_img = float((err_img.amax(-1) <= 1e-4).float().mean())
    within_t = float((err_t <= 1e-4).float().mean())
    total = int(binned.num_intersections)
    log(f"[K1] {total} intersections, {int(pairs)} pixel-Gaussian pairs "
        f"walked; PSNR {p_db} dB, max abs err image {float(err_img.max())} "
        f"trans {float(err_t.max())}, within 1e-4: image {within_img} "
        f"trans {within_t}")
    if not (p_db >= 60.0 and within_img >= 0.9999 and within_t >= 0.9999):
        raise SystemExit("K1: kernel outside the stated tolerance of the "
                         "plain version")
    ms_k = cuda_ms(lambda: raster.raster_tiles_cuda(features, ranges, cfg), 20)
    # The plain walk takes seconds at this shape and has just run above.
    ms_p = cuda_ms(lambda: _raster_tiles(features, ranges, 0, cfg), 1,
                   warmup=False)
    blend_bytes = (total * features.shape[0] * 4 + ranges.numel() * 4
                   + (col_k.numel() + tr_k.numel()) * 4)
    blend_ops = int(pairs) * BLEND_OPS_PER_PAIR
    bound_ms, bound_by = bound(blend_bytes, blend_ops)
    kernels["raster_fwd"] = dict(
        name="raster_fwd", route="cuda",
        source="gsplat_tpu_torch/csrc/raster_fwd.cu",
        replaces="gsplat_tpu/ops/pallas/raster.py:143", launches=None,
        max_abs_err=max(float(err_img.max()), float(err_t.max())),
        ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
    )
    log(f"[K1] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms} ms "
        f"({blend_bytes} B, {blend_ops} ops, {bound_by})")
    del img_p, t_p, err_img, err_t

    # 5. K2 blend backward on the same stream.
    gen = torch.Generator(device=dev).manual_seed(1)
    g_image = torch.randn((cfg.height, cfg.width, 3), generator=gen, device=dev)
    g_trans = torch.randn((cfg.height, cfg.width), generator=gen, device=dev)
    g_col = _image_to_tiles(g_image, cfg)
    g_tt = _image_to_tiles(g_trans[..., None], cfg)[:, 0]
    b_k = ((g_col * col_k).sum(1) + g_tt * tr_k).contiguous()
    b_p = (g_col * col_p).sum(1) + g_tt * tr_p
    d_k = raster.raster_bwd_cuda(features, ranges, g_col, b_k, cfg)
    d_p, applied = _raster_tiles_bwd_walk(features, ranges, 0, g_col,
                                          b_p[..., None], cfg)
    torch.cuda.synchronize()
    walked_k, walked_p = d_k[:, :total], d_p[:, :total]
    rel = ((walked_k - walked_p).norm(dim=1)
           / walked_p.norm(dim=1).clamp_min(1e-30)).tolist()
    err = (walked_k - walked_p).abs()
    within = float((err <= 2e-4 + 2e-3 * walked_p.abs()).float().mean())
    tail_zero = bool((d_k[:, total:] == 0).all())
    log(f"[K2] {int(applied)} pixel-Gaussian pairs applied; relative L2 "
        f"error per feature row {rel}, within rtol 2e-3 / atol 2e-4: "
        f"{within}, max abs err {float(err.max())}, slots past the stream "
        f"exactly 0: {tail_zero}")
    if not (max(rel) <= 1e-3 and within >= 0.999 and tail_zero):
        raise SystemExit("K2: kernel outside the stated tolerance of the "
                         "plain version")
    ms_k = cuda_ms(lambda: raster.raster_bwd_cuda(features, ranges, g_col,
                                                  b_k, cfg), 20)
    # The plain re-walk takes seconds at this shape and has just run above.
    ms_p = cuda_ms(lambda: _raster_tiles_bwd_walk(features, ranges, 0, g_col,
                                                  b_p[..., None], cfg), 1,
                   warmup=False)
    rbwd_bytes = (total * features.shape[0] * 4 + features.numel() * 4
                  + (g_col.numel() + b_k.numel() + ranges.numel()) * 4)
    rbwd_ops = (int(pairs) * BLEND_BWD_OPS_PER_WALKED
                + int(applied) * BLEND_BWD_OPS_PER_APPLIED
                + total * BLEND_BWD_OPS_PER_SLOT)
    bound_ms, bound_by = bound(rbwd_bytes, rbwd_ops)
    kernels["raster_bwd"] = dict(
        name="raster_bwd", route="cuda",
        source="gsplat_tpu_torch/csrc/raster_bwd.cu",
        replaces="gsplat_tpu/ops/pallas/raster.py:214", launches=None,
        max_abs_err=float(err.max()), ms=ms_k, plain_ms=ms_p,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    log(f"[K2] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms} ms "
        f"({rbwd_bytes} B, {rbwd_ops} ops, {bound_by})")
    del d_p, col_p, tr_p, err, walked_p

    # 6. K4 on K2's gradient stream, sorted gid-major as the gather
    # backward sorts it.
    key = torch.where(binned.sorted_gidk >= 0, binned.sorted_gidk, 2**31 - 1)
    s_key, perm = torch.sort(key)
    x = d_k.index_select(1, perm).contiguous()
    rows = (s_key >> binning._kbits(binning.kmax_eff(cfg))).to(torch.int32)
    kmax_s = binning.kmax_eff(cfg)
    sum_k = segsum.segmented_suffix_sum_cuda(x, rows, kmax_s)
    sum_p = segsum.segmented_suffix_sum_plain(x, rows, kmax_s)
    scale = segsum.segmented_suffix_sum_plain(x.abs(), rows, kmax_s)
    torch.cuda.synchronize()
    err = (sum_k - sum_p).abs()
    seg_ok = bool((err <= 1e-6 + 1e-5 * scale).all())
    plain_tol = float((err <= 1e-6 + 1e-5 * sum_p.abs()).float().mean())
    log(f"[K4] {x.shape[1]} slots, max abs err {float(err.max())}, max "
        f"err / span abs sum {float((err / scale.clamp_min(1e-30)).max())}, "
        f"within 1e-6 + 1e-5 span abs sum: {seg_ok}; share within rtol "
        f"1e-5 / atol 1e-6 of the value: {plain_tol}")
    if not seg_ok:
        raise SystemExit("K4: kernel outside the stated tolerance of the "
                         "plain version")
    ms_k = cuda_ms(lambda: segsum.segmented_suffix_sum_cuda(x, rows, kmax_s), 20)
    ms_p = cuda_ms(lambda: segsum.segmented_suffix_sum_plain(x, rows, kmax_s), 5)
    seg_bytes = (x.numel() + rows.numel() + sum_k.numel()) * 4
    seg_ops = x.numel() * SEGSUM_OPS_PER_ELEMENT
    bound_ms, bound_by = bound(seg_bytes, seg_ops)
    kernels["segsum"] = dict(
        name="segsum", route="cuda", source="gsplat_tpu_torch/csrc/segsum.cu",
        replaces="gsplat_tpu/ops/pallas/segsum.py:41", launches=None,
        max_abs_err=float(err.max()), ms=ms_k, plain_ms=ms_p,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    log(f"[K4] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms} ms "
        f"({seg_bytes} B, {seg_ops} ops, {bound_by})")
    del x, rows, sum_k, sum_p, scale, err, d_k, features, binned, proj, params
    del col_k, tr_k, g_col, b_k

    # 7. Golden: the JAX reference scene through K3 and K1.
    gdir = os.path.join(HERE, "tests", "golden")
    with np.load(os.path.join(gdir, "scene_42_300.npz")) as d:
        gnp = {k: d[k] for k in d.files}
    gscene = scene_from_numpy(**gnp, device=dev)
    with np.load(os.path.join(gdir, "render_64.npz")) as d:
        golden = d["image"].astype(np.float32)
    before = (cull.launches, raster.launches)
    out = render(gscene, Camera.default(64, 64, device=dev),
                 RenderConfig(**GOLDEN))
    g_db = psnr(out.image.cpu().numpy(), golden)
    log(f"[golden] PSNR {g_db} dB against render_64.npz, launches "
        f"cull +{cull.launches - before[0]} raster +{raster.launches - before[1]}")
    if not (g_db > 55.0 and cull.launches > before[0]
            and raster.launches > before[1]):
        raise SystemExit("golden: render below 55 dB or not through the kernels")

    # 8. Main path: a server answering requests for four views.
    cull.launches = raster.launches = raster.bwd_launches = 0
    segsum.launches = 0
    frame_ms = []
    frames = 0
    for rep in range(4):  # repetition 0 is the warm-up
        for i, cam in enumerate(cams):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, cam, cfg)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            frames += 1
            img = out.image
            ok = (not bool(out.overflow) and int(out.num_intersections) > 0
                  and tuple(img.shape) == (cfg.height, cfg.width, 3)
                  and bool(torch.isfinite(img).all())
                  and float(img.max()) > 0.01)
            if rep == 0:
                log(f"[main] view {i}: {int(out.num_intersections)} "
                    f"intersections, overflow {bool(out.overflow)}, image "
                    f"max {float(img.max())} mean {float(img.mean())}, "
                    f"min T {float(out.transmittance.min())}")
            else:
                frame_ms.append(dt)
            if not ok:
                raise SystemExit(f"main: view {i} failed its checks")
    serve = {"cull": cull.launches, "raster_fwd": raster.launches,
             "raster_bwd": raster.bwd_launches, "segsum": segsum.launches}
    log(f"[main] {frames} frames, launches {serve}")
    if min(serve["cull"], serve["raster_fwd"]) == 0:
        raise SystemExit("main: a kernel of the path was never launched")
    log(f"[main] median {statistics.median(frame_ms)} ms per frame over "
        f"{len(frame_ms)} frames (min {min(frame_ms)}, max {max(frame_ms)}) "
        f"at {cfg.width}x{cfg.height}, {NUM_GAUSSIANS} Gaussians, on {card}")

    # 9. Main path: a trainer taking steps, one view per step.
    tcfg = RenderConfig(**BENCH, **EXACT)
    train, targets, step = make_trainer(scene, cams, tcfg, dev)
    step_ms, losses = [], []
    warmup = len(cams)
    for i in range(TRAIN_ROUNDS * len(cams)):
        if i == warmup:
            cull.launches = raster.launches = raster.bwd_launches = 0
            segsum.launches = 0
        v = i % len(cams)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, (tap, visible) = step(train, [cams[v]], targets[v : v + 1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i >= warmup:
            step_ms.append(dt)
        log(f"[train] step {i} view {v}: loss {losses[-1]}, "
            f"{int(aux['num_intersections'])} intersections, overflow "
            f"{bool(aux['overflow'])}, grads finite {bool(aux['grads_finite'])}"
            f", {int(visible.sum())} visible, {dt} ms")
        if bool(aux["overflow"]) or not bool(aux["grads_finite"]) or \
                not np.isfinite(losses[-1]):
            raise SystemExit(f"train: step {i} overflowed or went non-finite")
    launches = {"cull": cull.launches, "raster_fwd": raster.launches,
                "raster_bwd": raster.bwd_launches, "segsum": segsum.launches}
    rounds = [statistics.mean(losses[r * len(cams) : (r + 1) * len(cams)])
              for r in range(TRAIN_ROUNDS)]
    log(f"[train] {len(step_ms)} measured steps, launches {launches}, mean "
        f"loss per round {rounds}")
    if min(launches.values()) == 0:
        raise SystemExit("train: a kernel of the path was never launched")
    if not rounds[-1] < rounds[0]:
        raise SystemExit("train: the loss did not fall")
    log(f"[train] median {statistics.median(step_ms)} ms per step over "
        f"{len(step_ms)} steps (min {min(step_ms)}, max {max(step_ms)}) at "
        f"{cfg.width}x{cfg.height}, {NUM_GAUSSIANS} Gaussians, on {card}")

    # 10. Golden gradients: the card's four kernels against the CPU plain
    # path (last, so that its CPU threads do not share the host with the
    # main paths' timing).
    gcfg = RenderConfig(**GOLDEN, **EXACT)
    target = np.random.default_rng(0).uniform(size=(64, 64, 3)).astype(np.float32)
    before = (raster.bwd_launches, segsum.launches)
    results = []
    for d in (dev, torch.device("cpu")):
        loss_d, g_d = render_loss_and_grad(
            scene_from_numpy(**gnp, device=d), Camera.default(64, 64, device=d),
            torch.from_numpy(target).to(d), gcfg)
        results.append((float(loss_d), {f: getattr(g_d, f).cpu().numpy()
                                        for f in SCENE_FIELDS}))
    rose = (raster.bwd_launches > before[0], segsum.launches > before[1])
    worst = {}
    for f in SCENE_FIELDS:
        a, b = results[0][1][f], results[1][1][f]
        worst[f] = float((np.abs(a - b) / (1e-5 + 5e-3 * np.abs(b))).max())
    log(f"[golden-grad] loss card {results[0][0]} cpu {results[1][0]}; worst "
        f"|error| / (1e-5 + 5e-3 |cpu|) per field {worst}; K2, K4 launched "
        f"{rose}")
    if not (max(worst.values()) <= 1.0 and all(rose)):
        raise SystemExit("golden gradients: card outside rtol 5e-3 / atol "
                         "1e-5 of the CPU path, or not through K2 and K4")

    for name, n in launches.items():
        kernels[name]["launches"] = n
        kernels[name]["serve_launches"] = serve[name]
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
