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
  5. golden: the JAX reference scene (tests/golden/scene_42_300.npz) through
     both kernels, above 55 dB against tests/golden/render_64.npz;
  6. main path, a server answering requests: `render` of the 1M-Gaussian
     SH-3 scene at 1920x1080 (the bench config of bench.py, f32 stream) for
     four views, with the launch counts set to 0 just before and read just
     after; every frame has no overflow, intersections, a finite non-black
     image, and both kernels launched.
Then one JSON line of kernel numbers, and as the last line
{"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero without.
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

BENCH = dict(
    width=1920, height=1080, tile_size=32, max_intersections=4_100_000,
    block_size=32, max_per_tile=8192, binning="tiered",
    tier_spec=((4, 0), (8, 2), (16, 6), (32, 25), (64, 50)),
    pallas_block_size=128, stream_format="f32",
)
GOLDEN = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=512)
NUM_GAUSSIANS = 1_000_000


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


def main() -> int:
    # Drive one card, so that the device count reported is the one used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from gsplat_tpu_torch import RenderConfig, random_scene, render
    from gsplat_tpu_torch.convert import scene_from_numpy
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.camera import Camera
    from gsplat_tpu_torch.ops.cuda import _build, cull, raster
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import (
        _raster_tiles,
        _tiles_to_image,
        _tiles_to_scalar_image,
    )

    # The plain versions contract in full float32 (no TF32 anywhere).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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
    t_bytes = cull_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = cull_ops / FP32_OPS_PER_S * 1e3
    kernels["cull"] = dict(
        name="cull", route="cuda", source="gsplat_tpu_torch/csrc/cull.cu",
        replaces="gsplat_tpu/ops/pallas/cull.py:31", launches=None,
        max_abs_err=float((mask_k.float() - mask_p.float()).abs().max()),
        ms=ms_k, plain_ms=ms_p, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
    )
    log(f"[K3] kernel {ms_k} ms, plain {ms_p} ms, bound {max(t_bytes, t_ops)} "
        f"ms ({cull_bytes} B -> {t_bytes} ms, {cull_ops} ops -> {t_ops} ms)")
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
    t_bytes = blend_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = blend_ops / FP32_OPS_PER_S * 1e3
    kernels["raster_fwd"] = dict(
        name="raster_fwd", route="cuda",
        source="gsplat_tpu_torch/csrc/raster_fwd.cu",
        replaces="gsplat_tpu/ops/pallas/raster.py:143", launches=None,
        max_abs_err=max(float(err_img.max()), float(err_t.max())),
        ms=ms_k, plain_ms=ms_p, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
    )
    log(f"[K1] kernel {ms_k} ms, plain {ms_p} ms, bound {max(t_bytes, t_ops)} "
        f"ms ({blend_bytes} B -> {t_bytes} ms, {blend_ops} ops -> {t_ops} ms)")
    del col_p, tr_p, img_p, t_p, features, binned, proj, params

    # 5. Golden: the JAX reference scene through both kernels.
    gdir = os.path.join(HERE, "tests", "golden")
    with np.load(os.path.join(gdir, "scene_42_300.npz")) as d:
        gscene = scene_from_numpy(**{k: d[k] for k in d.files}, device=dev)
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

    # 6. Main path: a server answering requests for four views.
    cull.launches = 0
    raster.launches = 0
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
    launches = {"cull": cull.launches, "raster_fwd": raster.launches}
    log(f"[main] {frames} frames, launches {launches}")
    if min(launches.values()) == 0:
        raise SystemExit("main: a kernel of the path was never launched")
    log(f"[main] median {statistics.median(frame_ms)} ms per frame over "
        f"{len(frame_ms)} frames (min {min(frame_ms)}, max {max(frame_ms)}) "
        f"at {cfg.width}x{cfg.height}, {NUM_GAUSSIANS} Gaussians, on {card}")

    for name, n in launches.items():
        kernels[name]["launches"] = n
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
