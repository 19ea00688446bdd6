"""Benchmark harness (port of `gsplat_tpu.utils.bench`, single device): times
the fwd or fwd+bwd pipeline on one device and reports it/s and Mpix/s, with
the same arguments and result keys as the JAX `run_bench`.

The window dispatches `iters` calls and synchronises once, so host dispatch
overlaps device work as in a training loop; the host clock is read around
it. It is a fair reading only while no call inside the window waits for
the device: `chip_smoke.py` counts the synchronising calls per iteration
of the timed call with `torch.cuda.set_sync_debug_mode` (`after_window`).
"""

from __future__ import annotations

import subprocess
import time

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import random_scene, realistic_scene
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.render.pipeline import render, render_loss_and_grad

NOT_PORTED = ("the multi-device benches are not yet ported (ROADMAP.md "
              "queue 1 item 4)")


def device_name(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (the name alone, said so,
    where nvidia-smi cannot be run); 'cpu' for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        return out.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def bench_scene(num_gaussians: int, ply: str | None = None, seed: int = 0,
                scene_kind: str = "random", device="cuda"):
    """The bench's scene: a PLY, or the SH-3 random or realistic scene drawn
    from a torch generator seeded `seed` on `device`."""
    if ply:
        from gsplat_tpu_torch.io.ply import load_ply

        return load_ply(ply, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    make = realistic_scene if scene_kind == "realistic" else random_scene
    return make(num_gaussians, sh_degree=3, generator=gen, device=device)


def bench_iteration(scene, cam: Camera, cfg: RenderConfig, mode: str):
    """The call the window repeats: the forward image ('fwd'), or the L1
    loss against a black target and its scene gradients ('fwd_bwd')."""
    if mode == "fwd":
        def fn():
            with torch.no_grad():
                return render(scene, cam, cfg).image
        return fn
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                         device=scene.means.device)
    return lambda: render_loss_and_grad(scene, cam, target, cfg)


def synchronize(device) -> None:
    """Wait for the card's queue; nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(
    num_gaussians: int = 1_000_000,
    width: int = 1920,
    height: int = 1080,
    impl: str = "jnp",
    mode: str = "fwd_bwd",
    iters: int = 20,
    tile_size: int = 16,
    max_intersections: int = 1 << 22,
    block_size: int = 32,
    max_per_tile: int = 4096,
    ply: str | None = None,
    seed: int = 0,
    target_its: float = 30.0,
    binning: str = "sort",
    pallas_block_size: int = 256,
    tier_spec: tuple | None = None,
    max_tiles_per_gaussian: int | None = None,
    sharded_tiles: int | None = None,
    data_shards: int = 1,
    gaussian_shards: int | None = None,
    per_dest_capacity: int | None = None,
    ssim_weight: float = 0.0,
    scene_kind: str = "random",
    gather_backward: str | None = None,
    grad_readout: str | None = None,
    segment_sum: str | None = None,
    stream_format: str | None = None,
    matmul_precision: str | None = None,
    fragment_format: str | None = None,
    slot_gather: str | None = None,
    max_screen_radius: float | None = None,
    max_tiles_jumbo: int | None = None,
    jumbo_tier_spec: tuple | None = None,
    device="cuda",
    after_window=None,
) -> dict:
    """it/s of `mode` ('fwd': the render; 'fwd_bwd': the L1 loss and its
    scene gradients) at width x height on `device`, with the JAX result's
    keys. `impl` selects nothing in the port (one path) and is only named
    in the metric. `compile_s` is the first call's seconds: it includes
    the `nvcc` build of the kernels when `build/` holds none for these
    sources. `sharded_tiles` and `gaussian_shards` (with data_shards,
    per_dest_capacity and ssim_weight, which only they read) are the JAX
    package's multi-device benches: not yet ported, they raise. The port
    adds `after_window`: called, when given, with the call the window
    timed, after the window (`chip_smoke.py` counts its synchronising
    calls)."""
    if sharded_tiles or gaussian_shards:
        raise NotImplementedError(f"run_bench(sharded_tiles / "
                                  f"gaussian_shards): {NOT_PORTED}")
    device = torch.device(device)
    extra = {}
    if tier_spec is not None:
        extra["tier_spec"] = tuple(tier_spec)
    if max_tiles_per_gaussian is not None:
        extra["max_tiles_per_gaussian"] = max_tiles_per_gaussian
    if gather_backward is not None:
        extra["gather_backward"] = gather_backward
    if grad_readout is not None:
        extra["grad_readout"] = grad_readout
    if segment_sum is not None:
        extra["segment_sum"] = segment_sum
    if stream_format is not None:
        extra["stream_format"] = stream_format
    if matmul_precision is not None:
        extra["matmul_precision"] = matmul_precision
    if fragment_format is not None:
        extra["fragment_format"] = fragment_format
    if slot_gather is not None:
        extra["slot_gather"] = slot_gather
    if max_screen_radius is not None:
        extra["max_screen_radius"] = max_screen_radius
    if max_tiles_jumbo is not None:
        extra["max_tiles_jumbo"] = max_tiles_jumbo
    if jumbo_tier_spec is not None:
        extra["jumbo_tier_spec"] = tuple(tuple(t) for t in jumbo_tier_spec)
    cfg = RenderConfig(
        width=width,
        height=height,
        tile_size=tile_size,
        max_intersections=max_intersections,
        block_size=block_size,
        max_per_tile=max_per_tile,
        binning=binning,
        pallas_block_size=pallas_block_size,
        **extra,
    )
    scene = bench_scene(num_gaussians, ply, seed, scene_kind, device)
    cam = Camera.default(width, height, device=device)
    fn = bench_iteration(scene, cam, cfg, mode)

    # The first call (the kernels' build included) and one more.
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    compile_s = time.perf_counter() - t0
    fn()
    synchronize(device)

    # Steady state: dispatch the whole window, synchronise once.
    t0 = time.perf_counter()
    out_last = None
    for _ in range(iters):
        out_last = fn()
    synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    del out_last
    if after_window is not None:
        after_window(fn)

    its = 1.0 / dt
    mpix_s = width * height / dt / 1e6
    with torch.no_grad():
        out = render(scene, cam, cfg)
    # An overflowed frame dropped work (truncated rects, saturated pools or
    # stream): its cause is classified, so that a truncated frame's time is
    # never taken for a performance number.
    overflow_cause = None
    if bool(out.overflow):
        from gsplat_tpu_torch.ops.binning import diagnose_overflow
        from gsplat_tpu_torch.ops.projection import project_gaussians

        with torch.no_grad():
            proj = project_gaussians(scene, cam, cfg)
        overflow_cause = diagnose_overflow(proj, cfg)["causes"]
    return {
        "metric": f"{mode} it/s @ {width}x{height}, {scene.num_gaussians} gaussians ({impl})",
        "value": round(its, 3),
        "unit": "it/s",
        # Normalized against a 30 it/s target, as the JAX bench is.
        "vs_baseline": round(its / target_its, 4),
        "details": {
            "ms_per_iter": round(dt * 1000, 3),
            "mpix_per_s": round(mpix_s, 2),
            "compile_s": round(compile_s, 1),
            "num_intersections": int(out.num_intersections),
            "overflow": bool(out.overflow),
            "overflow_cause": overflow_cause,
            "suggested_max_intersections": int(out.num_intersections * 1.15),
            "device": device_name(device),
            "impl": impl,
        },
    }
