"""Benchmark harness (port of `gsplat_tpu.utils.bench`): times the fwd or
fwd+bwd pipeline and reports it/s and Mpix/s, with the same arguments and
result keys as the JAX `run_bench`; with `sharded_tiles` or
`gaussian_shards` the tile-sharded or Gaussian-sharded path, one process per
rank (`torchrun`), each rank timing the same window between two collectives
and rank 0's numbers reported.

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
from gsplat_tpu_torch.render.pipeline import render_jit, render_loss_and_grad

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
    """The call the window repeats, each one dispatch as the JAX bench
    times jitted functions: the forward image of `render_jit` ('fwd'), or
    `render_loss_and_grad`'s L1 loss against a black target and its scene
    gradients ('fwd_bwd'). On a CUDA device both replay a CUDA graph
    captured by the first call (`compile_s` includes the capture)."""
    if mode == "fwd":
        return lambda: render_jit(scene, cam, cfg).image
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
    dist_backend: str | None = None,
) -> dict:
    """it/s of `mode` ('fwd': the render; 'fwd_bwd': the L1 loss and its
    scene gradients) at width x height on `device`, with the JAX result's
    keys. `impl` selects nothing in the port (one path) and is only named
    in the metric. `compile_s` is the first call's seconds: it includes
    the `nvcc` build of the kernels when `build/` holds none for these
    sources. `sharded_tiles` (a data_shards x sharded_tiles mesh; the
    capacity is per shard) and `gaussian_shards` (with per_dest_capacity)
    are the multi-device benches, with ssim_weight the loss's, which only
    they read: every rank of the process group calls run_bench alike, and
    `dist_backend` names the backend to bring the group up with from
    torchrun's environment when it is not up yet (`multihost.initialize`).
    The port adds `after_window`: called, when given, with the call the
    window timed, after the window (`chip_smoke.py` counts its
    synchronising calls)."""
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
    if sharded_tiles or gaussian_shards:
        from gsplat_tpu_torch.parallel import multihost

        multihost.initialize(dist_backend, device=device)
        if sharded_tiles:
            return _run_bench_sharded(scene, cam, cfg, mode, iters,
                                      sharded_tiles, data_shards, ssim_weight,
                                      target_its, impl, device)
        return _run_bench_gaussian_sharded(scene, cam, cfg, mode, iters,
                                           gaussian_shards, per_dest_capacity,
                                           ssim_weight, target_its, impl,
                                           device)
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
    out = render_jit(scene, cam, cfg)
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


def _timed_window(fn, iters: int, mesh, device):
    """(compile_s, seconds per call) of fn on every rank of the mesh: the
    first call, one more, then `iters` calls between two collectives, so
    that the window closes when the slowest rank is done."""
    from gsplat_tpu_torch.parallel.sharding import all_reduce

    fence = torch.zeros((1,), device=device)
    all_reduce(fence, mesh)
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    compile_s = time.perf_counter() - t0
    out = fn()
    all_reduce(fence, mesh)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    all_reduce(fence, mesh)
    synchronize(device)
    del out
    return compile_s, (time.perf_counter() - t0) / iters


def _run_bench_sharded(scene, cam, cfg, mode, iters, n_tiles, n_data,
                       ssim_weight, target_its, impl, device):
    """The tile-sharded (x data-parallel) bench body: the frame of
    `render_tile_sharded_jit` (one band per rank, the bands gathered on
    every rank), or the sharded train step on n_data views, with the bytes
    its collectives move."""
    import dataclasses

    from gsplat_tpu_torch.parallel.sharding import (
        make_mesh,
        render_tile_sharded_jit,
    )
    from gsplat_tpu_torch.parallel.train_step import (
        make_sharded_train_step,
        shard_batch,
    )
    from gsplat_tpu_torch.train.loop import make_optimizer
    from gsplat_tpu_torch.train.losses import SSIM_HALO

    mesh = make_mesh({"data": n_data, "tiles": n_tiles}, device)
    w, h = cfg.width, cfg.height
    # Bytes per step (float32): the gradient all_reduce's payload (the whole
    # scene, once; a ring moves about twice that), and the SSIM halo rows of
    # prediction and target, both ways, per view.
    grad_bytes = sum(getattr(scene, f.name).numel() * 4
                     for f in dataclasses.fields(scene))
    halo_bytes = (2 * SSIM_HALO * cfg.padded_width * 3 * 4 * 2 * n_data
                  if ssim_weight > 0.0 else 0)
    if mode == "fwd":
        def fn():
            return render_tile_sharded_jit(scene, cam, cfg, mesh)[0]

        # The gather of the image and T bands (float32, the padded grid).
        comm = {"fwd_comm_bytes_per_frame": (
            cfg.padded_height * cfg.padded_width * 4 * 4
            if n_tiles > 1 else 0)}
    else:
        train = type(scene)(**{f.name: getattr(scene, f.name).detach().clone()
                               for f in dataclasses.fields(scene)})
        step = make_sharded_train_step(cfg, mesh, make_optimizer(train, 1e-2),
                                       ssim_weight=ssim_weight)
        targets = torch.zeros((n_data, cfg.padded_height, cfg.padded_width, 3),
                              device=device)
        cams, targets = shard_batch([cam] * n_data, targets, mesh)

        def fn():
            return step(train, cams, targets)

        comm = {"grad_psum_bytes_per_step": grad_bytes,
                "ssim_halo_bytes_per_step": halo_bytes}
    compile_s, dt = _timed_window(fn, iters, mesh, device)
    its = 1.0 / dt
    _, _, ovf = render_tile_sharded_jit(scene, cam, cfg, mesh)
    return {
        "metric": (f"{mode} it/s @ {w}x{h}, {scene.num_gaussians} gaussians "
                   f"(sharded data{n_data}xtiles{n_tiles}, {impl})"),
        "value": round(its, 3),
        "unit": "it/s",
        "vs_baseline": round(its / target_its, 4),
        "details": {
            "ms_per_iter": round(dt * 1000, 3),
            "mpix_per_s": round(w * h / dt / 1e6, 2),
            "compile_s": round(compile_s, 1),
            "mesh": {"data": n_data, "tiles": n_tiles},
            "per_shard_max_intersections": cfg.max_intersections,
            "overflow": bool(ovf),
            "devices": mesh.size,
            "device": device_name(device),
            **comm,
        },
    }


def _run_bench_gaussian_sharded(scene, cam, cfg, mode, iters, d,
                                per_dest_capacity, ssim_weight, target_its,
                                impl, device):
    """The Gaussian-sharded bench body: the frame of
    `render_gaussian_sharded_jit` (per rank its shard's exchange, the
    merge, its band's blend and the gather), or the sharded train step,
    with the fragment exchange's bytes and the occupancy report against
    per_dest_capacity."""
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        exchange_bytes,
        fragment_occupancy,
        render_gaussian_sharded_jit,
        shard_scene,
    )
    from gsplat_tpu_torch.parallel.gaussian_train import (
        make_gaussian_sharded_train_step,
        shard_train_state,
    )
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg, make_mesh
    from gsplat_tpu_torch.train.losses import SSIM_HALO

    mesh = make_mesh({"gauss": d}, device)
    w, h = cfg.width, cfg.height
    cap = per_dest_capacity or max(cfg.max_intersections // d, 1)
    occ = fragment_occupancy(scene, cam, cfg, d, per_dest_capacity=cap)
    wire = exchange_bytes(cfg, d, cap)
    lcfg = local_tile_cfg(cfg, d)
    if mode == "fwd":
        local = shard_scene(scene, mesh)

        def fn():
            return render_gaussian_sharded_jit(local, cam, cfg, mesh,
                                               per_dest_capacity=cap)[0]

        comm = {"a2a_bytes_per_frame": wire["fwd"]}
    else:
        local, opt = shard_train_state(scene, mesh, lr=1e-2)
        step = make_gaussian_sharded_train_step(
            cfg, mesh, opt, scene.num_gaussians, ssim_weight=ssim_weight,
            per_dest_capacity=cap)
        targets = torch.zeros((1, lcfg.height, lcfg.width, 3), device=device)

        def fn():
            return step(local, [cam], targets)

        comm = {
            "a2a_bytes_per_step": wire["fwd"] + wire["bwd"],
            "ssim_halo_bytes_per_step": (
                2 * SSIM_HALO * cfg.padded_width * 3 * 4 * 2
                if ssim_weight > 0.0 else 0),
        }
    compile_s, dt = _timed_window(fn, iters, mesh, device)
    its = 1.0 / dt
    return {
        "metric": (f"{mode} it/s @ {w}x{h}, {scene.num_gaussians} gaussians "
                   f"(gaussian-sharded x{d}, {impl})"),
        "value": round(its, 3),
        "unit": "it/s",
        "vs_baseline": round(its / target_its, 4),
        "details": {
            "ms_per_iter": round(dt * 1000, 3),
            "mpix_per_s": round(w * h / dt / 1e6, 2),
            "compile_s": round(compile_s, 1),
            "mesh": {"gauss": d},
            "per_dest_capacity": cap,
            "fragment_occupancy": occ,
            "overflow": occ["overflow"],
            "devices": mesh.size,
            "device": device_name(device),
            **comm,
        },
    }
