"""Serving: one viewer in a closed loop. Each request is a pose of a
smooth closed path (the traffic file's), taken in a start and a direction
drawn from the seed; the frame is the program's `render_jit`, and its
image is copied into a pinned host buffer that set-up allocated. A frame
ends when its image is on the host, and the next request follows. A
frame's latency runs from its request to that moment.

A sample of frames drawn from the seed (one index in each of the traffic
file's `sample_spans`) is delivered into buffers of its own and compared
with the reference after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from splatbench import gen, port, roofline, tracing
from splatbench.reference import render as ref_render

# Frames of the path order drawn up front; a longer window wraps round.
PATH_FRAMES = 1 << 16


def setup(ctx) -> None:
    from gsplat_tpu_torch.render.pipeline import render_jit

    cfg, tr = ctx.config, ctx.traffic
    rc = cfg["render"]
    ctx.render_jit = render_jit
    ctx.cfg = port.render_config(rc)
    ctx.views = gen.view_matrices(tr["poses"])
    ctx.cams = [port.camera(v, rc["width"], rc["height"], ctx.device)
                for v in ctx.views]
    ctx.order = gen.path_order(ctx.seed, len(ctx.views), PATH_FRAMES)
    ctx.samples = gen.sample_indices(ctx.seed, tr["sample_spans"])
    ctx.scene_fields = gen.make_scene(cfg, ctx.seed, ctx.device)
    ctx.scene = port.scene(ctx.scene_fields)
    shape = (rc["height"], rc["width"], 3)
    ctx.host = {i: torch.empty(shape, dtype=torch.float32,
                               pin_memory=ctx.device.type == "cuda")
                for i in [-1] + ctx.samples}
    # The frame's graph is captured by its first call; one replay and
    # delivery more warm the copy to the host.
    ctx.flags = []
    for i in range(2):
        _frame(ctx, int(ctx.order[i]), -1)
    tracing.sync(ctx.device)


def _frame(ctx, v: int, buffer: int) -> None:
    """One request: the frame of pose v, delivered into host buffer
    `buffer`; its failure flag (overflow, or a value not finite) kept on
    the card."""
    with record_function("splatbench.frame"):
        out = ctx.render_jit(ctx.scene, ctx.cams[v], ctx.cfg)
    with record_function("splatbench.deliver"):
        ctx.host[buffer].copy_(out.image, non_blocking=True)
        bad = out.overflow | ~torch.isfinite(out.image).all()
        tracing.sync(ctx.device)
    ctx.flags.append(bad)


def _request(ctx, i: int, v: int) -> None:
    """Request i, of pose v; a sampled request is delivered into its own
    buffer, and its pose kept."""
    r = time.perf_counter()
    if i in ctx.host:
        ctx.sample_pose[i] = v
    _frame(ctx, v, i if i in ctx.host else -1)
    ctx.latency.append(time.perf_counter() - r)


def window(ctx, seconds: float) -> dict:
    ctx.flags, ctx.latency, ctx.sample_pose = [], [], {}
    tracing.sync(ctx.device)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        _request(ctx, i, int(ctx.order[i % len(ctx.order)]))
        i += 1
    window_s = time.perf_counter() - t0
    ctx.delivered = i
    lat = np.asarray(ctx.latency) * 1e3
    return {"metrics": {"frame_ms": 1e3 * window_s / i,
                        "frame_p95_ms": float(np.percentile(lat, 95))}}


def traced_window(ctx):
    """`repeats` rounds over the first `poses` poses of the path, under
    the profiler."""
    t = ctx.traffic["trace"]
    ctx.traced_views = [int(ctx.order[i]) for i in range(t["poses"])]
    calls = t["poses"] * t["repeats"]
    ctx.flags, ctx.latency, ctx.sample_pose = [], [], {}
    with tracing.profiled() as prof:
        window_s = tracing.timed_window(
            calls,
            lambda i: _request(ctx, i, ctx.traced_views[i % t["poses"]]),
            ctx.device)
    ctx.delivered = calls
    return prof, window_s, calls


def wind_down(ctx, traced: bool) -> None:
    from gsplat_tpu_torch.render.pipeline import render

    ctx.attempted = len(ctx.flags)
    ctx.failed = int(torch.stack(ctx.flags).sum()) if ctx.flags else 0
    ctx.flags = []
    ctx.eager = None
    if traced:
        cam = ctx.cams[ctx.traced_views[0]]
        with torch.no_grad():
            render(ctx.scene, cam, ctx.cfg)
            tracing.sync(ctx.device)
            with tracing.profiled() as prof:
                render(ctx.scene, cam, ctx.cfg)
                tracing.sync(ctx.device)
        ctx.eager = tracing.eager_counts(prof)
    # The scene is the benchmark's input: a copy is kept for the reference,
    # and dropping the program's (the frame's graph goes with it) frees
    # the card for it.
    ctx.scene_fields = {k: v.clone() for k, v in ctx.scene_fields.items()}
    for name in ("scene", "cams", "render_jit"):
        delattr(ctx, name)
    port.release(ctx.device)


def _ref_cam(ctx, v: int) -> dict:
    rc = ctx.config["render"]
    return ref_render.camera(ctx.views[v], rc["width"], rc["height"],
                             ctx.device)


def _worst(pairs) -> dict:
    """The worst image numbers over (program, reference) image pairs; NaN
    where there is none."""
    from splatbench import compare

    worst = {"frame_rmse": float("nan"), "frame_max_abs": float("nan")}
    for i, (got, ref) in enumerate(pairs):
        for k, x in compare.image_numbers(got, ref).items():
            worst[k] = x if i == 0 or np.isnan(x) else max(worst[k], x)
    return worst


def _ref_image(ctx, v: int, dtype=torch.float32,
               order: str = "unrolled") -> torch.Tensor:
    return ref_render.render(ctx.scene_fields, _ref_cam(ctx, v),
                             ctx.config["render"], dtype,
                             order=order)["image"]


def numbers(ctx) -> dict:
    """Each sampled frame that was delivered against the reference's image
    of its pose: the worst root mean square and largest difference."""
    ctx.reference = {s: _ref_image(ctx, v) for s, v in ctx.sample_pose.items()}
    ctx.detail = {"sampled_request_pose": ctx.sample_pose}
    return _worst((ctx.host[s].to(ctx.device), ref)
                  for s, ref in ctx.reference.items())


def control(ctx, fault: str | None = None) -> dict:
    """After `numbers`: the reference put in the program's place, in
    bfloat16 (the control) or in another sound float32 order ("reorder":
    the projection's matrix products batched)."""
    if fault not in (None, "reorder"):
        raise ValueError(f"no fault {fault!r} for serving")
    dtype = torch.float32 if fault else torch.bfloat16
    order = "matmul" if fault else "unrolled"
    return _worst((_ref_image(ctx, ctx.sample_pose[s], dtype, order), ref)
                  for s, ref in ctx.reference.items())


def work(ctx) -> dict:
    """Per traced frame: K1's (ops, bytes) and the frame's FP32
    operations, from the reference's pass over the traced poses."""
    rc = ctx.config["render"]
    n = ctx.scene_fields["means"].shape[0]
    k1, ops = [], []
    for v in ctx.traced_views:
        tally = {}
        ref_render.render(ctx.scene_fields, _ref_cam(ctx, v), rc, tally=tally)
        k1.append(roofline.k1_work(tally, rc))
        ops.append(roofline.frame_ops(tally, rc, n))
    return {"K1": np.mean(k1, 0).tolist(), "ops": float(np.mean(ops))}
