"""Training: a closed loop of the program's captured train step
(`train/loop.py::make_train_step`), one view a step, the views in an order
shuffled from the seed each epoch, dispatched back to back as a training
loop does; nothing is read from the card inside the window, which ends
in one synchronise.

Set-up makes the scene, the optimizer and the step once, and drives that
same step through its first `setup_steps` steps on distinct views: the
first call runs eagerly (the warm-up) and captures, the later ones are
replays of the graph the window replays. What the comparison needs of
them is kept: each loss (so the replays are held to the reference too;
the window replays the same graph), the first gradient as Adam
holds it after one step (its first moment over 1 - beta1), and the
parameters after the last (on the host). The window goes on from there.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from splatbench import gen, port, roofline, tracing
from splatbench.frozen import SCENE_FIELDS
from splatbench.reference import render as ref_render
from splatbench.reference import train as ref_train

# Epochs of view orders drawn up front; a longer window wraps round.
EPOCHS = 64


def _step_args(ctx, v: int):
    return ([ctx.cams[v]], ctx.targets[v:v + 1], ctx.sh_degree)


def _first_gradient_norms(opt) -> dict:
    """Each field's gradient as Adam took it, from its state after one
    step: the first moment over 1 - beta1 (0 where Adam holds none)."""
    norms = {}
    for g in opt.param_groups:
        m = opt.state.get(g["params"][0], {}).get("exp_avg")
        norms[g["name"]] = (torch.zeros(()) if m is None else
                            torch.linalg.vector_norm(m / (1.0 - g["betas"][0])))
    return norms


def setup(ctx) -> None:
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step

    cfg, tr, tc = ctx.config, ctx.traffic, ctx.config["train"]
    rc = cfg["render"]
    ctx.cfg = port.render_config(rc)
    ctx.views = gen.view_matrices(tr["poses"])
    ctx.cams = [port.camera(v, rc["width"], rc["height"], ctx.device)
                for v in ctx.views]
    ctx.targets = gen.make_targets(tr["targets"], len(ctx.views),
                                   rc["height"], rc["width"], ctx.seed,
                                   ctx.device)
    ctx.order = gen.epoch_orders(ctx.seed, len(ctx.views), EPOCHS).reshape(-1)
    ctx.scene = port.scene(gen.make_scene(cfg, ctx.seed, ctx.device))
    ctx.opt = make_optimizer(ctx.scene, lr=tc["lr"])
    ctx.step = make_train_step(ctx.cfg, ctx.opt, ssim_weight=tc["ssim_weight"])
    ctx.sh_degree = tc["active_sh_degree"]
    losses = []
    for i in range(tr["setup_steps"]):
        loss, aux, _ = ctx.step(ctx.scene, *_step_args(ctx, ctx.order[i]))
        losses.append(loss)
        if i == 0:
            ctx.grad_norms = _first_gradient_norms(ctx.opt)
    ctx.setup_losses = [float(x) for x in losses]
    ctx.grad_norms = {k: float(v) for k, v in ctx.grad_norms.items()}
    ctx.after_setup = {k: getattr(ctx.scene, k).detach().to("cpu", copy=True)
                       for k in SCENE_FIELDS}
    ctx.next = tr["setup_steps"]
    tracing.sync(ctx.device)


def _run_step(ctx, v: int) -> None:
    with record_function("splatbench.step"):
        loss, aux, _ = ctx.step(ctx.scene, *_step_args(ctx, v))
    ctx.flags.append((loss, aux["overflow"], aux["grads_finite"]))


def window(ctx, seconds: float) -> dict:
    ctx.flags = []
    order, i = ctx.order, ctx.next
    tracing.sync(ctx.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _run_step(ctx, order[i % len(order)])
        i += 1
    tracing.sync(ctx.device)
    window_s = time.perf_counter() - t0
    steps = i - ctx.next
    return {"metrics": {"step_ms": 1e3 * window_s / steps}}


def traced_window(ctx):
    """`repeats` rounds over the next `views` views of the order."""
    t = ctx.traffic["trace"]
    ctx.traced_views = [int(ctx.order[ctx.next + j]) for j in range(t["views"])]
    calls = t["views"] * t["repeats"]
    ctx.flags = []
    with tracing.profiled() as prof:
        window_s = tracing.timed_window(
            calls, lambda i: _run_step(ctx, ctx.traced_views[i % t["views"]]),
            ctx.device)
    return prof, window_s, calls


def wind_down(ctx, traced: bool) -> None:
    from gsplat_tpu_torch.train.loop import make_eager_train_step

    ctx.attempted = len(ctx.flags)
    bad = [~torch.isfinite(loss) | ovf | ~ok for loss, ovf, ok in ctx.flags]
    ctx.failed = int(torch.stack(bad).sum()) if bad else 0
    ctx.flags = []
    ctx.eager = None
    if traced:
        eager = make_eager_train_step(ctx.cfg, ctx.opt,
                                      ctx.config["train"]["ssim_weight"])
        v = ctx.traced_views[0]
        eager(ctx.scene, *_step_args(ctx, v))
        tracing.sync(ctx.device)
        with tracing.profiled() as prof:
            eager(ctx.scene, *_step_args(ctx, v))
            tracing.sync(ctx.device)
        ctx.eager = tracing.eager_counts(prof)
        del eager
    for name in ("step", "opt", "scene", "cams", "targets"):
        delattr(ctx, name)
    port.release(ctx.device)


def _ref_cams(ctx, views) -> list:
    rc = ctx.config["render"]
    return [ref_render.camera(ctx.views[v], rc["width"], rc["height"],
                              ctx.device) for v in views]


def _reference(ctx, dtype=torch.float32, rows=None,
               order="unrolled") -> tuple[dict, dict]:
    """(the reference's readings of the set-up steps, from the seed's scene
    on the same views and targets; the seed's scene)."""
    cfg, tr = ctx.config, ctx.traffic
    rc = cfg["render"]
    views = [int(v) for v in ctx.order[:tr["setup_steps"]]]
    scene0 = gen.make_scene(cfg, ctx.seed, ctx.device)
    targets = gen.make_targets(tr["targets"], len(ctx.views), rc["height"],
                               rc["width"], ctx.seed, ctx.device, views)
    return ref_train.run(scene0, _ref_cams(ctx, views), targets, rc,
                         cfg["train"], dtype, rows=rows, order=order), scene0


def numbers(ctx) -> dict:
    """The set-up steps again in the reference; the gaps to the
    program's."""
    from splatbench import compare

    ctx.reference, scene0 = _reference(ctx)
    change = {k: float(torch.linalg.vector_norm(
        ctx.after_setup[k].to(ctx.device) - scene0[k])) for k in SCENE_FIELDS}
    ctx.program = dict(losses=ctx.setup_losses, grad_norms=ctx.grad_norms,
                       change_norms=change)
    ctx.detail = {"program": ctx.program, "reference": ctx.reference}
    return compare.train_numbers(ctx.program, ctx.reference)


def control(ctx, fault: str | None = None) -> dict:
    """After `numbers`: the reference put in the program's place, in
    bfloat16 (the control), with a fault planted ("half": the loss over
    the first half of the image's rows), or in another sound float32
    order ("reorder": the projection's matrix products batched)."""
    from splatbench import compare

    if fault is None:
        other, _ = _reference(ctx, torch.bfloat16)
    elif fault == "half":
        other, _ = _reference(ctx, rows=ctx.config["render"]["height"] // 2)
    elif fault == "reorder":
        other, _ = _reference(ctx, order="matmul")
    else:
        raise ValueError(f"no fault {fault!r}")
    ctx.detail[fault or "control"] = other
    return compare.train_numbers(other, ctx.reference)


def work(ctx) -> dict:
    """Per traced step: K1's and K2's (ops, bytes) and the step's FP32
    operations, from the reference's pass over the traced views (the scene
    as it stood when the window began)."""
    rc, cfg = ctx.config["render"], ctx.config
    scene = {k: v.to(ctx.device) for k, v in ctx.after_setup.items()}
    n = scene["means"].shape[0]
    per_g = sum(int(np.prod(scene[k].shape[1:])) for k in SCENE_FIELDS)
    k1, k2, ops = [], [], []
    for cam in _ref_cams(ctx, ctx.traced_views):
        tally = {}
        ref_render.render(scene, cam, rc, tally=tally)
        k1.append(roofline.k1_work(tally, rc))
        k2.append(roofline.k2_work(tally, rc))
        ops.append(roofline.step_ops(tally, rc, n, per_g,
                                     cfg["train"]["ssim_weight"]))
    return {"K1": np.mean(k1, 0).tolist(), "K2": np.mean(k2, 0).tolist(),
            "ops": float(np.mean(ops))}
