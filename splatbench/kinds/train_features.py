"""Training Feature 3DGS (Zhou et al. 2024, arXiv:2312.03203): the closed
loop of `kinds/train.py` over the program's captured train step of a
FeatureScene, which also takes each view's teacher map. One view a step,
the views in an order shuffled from the seed each epoch; nothing is read
from the card inside the window, which ends in one synchronise.

Set-up draws the scene, its features and decoder (`gen_features.py`), the
targets and the teachers' maps, renders one view drawn from the seed (the
traffic's `sample_spans`) through the program's `render` to keep its
feature map, then makes the optimizer and the step and drives that step
through its first `setup_steps` steps as `kinds/train.py` does. The
comparison holds those steps' numbers over every field (the five, the
features and the decoder), the sampled view's feature map and the first
step's gradient of the decoder's weight, element by element, to the
reference (`reference/features.py`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from splatbench import gen, gen_features, port, roofline_features, tracing
from splatbench.frozen import SCENE_FIELDS
from splatbench.kinds import train as plain
from splatbench.reference import features as ref_features
from splatbench.reference import render as ref_render

FIELDS = ref_features.FIELDS
EPOCHS = plain.EPOCHS


def _scene0(ctx) -> dict:
    """The seed's scene and feature fields, on the device."""
    cfg = ctx.config
    fields = gen.make_scene(cfg, ctx.seed, ctx.device)
    fields.update(gen_features.make_feature_fields(
        cfg, fields["means"].shape[0], ctx.seed, ctx.device))
    return fields


def _first_gradient(opt, name: str) -> torch.Tensor:
    """A field's gradient as Adam took it, from its state after one step:
    the first moment over 1 - beta1."""
    g = next(g for g in opt.param_groups if g["name"] == name)
    m = opt.state[g["params"][0]]["exp_avg"]
    return (m / (1.0 - g["betas"][0])).detach().clone()


def _step(ctx, v: int):
    return ctx.step(ctx.scene, [ctx.cams[v]], ctx.targets[v:v + 1],
                    ctx.sh_degree, teachers=ctx.teachers[v:v + 1])


def setup(ctx) -> None:
    from gsplat_tpu_torch.models.gaussians import FeatureScene
    from gsplat_tpu_torch.render.pipeline import render
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
    ctx.teachers = gen_features.make_teachers(
        tr["teachers"], len(ctx.views), cfg, ctx.seed, ctx.device)
    ctx.order = gen.epoch_orders(ctx.seed, len(ctx.views), EPOCHS).reshape(-1)
    ctx.sample = gen.sample_indices(ctx.seed, tr["sample_spans"])[0]
    ctx.scene = FeatureScene(**_scene0(ctx))
    with torch.no_grad():
        ctx.sample_map = render(ctx.scene, ctx.cams[ctx.sample],
                                ctx.cfg).features
    fc = cfg["features"]
    ctx.opt = make_optimizer(ctx.scene, lr=tc["lr"], feature_lr=fc["lr"],
                             decoder_lr=fc["decoder_lr"])
    ctx.step = make_train_step(ctx.cfg, ctx.opt,
                               ssim_weight=tc["ssim_weight"],
                               feature_weight=fc["gamma"])
    ctx.sh_degree = tc["active_sh_degree"]
    losses = []
    for i in range(tr["setup_steps"]):
        loss, aux, _ = _step(ctx, ctx.order[i])
        losses.append(loss)
        if i == 0:
            ctx.grad_norms = plain._first_gradient_norms(ctx.opt)
            ctx.decoder_grad = _first_gradient(ctx.opt, "decoder_weight")
    ctx.setup_losses = [float(x) for x in losses]
    ctx.grad_norms = {k: float(v) for k, v in ctx.grad_norms.items()}
    ctx.after_setup = {k: getattr(ctx.scene, k).detach().to("cpu", copy=True)
                       for k in FIELDS}
    ctx.next = tr["setup_steps"]
    tracing.sync(ctx.device)


def _run_step(ctx, v: int) -> None:
    with record_function("splatbench.step"):
        loss, aux, _ = _step(ctx, v)
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
    return {"metrics": {"step_ms": 1e3 * window_s / (i - ctx.next)}}


def traced_window(ctx):
    """`repeats` rounds over the next `views` views of the order."""
    t = ctx.traffic["trace"]
    ctx.traced_views = [int(ctx.order[ctx.next + j])
                        for j in range(t["views"])]
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
        eager = make_eager_train_step(
            ctx.cfg, ctx.opt, ctx.config["train"]["ssim_weight"],
            feature_weight=ctx.config["features"]["gamma"])
        v = ctx.traced_views[0]
        args = ([ctx.cams[v]], ctx.targets[v:v + 1], ctx.sh_degree)
        eager(ctx.scene, *args, teachers=ctx.teachers[v:v + 1])
        tracing.sync(ctx.device)
        with tracing.profiled() as prof:
            eager(ctx.scene, *args, teachers=ctx.teachers[v:v + 1])
            tracing.sync(ctx.device)
        ctx.eager = tracing.eager_counts(prof)
        del eager
    for name in ("step", "opt", "scene", "cams", "targets", "teachers"):
        delattr(ctx, name)
    port.release(ctx.device)


def _ref_cams(ctx, views) -> list:
    rc = ctx.config["render"]
    return [ref_render.camera(ctx.views[v], rc["width"], rc["height"],
                              ctx.device) for v in views]


def _reference(ctx, dtype=torch.float32, rows=None, rows_dtype=None,
               tf32=False) -> tuple[dict, dict]:
    """(the reference's readings of the set-up steps and of the sampled
    view's feature map, from the seed's fields; those fields)."""
    cfg, tr = ctx.config, ctx.traffic
    rc = cfg["render"]
    views = [int(v) for v in ctx.order[:tr["setup_steps"]]]
    scene0 = _scene0(ctx)
    targets = gen.make_targets(tr["targets"], len(ctx.views), rc["height"],
                               rc["width"], ctx.seed, ctx.device, views)
    teachers = gen_features.make_teachers(tr["teachers"], len(ctx.views),
                                          cfg, ctx.seed, ctx.device, views)
    out = ref_features.run(scene0, _ref_cams(ctx, views), targets, teachers,
                           rc, cfg["train"], cfg["features"], dtype, rows,
                           rows_dtype, tf32)
    del targets, teachers
    port.release(ctx.device)
    out["map"] = ref_features.render(
        scene0, _ref_cams(ctx, [ctx.sample])[0], rc, dtype,
        rows_dtype=rows_dtype)["features"]
    return out, scene0


def _scalars(readings: dict) -> dict:
    """The readings a run prints: all but the tensors."""
    return {k: v for k, v in readings.items()
            if k not in ("map", "decoder_grad")}


def _numbers(got: dict, ref: dict) -> dict:
    from splatbench import compare

    d = got["map"].float() - ref["map"].float()
    g = got["decoder_grad"] - ref["decoder_grad"]
    return dict(compare.train_numbers(got, ref),
                feature_rmse=float(torch.sqrt(torch.mean(d * d))),
                decoder_grad_gap=float(torch.linalg.vector_norm(g)
                                       / torch.linalg.vector_norm(
                                           ref["decoder_grad"])))


def numbers(ctx) -> dict:
    """The set-up steps and the sampled view's feature map again in the
    reference; the gaps to the program's."""
    ctx.reference, scene0 = _reference(ctx)
    change = {k: float(torch.linalg.vector_norm(
        ctx.after_setup[k].to(ctx.device) - scene0[k])) for k in FIELDS}
    ctx.program = dict(losses=ctx.setup_losses, grad_norms=ctx.grad_norms,
                       change_norms=change, map=ctx.sample_map,
                       decoder_grad=ctx.decoder_grad.to(ctx.device))
    result = _numbers(ctx.program, ctx.reference)
    ctx.detail = {k: _scalars(d) for k, d in (("program", ctx.program),
                                              ("reference", ctx.reference))}
    ctx.detail["sample_view"] = ctx.sample
    return result


# Faults planted in the reference put in the program's place: the image
# loss over the first half of the rows, the feature rows rounded to
# bfloat16, the decoder and its gradients in TF32.
FAULTS = ("half", "bf16_rows", "tf32")


def control(ctx, fault: str | None = None) -> dict:
    """After `numbers`: the reference put in the program's place, in
    bfloat16 (the control), or with a fault of FAULTS planted."""
    if fault is None:
        other, _ = _reference(ctx, torch.bfloat16)
    elif fault == "half":
        other, _ = _reference(ctx, rows=ctx.config["render"]["height"] // 2)
    elif fault == "bf16_rows":
        other, _ = _reference(ctx, rows_dtype=torch.bfloat16)
    elif fault == "tf32":
        other, _ = _reference(ctx, tf32=True)
    else:
        raise ValueError(f"no fault {fault!r}: {FAULTS}")
    ctx.detail[fault or "control"] = _scalars(other)
    return _numbers(other, ctx.reference)


def work(ctx) -> dict:
    """Per traced step: K6's and K7's (ops, bytes) and the step's FP32
    operations, from the reference's pass over the traced views (the
    fields as they stood when the window began)."""
    cfg = ctx.config
    rc = cfg["render"]
    scene = {k: v.to(ctx.device) for k, v in ctx.after_setup.items()}
    n = scene["means"].shape[0]
    per_g = sum(int(np.prod(scene[k].shape[1:])) for k in SCENE_FIELDS)
    k6, k7, ops = [], [], []
    for cam in _ref_cams(ctx, ctx.traced_views):
        tally = {}
        ref_features.render(scene, cam, rc, tally=tally)
        k6.append(roofline_features.k6_work(tally, rc, n))
        k7.append(roofline_features.k7_work(tally, rc, n))
        ops.append(roofline_features.step_ops(
            tally, rc, cfg["features"], n, per_g,
            cfg["train"]["ssim_weight"]))
    return {"K6": np.mean(k6, 0).tolist(), "K7": np.mean(k7, 0).tolist(),
            "ops": float(np.mean(ops))}
