"""Training 2D Gaussian splatting (Huang et al. 2024, arXiv:2403.17888): the
closed loop of `kinds/train.py` over the program's captured train step of a
SurfelScene, whose loss adds the distortion and normal-consistency
regularisers. One view a step, the views in an order shuffled from the
seed each epoch; nothing is read from the card inside the window, which
ends in one synchronise.

Set-up draws the scene (the configuration's draw, each Gaussian's first
two log-scales: `reference/surfels.py`), renders one view drawn from the
seed (the traffic's `sample_spans`) through the program's captured frame
(`render_jit`, a replay of its graph) to keep its normal, depth and
distortion maps, then makes the optimizer and
the step and drives that step through its first `setup_steps` steps as
`kinds/train.py` does. The comparison holds those steps' numbers over the
five fields, and the sampled view's three maps, to the reference
(`reference/surfels.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from splatbench import gen, port, roofline_surfels, tracing
from splatbench.kinds import train as plain
from splatbench.reference import render as ref_render
from splatbench.reference import surfels as ref_surfels

FIELDS = ref_surfels.FIELDS
MAPS = ("normals", "depth", "distortion")
window = plain.window
traced_window = plain.traced_window


def _scene0(ctx) -> dict:
    """The seed's surfels, on the device."""
    fields = gen.make_scene(ctx.config, ctx.seed, ctx.device)
    fields["log_scales"] = fields["log_scales"][:, :2].contiguous()
    return fields


def _weights(ctx) -> dict:
    """The regularisers' weights the configuration states; its filter and
    depth range must be the program's."""
    from gsplat_tpu_torch.ops import surfels as program

    sc = ctx.config["surfels"]
    stated = (sc["filter_inv_square"], sc["near"], sc["far"])
    built = (program.FILTER_INV_SQUARE, program.DEPTH_NEAR, program.DEPTH_FAR)
    if stated != built:
        raise ValueError(f"the program's surfel constants {built} are not "
                         f"the configuration's {stated}")
    return dict(lambda_dist=sc["lambda_dist"],
                lambda_normal=sc["lambda_normal"])


def setup(ctx) -> None:
    from gsplat_tpu_torch.models.gaussians import SurfelScene
    from gsplat_tpu_torch.render import pipeline
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
    ctx.order = gen.epoch_orders(ctx.seed, len(ctx.views),
                                 plain.EPOCHS).reshape(-1)
    ctx.sample = gen.sample_indices(ctx.seed, tr["sample_spans"])[0]
    ctx.scene = SurfelScene(**_scene0(ctx))
    # The sampled view through the captured frame: the first call warms
    # up and captures, the second replays the graph, whose maps are kept;
    # the graph is then dropped.
    for _ in range(2):
        out = pipeline.render_jit(ctx.scene, ctx.cams[ctx.sample], ctx.cfg)
    ctx.sample_maps = {k: getattr(out, k) for k in MAPS}
    del out
    pipeline.RENDER_GRAPHS.entries.clear()
    port.release(ctx.device)
    ctx.opt = make_optimizer(ctx.scene, lr=tc["lr"])
    ctx.step = make_train_step(ctx.cfg, ctx.opt,
                               ssim_weight=tc["ssim_weight"], **_weights(ctx))
    ctx.sh_degree = tc["active_sh_degree"]
    losses = []
    for i in range(tr["setup_steps"]):
        loss, aux, _ = ctx.step(ctx.scene, *plain._step_args(ctx,
                                                             ctx.order[i]))
        losses.append(loss)
        if i == 0:
            ctx.grad_norms = plain._first_gradient_norms(ctx.opt)
    ctx.setup_losses = [float(x) for x in losses]
    ctx.grad_norms = {k: float(v) for k, v in ctx.grad_norms.items()}
    ctx.after_setup = {k: getattr(ctx.scene, k).detach().to("cpu", copy=True)
                       for k in FIELDS}
    ctx.next = tr["setup_steps"]
    tracing.sync(ctx.device)


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
            **_weights(ctx))
        args = plain._step_args(ctx, ctx.traced_views[0])
        eager(ctx.scene, *args)
        tracing.sync(ctx.device)
        with tracing.profiled() as prof:
            eager(ctx.scene, *args)
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


def _reference(ctx, dtype=torch.float32, rows=None, fault=None
               ) -> tuple[dict, dict]:
    """(the reference's readings of the set-up steps and the sampled
    view's maps, from the seed's surfels; those surfels)."""
    cfg, tr = ctx.config, ctx.traffic
    rc = cfg["render"]
    views = [int(v) for v in ctx.order[:tr["setup_steps"]]]
    scene0 = _scene0(ctx)
    targets = gen.make_targets(tr["targets"], len(ctx.views), rc["height"],
                               rc["width"], ctx.seed, ctx.device, views)
    out = ref_surfels.run(scene0, _ref_cams(ctx, views), targets, rc,
                          cfg["train"], cfg["surfels"], dtype, rows, fault)
    del targets
    port.release(ctx.device)
    maps = ref_surfels.render(scene0, _ref_cams(ctx, [ctx.sample])[0], rc,
                              cfg["surfels"], dtype, fault)
    out["maps"] = {k: maps[k].float() for k in MAPS}
    return out, scene0


def _scalars(readings: dict) -> dict:
    """The readings a run prints: all but the maps."""
    return {k: v for k, v in readings.items() if k != "maps"}


def _numbers(got: dict, ref: dict) -> dict:
    from splatbench import compare

    out = compare.train_numbers(got, ref)
    for k in MAPS:
        d = got["maps"][k].float() - ref["maps"][k]
        out[f"{k.rstrip('s')}_rmse"] = float(torch.sqrt(torch.mean(d * d)))
    return out


def numbers(ctx) -> dict:
    """The set-up steps and the sampled view's maps again in the
    reference; the gaps to the program's."""
    ctx.reference, scene0 = _reference(ctx)
    change = {k: float(torch.linalg.vector_norm(
        ctx.after_setup[k].to(ctx.device) - scene0[k])) for k in FIELDS}
    ctx.program = dict(losses=ctx.setup_losses, grad_norms=ctx.grad_norms,
                       change_norms=change, maps=ctx.sample_maps)
    result = _numbers(ctx.program, ctx.reference)
    ctx.detail = {k: _scalars(d) for k, d in (("program", ctx.program),
                                              ("reference", ctx.reference))}
    ctx.detail["sample_view"] = ctx.sample
    return result


def control(ctx, fault: str | None = None) -> dict:
    """After `numbers`: the reference put in the program's place, its
    blend in bfloat16 (the control), or with a fault of
    `reference/surfels.FAULTS` planted."""
    if fault is None:
        other, _ = _reference(ctx, torch.bfloat16)
    elif fault == "half":
        other, _ = _reference(ctx, rows=ctx.config["render"]["height"] // 2)
    elif fault in ref_surfels.FAULTS:
        other, _ = _reference(ctx, fault=fault)
    else:
        raise ValueError(f"no fault {fault!r}: {ref_surfels.FAULTS}")
    ctx.detail[fault or "control"] = _scalars(other)
    return _numbers(other, ctx.reference)


def work(ctx) -> dict:
    """Per traced step: K10's to K13's (ops, bytes) and the step's FP32
    operations, from the reference's pass over the traced views (the
    surfels as they stood when the window began)."""
    cfg = ctx.config
    rc = cfg["render"]
    scene = {k: v.to(ctx.device) for k, v in ctx.after_setup.items()}
    n = scene["means"].shape[0]
    coeffs = scene["sh"].shape[1]
    per_s = sum(int(np.prod(scene[k].shape[1:])) for k in FIELDS)
    works, ops = [], []
    for cam in _ref_cams(ctx, ctx.traced_views):
        tally = {}
        ref_surfels.render(scene, cam, rc, cfg["surfels"], tally=tally)
        works.append(roofline_surfels.work(tally, rc, n, coeffs))
        ops.append(roofline_surfels.step_ops(
            tally, rc, n, per_s, cfg["train"]["ssim_weight"], coeffs))
    out = {k: np.mean([w[k] for w in works], 0).tolist() for k in works[0]}
    out["ops"] = float(np.mean(ops))
    return out
