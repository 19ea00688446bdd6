"""The full 3DGS training protocol: the port of `scripts/train_protocol.py`,
with the same flags and defaults, plus `--device` (default cuda).

It runs the standard-protocol recipe end to end: 512x512 images (--size),
a 256k-slot capacity, 5000 steps, with every feature of the recipe on at
once: adaptive density control (split, clone, prune), one opacity reset,
the big-splat prune, progressive SH activation, position-lr decay,
(1 - w) L1 + w DSSIM, epoch-shuffled views, held-out-view PSNR evals, and
overflow_policy='raise' on static capacities sized from measurement. The
target is the heavy-tailed `realistic_scene` rendered from an orbit (24
training and 4 held-out views); the init is sfm-style: a subsample of the
target's positions with jitter and noisy DC colours.

    python -m gsplat_tpu_torch.train_protocol --steps 5000 --out-dir DIR
    python -m gsplat_tpu_torch.train_protocol --size 1024 --target-n 600000 \\
        --init-n 250000 --capacity 1000000 --batch 1 --out-dir DIR

It writes DIR/run_meta.json, metrics.csv, summary.json (the JAX script's
keys), target_v0.png, fitted_v0.png, fitted_holdout.png,
target_holdout.png, trained.ply and the checkpoints under DIR/ckpt, and
refuses a DIR that already holds a run. The scenes and the init's draws
come from torch generators seeded --seed on the CPU (the target's, the
init's, and the draws', seeded --seed, --seed + 1 and --seed + 2), moved
to the device: they differ from the JAX script's draws, not in
distribution. --trace-dir records a `torch.profiler` trace of steps
[--trace-at, --trace-at + 20) through `fit`.

Each block of the JAX script is a function here: `size_capacities`
(:40-78), `sized_plan` (:249-258), `protocol_init` (:150-228, on explicit
draws), `build` (:131-326) and `main` (:329-434).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene

# The capacity probe's config (scripts/train_protocol.py:237-243): the
# screen-radius clamp bounds every rect to (floor(144 / 16) + 2)^2 = 121 <=
# K_max 128 tiles by construction.
KMAX = 128
PROBE = dict(tile_size=16, max_intersections=1 << 20,
             max_tiles_per_gaussian=KMAX, block_size=16, max_per_tile=2048,
             binning="tiered", max_screen_radius=72.0,
             tier_spec=((4, 0), (8, 2), (16, 4), (32, 16), (64, 64)))
# The sized config's production mixed-precision path (:264-270).
SIZED = dict(pallas_block_size=256, stream_format="packed16",
             gather_backward="bf16", grad_readout="bf16",
             segment_sum="pallas", matmul_precision="high")
# graphdeco's inverse_sigmoid(0.1) init opacity.
INIT_OPACITY_LOGIT = -2.197


def size_capacities(scenes, cams, probe_cfg: RenderConfig, kmax: int):
    """Worst-case tier membership and intersection demand over scenes x
    cams: ({k_lo: members with more than k_lo post-cull tiles, for k_lo in
    4, 8, 16, 32}, the largest post-cull total, the largest raw rect area
    of a visible Gaussian). The post-cull counts size the tiers; the raw
    area sizes K_max (counts are truncated at K_max, so they cannot show a
    rect past it). `kmax` is the JAX function's argument; the probe
    config's K_max is the one walked."""
    from gsplat_tpu_torch.ops.binning import _rect_cull_mask
    from gsplat_tpu_torch.ops.projection import project_gaussians

    worst_members: dict = {}
    worst_total = 0
    worst_rect = 0
    for scene in scenes:
        for cam in cams:
            with torch.no_grad():
                proj = project_gaussians(scene, cam, probe_cfg)
                counts = _rect_cull_mask(proj, probe_cfg).sum(
                    dim=1, dtype=torch.int32)
                rect = proj.rect
                area = (torch.clamp_min(rect[:, 2] - rect[:, 0], 0)
                        * torch.clamp_min(rect[:, 3] - rect[:, 1], 0))
                max_rect = torch.where(proj.mask, area, 0).max()
            counts = counts.cpu().numpy()
            worst_rect = max(worst_rect, int(max_rect))
            worst_total = max(worst_total, int(counts.sum()))
            for k_lo in (4, 8, 16, 32):
                m = int((counts > k_lo).sum())
                worst_members[k_lo] = max(worst_members.get(k_lo, 0), m)
    return worst_members, worst_total, worst_rect


def sized_plan(members: dict, worst_total: int, n_cap: int):
    """(tier_spec, max_intersections) from the measured demand: each pool
    tier's budget 4x its membership plus 1024 rows (training moves splat
    scales faster than a static snapshot shows), n_cap // budget; the
    stream 2.5x the worst total, rounded up to a multiple of 2048."""
    spec = [(4, 0)]
    for k_lo, k_hi in ((4, 8), (8, 16), (16, 32), (32, 64)):
        budget = int(members[k_lo] * 4.0) + 1024
        spec.append((k_hi, max(1, n_cap // budget)))
    max_i = int(worst_total * 2.5)
    max_i += (-max_i) % 2048
    return spec, max_i


def protocol_init(base: GaussianScene, target: GaussianScene, sel, jitter,
                  dc_noise, radius: float, capacity: int,
                  init: str = "sfm",
                  max_log_scale: float | None = None) -> GaussianScene:
    """The protocol's init from `base` (a random scene of the init's size)
    and explicit draws: with init='sfm', positions target.means[sel] +
    jitter and DC colours target's DC[sel] + dc_noise (the graphdeco
    SfM-point-cloud analogue); with 'random', base's positions centred and
    scaled to the target's radius (radius / 2.5 per unit). Then, for both:
    nearest-neighbour-spacing scales log(radius / N^(1/3)) (capped at
    max_log_scale when given), opacity logit -2.197, the SH bands above DC
    zeroed, padded to `capacity`. sel (N,) int64, jitter (N, 3) and dc_noise
    (N, 1, 3) float32 are tensors on base's device."""
    n = base.num_gaussians
    means, sh = base.means, base.sh.clone()
    if init == "sfm":
        means = target.means[sel] + jitter
        sh[:, 0:1] = target.sh[sel, 0:1] + dc_noise
    else:
        means = (means - means.mean(0)) * (radius / 2.5)
    sh[:, 1:] = 0.0
    nn_spacing = radius / max(n, 1) ** (1.0 / 3.0)
    log_scales = torch.full_like(base.log_scales, math.log(nn_spacing))
    if max_log_scale is not None:
        log_scales = torch.clamp_max(log_scales, max_log_scale)
    return GaussianScene(
        means=means,
        log_scales=log_scales,
        quats=base.quats,
        opacity_logits=torch.full_like(base.opacity_logits,
                                       INIT_OPACITY_LOGIT),
        sh=sh,
    ).pad_to(capacity)


def init_draws(seed: int, target_n: int, init_n: int, radius: float,
               device) -> tuple:
    """(sel, jitter, dc_noise) of `protocol_init`: init_n distinct target
    indices, N(0, (0.01 radius)^2) jitter and N(0, 0.01) DC noise, drawn
    from a CPU generator seeded `seed` and moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    sel = torch.randperm(target_n, generator=gen)[:init_n]
    jitter = 0.01 * radius * torch.randn((init_n, 3), generator=gen)
    dc_noise = 0.1 * torch.randn((init_n, 1, 3), generator=gen)
    return sel.to(device), jitter.to(device), dc_noise.to(device)


def to_device(scene: GaussianScene, device) -> GaussianScene:
    return GaussianScene(**{f.name: getattr(scene, f.name).to(device)
                            for f in dataclasses.fields(scene)})


def centred_target(scene: GaussianScene):
    """(scene centred on its mean, the orbit radius: 2.5x the 90th
    percentile of the centred distances)."""
    scene = dataclasses.replace(scene,
                                means=scene.means - scene.means.mean(0))
    radius = 2.5 * float(np.percentile(np.linalg.norm(
        scene.means.cpu().numpy(), axis=-1), 90))
    return scene, radius


def parse_args(argv=None):
    ap = argparse.ArgumentParser("gsplat_tpu_torch.train_protocol")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--target-n", type=int, default=200_000)
    ap.add_argument("--init-n", type=int, default=120_000)
    ap.add_argument("--capacity", type=int, default=256_000)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--holdout", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    # lr 1e-2 puts make_optimizer's per-field rates at the graphdeco
    # values (opacity 0.05, scales 5e-3, rotation 1e-3, SH 2.5e-3).
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--lr-max-steps", type=int, default=None,
                    help="decay horizon (default: --steps); pin it when "
                    "running a shorter diagnostic of the full run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default="sfm", choices=["sfm", "random"],
                    help="'sfm': subsampled target positions + noisy DC "
                    "colours; 'random': structure-free ablation")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--opacity-reset-every", type=int, default=None,
                    help="override the min(3000, 3/5*steps) default")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint path to resume from (fresh --out-dir)")
    ap.add_argument("--retighten-capacity", type=float, default=1.3,
                    help="staged-capacity schedule of fit: once "
                    "densification ends, the step is rebuilt with "
                    "max_intersections at this x the measured peak "
                    "demand. 0 disables.")
    ap.add_argument("--trace-dir", default=None,
                    help="torch.profiler trace of steps "
                    "[trace-at, trace-at+20)")
    ap.add_argument("--trace-at", type=int, default=120)
    ap.add_argument("--out-dir", default="build/protocol")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args) -> dict:
    """The whole deterministic set-up (target scene, cameras, init, sized
    config, targets, the train / held-out split and eval_fn) without the
    fit."""
    from gsplat_tpu_torch.models.gaussians import random_scene, realistic_scene
    from gsplat_tpu_torch.ops.camera import orbit_cameras
    from gsplat_tpu_torch.render.pipeline import render
    from gsplat_tpu_torch.train.losses import psnr
    from gsplat_tpu_torch.utils.image import write_png

    dev = torch.device(args.device)
    s = args.size

    # Target: heavy-tailed capture statistics, centred for the orbit.
    target_scene, radius = centred_target(realistic_scene(
        args.target_n, generator=torch.Generator().manual_seed(args.seed),
        device="cpu"))
    # The protocol's own big-splat bound on the target: training prunes
    # splats with world scale > 0.05 radius (the 3DGS 5.2 rule), so a
    # target past it could not be fitted.
    max_log_scale = float(np.log(0.05 * radius))
    target_scene = to_device(dataclasses.replace(
        target_scene, log_scales=torch.clamp_max(target_scene.log_scales,
                                                 max_log_scale)), dev)
    total_views = args.views + args.holdout
    cams = orbit_cameras(np.zeros(3), radius, total_views, s, s,
                         fx=float(s), fy=float(s), device=dev)

    base = to_device(random_scene(
        args.init_n, sh_degree=3,
        generator=torch.Generator().manual_seed(args.seed + 1),
        device="cpu"), dev)
    sel, jitter, dc_noise = init_draws(args.seed + 2, args.target_n,
                                       args.init_n, radius, dev)
    init = protocol_init(base, target_scene, sel, jitter, dc_noise, radius,
                         args.capacity, args.init, max_log_scale)

    # Capacities sized from the measured membership of the target and the
    # init at every camera.
    probe_cfg = RenderConfig(width=s, height=s, **PROBE)
    members, worst_total, worst_rect = size_capacities(
        [target_scene, init], cams, probe_cfg, KMAX)
    if worst_rect > KMAX:
        raise ValueError(f"a rect of {worst_rect} tiles passes K_max {KMAX}")
    spec, max_i = sized_plan(members, worst_total, args.capacity)
    print(f"sized: members={members} worst_total={worst_total} "
          f"worst_rect={worst_rect} kmax={KMAX} "
          f"tier_spec={spec} max_intersections={max_i}", flush=True)
    cfg = dataclasses.replace(probe_cfg, max_intersections=max_i,
                              tier_spec=tuple(spec), **SIZED)

    with torch.no_grad():
        all_targets = torch.stack([render(target_scene, c, cfg).image
                                   for c in cams])
    idx = np.arange(total_views)
    hold_idx = (idx[:: total_views // args.holdout][: args.holdout]
                if args.holdout else idx[:0])
    train_idx = np.setdiff1d(idx, hold_idx)
    cameras = [cams[i] for i in train_idx]
    targets = all_targets[torch.as_tensor(train_idx, device=dev)]

    os.makedirs(args.out_dir, exist_ok=True)
    write_png(os.path.join(args.out_dir, "target_v0.png"),
              targets[0].cpu().numpy())

    def eval_render(scene_now, cam):
        with torch.no_grad():
            return render(scene_now, cam, cfg).image

    def eval_fn(scene_now, step):
        hold = [float(psnr(eval_render(scene_now, cams[i]), all_targets[i]))
                for i in hold_idx]
        tr = [float(psnr(eval_render(scene_now, cams[i]), all_targets[i]))
              for i in train_idx[:4]]
        with torch.no_grad():
            op = torch.sigmoid(scene_now.opacity_logits)
            alive = op > 1.0 / 255.0
            mx = torch.exp(scene_now.log_scales.amax(dim=-1))
            p99 = torch.quantile(torch.where(alive, mx, 0.0), 0.999)
            mean_op = torch.where(alive, op, 0.0).mean()
        return {
            "holdout_psnr": round(float(np.mean(hold)), 3),
            "train_psnr": round(float(np.mean(tr)), 3),
            "alive": int(alive.sum()),
            "mean_op": round(float(mean_op), 4),
            "p99_scale": round(float(p99), 4),
        }

    return dict(
        init=init, cameras=cameras, targets=targets, cfg=cfg, radius=radius,
        eval_fn=eval_fn, eval_render=eval_render, cams=cams,
        all_targets=all_targets, hold_idx=hold_idx, train_idx=train_idx,
        max_i=max_i, spec=spec, s=s,
    )


def fit_kwargs(args, radius: float) -> dict:
    """`fit`'s recipe, argument for argument as the JAX script's (:357-390)."""
    return dict(
        steps=args.steps, lr=args.lr, batch=args.batch, seed=args.seed,
        ssim_weight=0.2,
        log_every=args.log_every,
        overflow_policy="raise",
        densify_every=100,
        densify_from=500,  # graphdeco densify_from_iter
        # The uv-space trigger: graphdeco's 2e-4 on [-1, 1] NDC gradients
        # is 1e-4 in uv units.
        densify_grad_threshold=1e-4,
        densify_until=args.steps // 2,
        densify_max_scale=0.05 * radius,
        # One mid-run reset with room to recover.
        opacity_reset_every=args.opacity_reset_every
        if args.opacity_reset_every is not None
        else min(3000, (args.steps * 3) // 5),
        sh_warmup_every=1000,
        position_lr_final_ratio=0.01,
        lr_max_steps=args.lr_max_steps or args.steps,
        eval_every=args.eval_every,
        metrics_csv=os.path.join(args.out_dir, "metrics.csv"),
        checkpoint_every=args.checkpoint_every or args.steps // 2,
        retighten_capacity=args.retighten_capacity,
        resume=args.resume,
        checkpoint_dir=os.path.join(args.out_dir, "ckpt"),
        trace_dir=args.trace_dir,
        trace_steps=((args.trace_at, args.trace_at + 20)
                     if args.trace_dir else None),
    )


def main(argv=None) -> dict:
    """Run the protocol; returns the summary it writes."""
    from gsplat_tpu_torch.io.ply import save_ply
    from gsplat_tpu_torch.train.loop import fit
    from gsplat_tpu_torch.utils.bench import device_name
    from gsplat_tpu_torch.utils.image import write_png

    args = parse_args(argv)
    # One run per directory.
    metrics_path = os.path.join(args.out_dir, "metrics.csv")
    if os.path.exists(metrics_path):
        raise SystemExit(
            f"{metrics_path} already exists -- one run per directory; "
            "pick a fresh --out-dir (or delete the old run explicitly)")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "run_meta.json"), "w") as f:
        json.dump({"argv": list(sys.argv[1:] if argv is None else argv),
                   "args": vars(args),
                   "started_unix": round(time.time(), 1),
                   "devices": [device_name(args.device)]}, f, indent=1)

    b = build(args)
    cams, all_targets, hold_idx = b["cams"], b["all_targets"], b["hold_idx"]
    eval_fn, eval_render = b["eval_fn"], b["eval_render"]
    t0 = time.time()
    trained, metrics = fit(b["init"], b["cameras"], b["targets"], b["cfg"],
                           eval_fn=eval_fn, **fit_kwargs(args, b["radius"]))
    wall = time.time() - t0

    final = eval_fn(trained, args.steps)
    write_png(os.path.join(args.out_dir, "fitted_v0.png"),
              eval_render(trained, cams[0]).cpu().numpy())
    if len(hold_idx):
        h = int(hold_idx[0])
        write_png(os.path.join(args.out_dir, "fitted_holdout.png"),
                  eval_render(trained, cams[h]).cpu().numpy())
        write_png(os.path.join(args.out_dir, "target_holdout.png"),
                  all_targets[h].cpu().numpy())
    save_ply(trained, os.path.join(args.out_dir, "trained.ply"))
    alive = int((torch.sigmoid(trained.opacity_logits) > 1.0 / 255.0).sum())
    # A resumed run's wall time covers only [resumed_step, steps).
    resumed_step = 0
    if args.resume:
        from gsplat_tpu_torch.utils.checkpoint import checkpoint_step

        resumed_step = checkpoint_step(args.resume)
    steps_run = args.steps - resumed_step
    summary = {
        "steps": args.steps,
        "resumed_from_step": resumed_step,
        "steps_this_segment": steps_run,
        "resolution": f"{b['s']}x{b['s']}",
        "capacity": args.capacity,
        "alive_final": alive,
        "wall_s": round(wall, 1),
        "it_per_s_overall": round(steps_run / max(wall, 1e-9), 2),
        **final,
        "max_intersections": b["max_i"],
        "tier_spec": b["spec"],
    }
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
