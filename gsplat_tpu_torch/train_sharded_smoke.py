"""Tile-sharded training-protocol smoke: the port of
`scripts/train_sharded_smoke.py`, at its shape (128x128, 350 steps, a
6000-Gaussian target, a 3000-Gaussian init in 12,000 slots, 10 orbit
views).

A fit of several hundred steps through the tile-sharded train step
(`fit(mesh=...)`) with the protocol's features on: adaptive density
control, SH warm-up, evals, overflow_policy='raise', on a ('data',
'tiles') mesh of --data x --tiles ranks, one process per rank started by
`parallel.multihost.launch`. The workload is the protocol recipe
(`gsplat_tpu_torch.train_protocol`) scaled down: self-distillation of a
centred random target from an orbit, its sfm-style init
(`protocol_init`: subsampled target positions with jitter, noisy DC,
nearest-neighbour-spacing scales, opacity 0.1).

    python -m gsplat_tpu_torch.train_sharded_smoke --dist-backend gloo \\
        --device cuda:0                          # 2 x 2 ranks on one card
    python -m gsplat_tpu_torch.train_sharded_smoke --dist-backend nccl \\
        --device cuda                            # one card per rank
    python -m gsplat_tpu_torch.train_sharded_smoke --dist-backend gloo \\
        --device cpu --data 1 --tiles 2 --steps 4 --size 32

The backend is the caller's: NCCL with one card per rank (--device cuda:
rank r takes cuda:r), gloo for ranks sharing one card (--device cuda:0) or
on the CPU. The JAX script runs a (2, 4) mesh of virtual CPU devices; here
the mesh is data 2 x tiles 2 unless --data and --tiles say otherwise.
Rank 0 writes OUT_DIR/metrics.csv and summary.json (the JAX keys).
Asserts, as the JAX script's: the loss descends, the final train PSNR is
above the first eval's and the scene stays alive; and more Gaussians alive
at the end than the init had, which only a densify round that split or
cloned can make (the schedule runs 3 rounds at the defaults: steps 100, 150
and 200). The fit itself raises on an overflow or a non-finite gradient.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import RenderConfig

# The JAX script's config (impl='jnp' there).
CFG = dict(tile_size=16, max_intersections=1 << 15, max_tiles_per_gaussian=64,
           block_size=16, max_per_tile=1024, binning="tiered",
           tier_spec=((4, 0), (8, 1), (16, 1), (32, 4)))
# Seconds the ranks may take: the JAX script's run took 1364 s on a CPU.
TIMEOUT_S = 3600


def parse_args(argv=None):
    ap = argparse.ArgumentParser("gsplat_tpu_torch.train_sharded_smoke")
    ap.add_argument("--steps", type=int, default=350)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--target-n", type=int, default=6000)
    ap.add_argument("--init-n", type=int, default=3000)
    ap.add_argument("--capacity", type=int, default=12_000)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--out-dir", default="build/sharded_smoke")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--tiles", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", required=True, choices=["nccl", "gloo"])
    return ap.parse_args(argv)


def setup(args, device) -> dict:
    """Target, cameras, targets, init and eval_fn; the same on every rank
    (the draws come from CPU generators seeded 0, 1 and 2)."""
    from gsplat_tpu_torch.models.gaussians import random_scene
    from gsplat_tpu_torch.ops.camera import orbit_cameras
    from gsplat_tpu_torch.render.pipeline import render
    from gsplat_tpu_torch.train.losses import psnr
    from gsplat_tpu_torch.train_protocol import (
        centred_target,
        init_draws,
        protocol_init,
        to_device,
    )

    s = args.size
    cfg = RenderConfig(width=s, height=s, **CFG)
    target, radius = centred_target(random_scene(
        args.target_n, sh_degree=2, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    target = to_device(target, device)
    total = args.views
    cams = orbit_cameras(np.zeros(3), radius, total, s, s, fx=float(s),
                         fy=float(s), device=device)
    with torch.no_grad():
        targets = torch.stack([render(target, c, cfg).image for c in cams])
    base = to_device(random_scene(
        args.init_n, sh_degree=2, generator=torch.Generator().manual_seed(1),
        device="cpu"), device)
    init = protocol_init(base, target, *init_draws(
        2, args.target_n, args.init_n, radius, device), radius,
        args.capacity)
    eval_views = [0, total // 2]

    def eval_fn(scene_now, step):
        with torch.no_grad():
            ps = [float(psnr(render(scene_now, cams[i], cfg).image,
                             targets[i])) for i in eval_views]
            alive = int((torch.sigmoid(scene_now.opacity_logits)
                         > 1 / 255.0).sum())
        return {"train_psnr": round(float(np.mean(ps)), 3), "alive": alive}

    return dict(cfg=cfg, cams=cams, targets=targets, init=init,
                radius=radius, eval_fn=eval_fn)


def rank_main(rank: int, args) -> dict | None:
    """One rank of the smoke: the fit on the mesh; rank 0 returns the
    summary (and writes it), the other ranks None."""
    from gsplat_tpu_torch.parallel.multihost import rank_device
    from gsplat_tpu_torch.parallel.sharding import make_mesh
    from gsplat_tpu_torch.train.loop import fit

    device = rank_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank)  # one card per rank
    if device.type == "cuda":
        torch.cuda.set_device(device)
    b = setup(args, device)
    mesh = make_mesh({"data": args.data, "tiles": args.tiles}, device)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    trained, metrics = fit(
        b["init"], b["cams"], b["targets"], b["cfg"],
        steps=args.steps, lr=1e-2, batch=2, seed=0,
        ssim_weight=0.2,
        log_every=25,
        overflow_policy="raise",
        densify_every=50,
        densify_from=100,
        densify_until=args.steps * 3 // 5,
        densify_grad_threshold=1e-4,
        densify_max_scale=0.05 * b["radius"],
        opacity_reset_every=0,  # short horizon: no room to recover
        sh_warmup_every=100,
        eval_every=50,
        eval_fn=b["eval_fn"],
        metrics_csv=os.path.join(args.out_dir, "metrics.csv"),
        mesh=mesh,
    )
    wall = time.time() - t0
    if rank != 0:
        return None
    first = next(m for m in metrics if "train_psnr" in m)
    last = metrics[-1]
    summary = {
        "mesh": {"data": args.data, "tiles": args.tiles},
        "steps": args.steps,
        "resolution": f"{args.size}x{args.size}",
        "capacity": args.capacity,
        "wall_s": round(wall, 1),
        "loss_first": metrics[0]["loss"],
        "loss_last": last["loss"],
        "psnr_first": first["train_psnr"],
        "psnr_last": last.get("train_psnr"),
        "alive_last": last.get("alive"),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def check(summary: dict, init_n: int) -> None:
    """The JAX script's asserts, and that densification split or cloned:
    only a split or a clone adds a live Gaussian to the init's init_n, so
    more alive at the end than init_n means some round added some."""
    assert summary["loss_last"] < summary["loss_first"], \
        "loss did not descend"
    assert (summary["psnr_last"] or 0) > summary["psnr_first"], \
        "PSNR regressed"
    assert (summary["alive_last"] or 0) > init_n // 2, "scene collapsed"
    assert (summary["alive_last"] or 0) > init_n, \
        "no densify round split or cloned"


def main(argv=None) -> dict:
    from gsplat_tpu_torch.parallel import multihost
    # By its module's name, so that the spawned ranks can import it also
    # when this module runs as __main__.
    from gsplat_tpu_torch.train_sharded_smoke import rank_main

    args = parse_args(argv)
    results = multihost.launch(
        rank_main, args.data * args.tiles, (args,), backend=args.dist_backend,
        out_dir=os.path.join(args.out_dir, "ranks"),
        device=args.device if args.device != "cuda" else None,
        timeout_s=TIMEOUT_S)
    summary = results[0]
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    check(main(), parse_args().init_n)
    print("sharded smoke OK")
