"""Capacity report for a scene: tier-pool occupancy, post-cull intersection
totals, K_max pressure and suggested capacities over a set of cameras (the
worst camera governs the static budgets). The port of
`scripts/scene_report.py`, with the same flags and JSON, plus `--device`
(default cuda; `--device cpu` where the JAX script takes `--cpu`) and the
jumbo tiers (`--max-tiles-jumbo`, `--jumbo-tier-spec`), whose budgets the
report then includes:

    python -m gsplat_tpu_torch.scene_report --scene realistic --n 1000000 \\
        --width 1920 --height 1080 --tile-size 32 --orbit 8
    python -m gsplat_tpu_torch.scene_report --ply scene.ply ...

The cameras are `Camera.default` and, with --orbit N > 1, N orbit cameras
at radius 4 around the scene's mean. Each camera's report goes to stderr,
the worst camera's (the most intersections) to stdout. The synthetic
scenes are drawn from a torch generator seeded --seed on the device, as
the bench draws its scene, so they differ from the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gsplat_tpu_torch.config import RenderConfig, parse_tier_spec
from gsplat_tpu_torch.ops.binning import tier_occupancy
from gsplat_tpu_torch.ops.camera import Camera, orbit_cameras
from gsplat_tpu_torch.ops.projection import project_gaussians


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("gsplat_tpu_torch.scene_report")
    ap.add_argument("--scene", default="realistic",
                    choices=["realistic", "random"])
    ap.add_argument("--ply", help="report on a real capture instead")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile-size", type=int, default=32)
    ap.add_argument("--kmax", type=int, default=64)
    ap.add_argument("--tier-spec", default="8,5,64")
    ap.add_argument("--orbit", type=int, default=4,
                    help="number of orbit cameras (worst case reported)")
    ap.add_argument("--max-intersections", type=int, default=1 << 23)
    ap.add_argument("--max-tiles-jumbo", type=int, default=0)
    ap.add_argument("--jumbo-tier-spec", default="",
                    help="e.g. '128:14848,256:7168,512:3072'")
    ap.add_argument("--device", default="cuda")
    return ap


def load_scene(args, device):
    """The --ply scene, or the synthetic one at --n, SH degree 3."""
    if args.ply:
        from gsplat_tpu_torch.io.ply import load_ply

        return load_ply(args.ply, device=device)
    from gsplat_tpu_torch.models.gaussians import random_scene, realistic_scene

    make = realistic_scene if args.scene == "realistic" else random_scene
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return make(args.n, sh_degree=3, generator=gen, device=device)


def report(scene, cfg: RenderConfig, cams) -> list:
    """`tier_occupancy` of the scene at each camera, with its index."""
    reps = []
    for i, cam in enumerate(cams):
        with torch.no_grad():
            rep = tier_occupancy(project_gaussians(scene, cam, cfg), cfg)
        rep["camera"] = i
        reps.append(rep)
    return reps


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        tile_size=args.tile_size,
        max_intersections=args.max_intersections,
        max_tiles_per_gaussian=args.kmax,
        block_size=32,
        max_per_tile=8192,
        binning="tiered",
        tier_spec=parse_tier_spec(args.tier_spec),
        max_tiles_jumbo=args.max_tiles_jumbo,
        jumbo_tier_spec=(parse_tier_spec(args.jumbo_tier_spec)
                         if args.jumbo_tier_spec else ()),
    )
    scene = load_scene(args, device)
    cams = [Camera.default(cfg.width, cfg.height, device=device)]
    if args.orbit > 1:
        center = scene.means.detach().cpu().numpy().mean(0)
        cams += orbit_cameras(
            center, radius=4.0, num=args.orbit, width=cfg.width,
            height=cfg.height, fx=float(cfg.width), fy=float(cfg.height),
            device=device)
    worst = None
    for rep in report(scene, cfg, cams):
        print(json.dumps(rep), file=sys.stderr)
        if worst is None or rep["num_intersections"] > \
                worst["num_intersections"]:
            worst = rep
    worst["scene"] = args.ply or f"{args.scene}({args.n})"
    worst["worst_of_cameras"] = len(cams)
    print(json.dumps(worst, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
