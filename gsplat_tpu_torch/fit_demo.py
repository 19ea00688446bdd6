"""Self-contained training demo: the port of `examples/fit_demo.py`. Fits
a fresh Gaussian scene to orbit renders of a synthetic target, with
adaptive density control, and writes target / initial / fitted PNGs and a
metrics CSV:

    python -m gsplat_tpu_torch.fit_demo --steps 800 --out-dir DIR \\
        [--fast] [--stream-format f32|packed16|packed4] [--device cuda|cpu]

The same flags, config (256x256, tile 16, packed binning, K_max 96, 2^17
intersections) and recipe (lr 2e-2, batch 2, densification every 100
steps at 5e-5, the big-splat prune) as the JAX demo, plus --device
(default cuda). --fast is the mixed-precision path of the bench's default:
bf16-pair gradients summed by K5. The scenes are drawn from torch
generators seeded 0 (target) and 1 (init) on the CPU, moved to the device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser("gsplat_tpu_torch.fit_demo")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out-dir", default="build/demo")
    ap.add_argument("--fast", action="store_true",
                    help="the mixed-precision path: bf16-pair gradients "
                    "summed by K5 (the bench default)")
    ap.add_argument("--stream-format", default="f32",
                    choices=["f32", "packed16", "packed4"])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the view-0 PSNR of the initial and the fitted
    scene and the fit's metrics rows."""
    from gsplat_tpu_torch.config import RenderConfig
    from gsplat_tpu_torch.models.gaussians import random_scene
    from gsplat_tpu_torch.ops.camera import orbit_cameras
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.train import loop
    from gsplat_tpu_torch.train.losses import psnr
    from gsplat_tpu_torch.train_protocol import centred_target, to_device
    from gsplat_tpu_torch.utils.image import write_png

    args = parse_args(argv)
    dev = torch.device(args.device)
    s = args.size
    cfg = RenderConfig(
        width=s, height=s, tile_size=16, max_intersections=1 << 17,
        max_tiles_per_gaussian=96, block_size=16, max_per_tile=1024,
        binning="packed",
        stream_format=args.stream_format,
        **(dict(gather_backward="bf16", grad_readout="bf16",
                segment_sum="pallas") if args.fast else {}),
    )
    # The target centred at the origin, so that the orbit sees it from
    # every view.
    target, radius = centred_target(random_scene(
        args.n, sh_degree=2, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    target = to_device(target, dev)
    cams = orbit_cameras(np.zeros(3), radius, args.views, s, s, fx=float(s),
                         fy=float(s), device=dev)
    targets = torch.stack([render_jit(target, c, cfg).image for c in cams])

    init = to_device(random_scene(
        args.n, sh_degree=2, generator=torch.Generator().manual_seed(1),
        device="cpu"), dev)
    init.means = (init.means - init.means.mean(0)) * 1.2
    init = init.pad_to(2 * args.n)

    os.makedirs(args.out_dir, exist_ok=True)
    write_png(os.path.join(args.out_dir, "target.png"),
              targets[0].cpu().numpy())
    initial = render_jit(init, cams[0], cfg).image
    write_png(os.path.join(args.out_dir, "initial.png"),
              initial.cpu().numpy())

    trained, metrics = loop.fit(
        init, cams, targets, cfg,
        steps=args.steps, lr=2e-2, batch=2, log_every=50,
        densify_every=100, densify_grad_threshold=5e-5,
        # The 3DGS 5.2 big-splat prune: without it, repeated splits can
        # grow a few splats past K_max's tile rect.
        densify_max_scale=0.05 * radius,
        metrics_csv=os.path.join(args.out_dir, "metrics.csv"),
    )
    fitted = render_jit(trained, cams[0], cfg).image
    write_png(os.path.join(args.out_dir, "fitted.png"), fitted.cpu().numpy())
    p = float(psnr(fitted, targets[0]))
    print(f"view-0 PSNR after {args.steps} steps: {p:.2f} dB")
    print(f"outputs in {args.out_dir}/")
    return {"psnr": p, "initial_psnr": float(psnr(initial, targets[0])),
            "metrics": metrics}


if __name__ == "__main__":
    main()
