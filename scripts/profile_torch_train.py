#!/usr/bin/env python3
"""Where the time of one training step goes on a CUDA card (PyTorch port).

    python3 scripts/profile_torch_train.py [--scene random|realistic]
        [--out F]

Runs the training main path of chip_smoke.py (the exact-gradient step, L1 +
0.2 DSSIM and Adam, on the 1M-Gaussian SH-3 random scene at 1920x1080, the
bench config with the f32 stream, one of the four views per step) as users
run it: `make_train_step`, one CUDA graph replayed per step. --scene
realistic takes the 1M-Gaussian realistic scene with the jumbo ladder of
bench.py:246-253 (chip_smoke.JUMBO) instead. It reports
`profile_torch_render.replay_row`'s numbers for the step: device and wall
ms per step (medians over REPS rounds of the views, after a warm-up
round), and from one profiled round the busy share, the kernels by name,
and from the program's record of the replays the card's ms per step in
each stage of `train.loop.TRAIN_SPANS` and `render.pipeline.STAGES` and in
the backward's stages (`render.blend.backward`: the blend's and the
gather's backward; `render.project.backward`: the SH and projection
backward), the copies, and the gaps by the host span they lie in.
With --out, writes the same numbers as JSON to that file.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the main path's config, views and trainer)

sys.path.insert(0, os.path.join(HERE, "scripts"))
import profile_torch_render  # noqa: E402  (the replay row)

def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("random", "realistic"),
                    default="random")
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    from gsplat_tpu_torch import RenderConfig, random_scene, realistic_scene
    from gsplat_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    _build.build_all()
    realistic = args.scene == "realistic"
    cfg = RenderConfig(**dict(chip_smoke.BENCH, **chip_smoke.EXACT,
                              **(chip_smoke.JUMBO if realistic else {})))
    scene = (realistic_scene if realistic else random_scene)(
        chip_smoke.NUM_GAUSSIANS, sh_degree=3,
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"[config] the {args.scene} scene: {cfg}", flush=True)
    cams = chip_smoke.views(cfg.width, cfg.height, dev)
    train, targets, step = chip_smoke.make_trainer(scene, cams, cfg, dev)
    replay = profile_torch_render.replay_row(
        lambda v: step(train, [cams[v]], targets[v:v + 1]), len(cams))
    profile_torch_render.print_row(f"make_train_step on {card}", replay, 20)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, replay=replay), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
