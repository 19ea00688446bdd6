"""gsplat_tpu_torch: the PyTorch/CUDA port of gsplat_tpu for NVIDIA Hopper.

Same layout as `gsplat_tpu`. Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA C++ kernels for sm_90a in `csrc/`, built on first use
(`ops/cuda/_build.py`). Entry points default to `device="cuda"`; a kernel
wrapper runs its plain PyTorch version only for a CPU tensor.

Ported so far: the forward render (projection, SH, tiered binning with
the jumbo tiers through the cull kernel K3, gather, per-tile blend kernel
K1 on the float32 or the packed16/packed4 stream) and the single-device
training step (`train.loop.make_train_step`: the blend backward K2, the
gather's sort-based backward with the segmented-suffix-sum kernels K4 and,
over bf16 pairs, K5, L1 + DSSIM, Adam), with `random_scene` and the
heavy-tailed `realistic_scene`; and the single-device user surface on top:
`train.loop.fit` with densification (`train/densify.py`) and checkpoints
(`utils/checkpoint.py`), PLY, cameras.json and PNG I/O (`io/`,
`utils/image.py`), `utils.bench.run_bench`, and the command line
(`python -m gsplat_tpu_torch.cli`, `python -m gsplat_tpu_torch.bench`);
and the multi-device modes on `torch.distributed`, one process per rank
(`parallel/`): the tile-sharded render, train step and `fit(mesh=...)`,
and the Gaussian-sharded render, training and per-shard checkpoints; and
the tools around the package, each runnable with `python -m`: `bench`,
`scene_report`, `train_protocol`, `train_sharded_smoke` and `fit_demo`.

As the JAX package dispatches a frame and a step each as one jitted
program, the port replays CUDA graphs (`utils/graphs.py`): `render_jit`,
`render.pipeline.render_loss_and_grad` and the step of
`train.loop.make_train_step`, captured once per static configuration and
input shapes; `render` is the eager function they capture.
"""

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import (
    GaussianScene,
    random_scene,
    realistic_scene,
)
from gsplat_tpu_torch.ops.camera import Camera
from gsplat_tpu_torch.render.pipeline import RenderOutput, render, render_jit

__all__ = [
    "Camera",
    "GaussianScene",
    "RenderConfig",
    "RenderOutput",
    "random_scene",
    "realistic_scene",
    "render",
    "render_jit",
]
