"""The inputs Feature 3DGS adds to a training cell, made from `--seed` on
the device: each Gaussian's feature row, the 1x1 decoder, and the
teachers' feature maps. Every stream is its own (`gen.generator(seed,
tag)`), so the scene of a seed is `gen.make_scene`'s whatever is drawn
here.

- features: (N, C) float32, N(0, init_std^2);
- decoder: weight (D, C) and bias (D,), each uniform within 1 / sqrt(C),
  torch's default 1x1 convolution;
- teachers: (V, D, h, w) bfloat16, one per view: a (gh, gw) grid of unit
  D-vectors drawn N(0, 1) and normalised (as CLIP embeddings are),
  upsampled bilinearly (corners aligned) to the teacher's size (h, w).
"""

from __future__ import annotations

import math

import torch

from splatbench import gen

# Views' teacher maps upsampled at a time: bounds the upsampling's
# temporary memory (8 float32 maps of 512 x 270 x 480, 2.1 GB).
TEACHER_CHUNK = 8


def make_feature_fields(config: dict, n: int, seed: int, device) -> dict:
    """The feature table and the decoder of the configuration's
    `features` section for n Gaussians."""
    fc = config["features"]
    c, d = fc["channels"], fc["decoder_out"]
    kw = dict(device=device, dtype=torch.float32)
    g = gen.generator(seed, "features", device)
    features = fc["init_std"] * torch.randn((n, c), generator=g, **kw)
    g = gen.generator(seed, "decoder", device)
    bound = 1.0 / math.sqrt(c)
    weight = (torch.rand((d, c), generator=g, **kw) * 2.0 - 1.0) * bound
    bias = (torch.rand((d,), generator=g, **kw) * 2.0 - 1.0) * bound
    return dict(features=features, decoder_weight=weight, decoder_bias=bias)


def make_teachers(teachers: dict, count: int, config: dict, seed: int,
                  device, views=None) -> torch.Tensor:
    """(count, D, h, w) bfloat16 teacher maps; `views`, when given, makes
    only those rows (the same values as in the full set)."""
    gh, gw = teachers["grid"]
    fc = config["features"]
    d = fc["decoder_out"]
    h, w = fc["teacher_hw"]
    g = gen.generator(seed, "teachers", device)
    grid = torch.randn((count, d, gh, gw), generator=g, device=device,
                       dtype=torch.float32)
    grid = grid / torch.linalg.vector_norm(grid, dim=1, keepdim=True)
    if views is not None:
        grid = grid[torch.as_tensor(list(views), device=device)]
    out = torch.empty((grid.shape[0], d, h, w), device=device,
                      dtype=torch.bfloat16)
    for i in range(0, grid.shape[0], TEACHER_CHUNK):
        part = grid[i:i + TEACHER_CHUNK]
        out[i:i + part.shape[0]] = torch.nn.functional.interpolate(
            part, size=(h, w), mode="bilinear", align_corners=True)
    return out
