"""The one generator of the benchmark's inputs: it reads a traffic file
(`splatbench/traffic/<name>.json`) and a configuration file
(`splatbench/configs/<name>.json`) and makes, from `--seed`, the scene,
the poses, their order and the training targets.

Every stream of random numbers is its own, seeded from (seed, tag), so
that the scene of a seed does not depend on how many targets were drawn.
A seed changes the values, not the amount of work: the set of poses is
fixed by the traffic file, and the seed picks their order (a shuffle per
epoch for training, a start and a direction on the path for serving).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from splatbench import frozen


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for the stream `tag` of `seed` (any whole
    number, however large)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        derive(seed, tag))


def make_scene(config: dict, seed: int, device) -> dict:
    """The configuration's scene (`config["scene"]`: kind, num_gaussians,
    sh_degree, log_scale_shift) drawn on `device` from the seed."""
    sc = config["scene"]
    scene = frozen.SCENES[sc["kind"]](
        sc["num_gaussians"], sc["sh_degree"], generator(seed, "scene", device),
        device)
    if sc.get("log_scale_shift", 0.0):
        scene["log_scales"] = scene["log_scales"] + sc["log_scale_shift"]
    return scene


def pose_offsets(poses: dict) -> np.ndarray:
    """(V, 2) offsets of the eyes in the default camera's (right, down)
    plane, as fractions of poses["radius"]: a golden-angle disk
    ("layout": "disk") or a circle ("layout": "circle")."""
    n = poses["count"]
    i = np.arange(n, dtype=np.float64)
    if poses["layout"] == "disk":
        rho = np.sqrt((i + 0.5) / n)
        theta = i * math.pi * (3.0 - math.sqrt(5.0))
    elif poses["layout"] == "circle":
        rho = np.ones(n)
        theta = 2.0 * math.pi * i / n
    else:
        raise ValueError(f"unknown pose layout {poses['layout']!r}")
    return np.stack([rho * np.cos(theta), rho * np.sin(theta)], 1)


def view_matrices(poses: dict) -> list:
    """The traffic's poses as (4, 4) float32 view matrices: the default
    pose's eye moved by radius x o in its (right, down) plane, o the
    layout's offset plus poses["center"] ((0, 0) when absent; in units of
    the radius), looking along its forward axis turned by turn x o, up as
    the default's."""
    rows = frozen.default_view().astype(np.float64)
    right, down, fwd = rows[0, :3], rows[1, :3], rows[2, :3]
    eye = -rows[:3, :3].T @ rows[:3, 3]
    views = []
    cx, cy = poses.get("center", (0.0, 0.0))
    for ox, oy in pose_offsets(poses) + np.array([cx, cy]):
        d = ox * right + oy * down
        e = eye + poses["radius"] * d
        views.append(frozen.look_at(e, e + fwd + poses["turn"] * d,
                                    up=-down))
    return views


def epoch_orders(seed: int, count: int, epochs: int) -> np.ndarray:
    """(epochs, count) view orders, each epoch shuffled anew."""
    rng = np.random.default_rng(derive(seed, "order"))
    return np.stack([rng.permutation(count) for _ in range(epochs)])


def path_order(seed: int, count: int, length: int) -> np.ndarray:
    """`length` pose indices along the closed path: from a start and in a
    direction drawn from the seed, one step a frame."""
    rng = np.random.default_rng(derive(seed, "path"))
    start = int(rng.integers(count))
    step = 1 if rng.integers(2) else -1
    return (start + step * np.arange(length)) % count


def sample_indices(seed: int, spans: list) -> list:
    """One index drawn from the seed in each [lo, hi) of `spans`."""
    rng = np.random.default_rng(derive(seed, "sample"))
    return [int(rng.integers(lo, hi)) for lo, hi in spans]


# Targets upsampled at a time: bounds the upsampling's temporary memory.
TARGET_CHUNK = 8


def make_targets(targets: dict, count: int, height: int, width: int,
                 seed: int, device, views=None) -> torch.Tensor:
    """(count, H, W, 3) float32 smooth colour fields, made on the device:
    a (count, 3, gh, gw) grid of uniform values in [lo, hi], upsampled
    bilinearly. `views`, when given, makes only those rows (the same
    values as in the full set)."""
    gh, gw = targets["grid"]
    lo, hi = targets["range"]
    gen = generator(seed, "targets", device)
    grid = torch.rand((count, 3, gh, gw), generator=gen, device=device,
                      dtype=torch.float32) * (hi - lo) + lo
    if views is not None:
        grid = grid[torch.as_tensor(list(views), device=device)]
    out = torch.empty((grid.shape[0], height, width, 3), device=device,
                      dtype=torch.float32)
    for i in range(0, grid.shape[0], TARGET_CHUNK):
        g = grid[i:i + TARGET_CHUNK]
        up = torch.nn.functional.interpolate(
            g, size=(height, width), mode="bilinear", align_corners=True)
        out[i:i + g.shape[0]] = up.permute(0, 2, 3, 1)
    return out
