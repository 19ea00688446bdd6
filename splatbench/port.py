"""What the benchmark takes from the program under test, `gsplat_tpu_torch`:
its configuration, scene and camera types, built from the benchmark's own
inputs. The traffic kinds (`splatbench/kinds/`) drive the program through
these; nothing else of the benchmark imports the program.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from gsplat_tpu_torch.config import RenderConfig
from gsplat_tpu_torch.models.gaussians import GaussianScene
from gsplat_tpu_torch.ops.camera import Camera

from splatbench import frozen


def tuples(x):
    """JSON lists as tuples, nested (the config's tier ladders)."""
    if isinstance(x, list):
        return tuple(tuples(v) for v in x)
    return x


def render_config(rc: dict) -> RenderConfig:
    """The program's RenderConfig of the configuration file's `render`
    section; a key the program does not know is refused."""
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = sorted(set(rc) - fields)
    if unknown:
        raise ValueError(f"render keys the program does not take: {unknown}")
    return RenderConfig(**{k: tuples(v) for k, v in rc.items()})


def scene(fields: dict) -> GaussianScene:
    return GaussianScene(**{k: fields[k] for k in frozen.SCENE_FIELDS})


def camera(view, width: int, height: int, device) -> Camera:
    """A pose with the default pose's intrinsics (focal W, H px)."""
    return Camera.create(view, width, height, fx=float(width),
                         fy=float(height), znear=frozen.DEFAULT_ZNEAR,
                         zfar=frozen.DEFAULT_ZFAR, device=device)


def release(device) -> None:
    """Return the memory of dropped program state to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
