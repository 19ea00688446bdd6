"""cameras.json loader in the graphdeco format (port of
`gsplat_tpu.io.cameras`): a list of {id, img_name, width, height, position
(3,), rotation (3x3 nested), fx, fy}. The view matrix is
`view @ x = R (x - t)` (`Camera.from_rt`); each camera's own fx, fy, width
and height are honoured, with optional overrides that rescale the focal
lengths.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gsplat_tpu_torch.ops.camera import Camera


def load_cameras(
    path_or_str,
    znear: float = 0.2,
    zfar: float = 100.0,
    width_override: int | None = None,
    height_override: int | None = None,
    device="cuda",
):
    """Returns a list of (name, Camera) with the cameras' tensors on
    `device`. `path_or_str` is a path, or the JSON text itself."""
    if isinstance(path_or_str, (str, os.PathLike)) and os.path.exists(path_or_str):
        with open(path_or_str) as f:
            raw = json.load(f)
    else:
        raw = json.loads(path_or_str)

    cams = []
    for entry in raw:
        width = width_override or int(entry["width"])
        height = height_override or int(entry["height"])
        fx = float(entry["fx"])
        fy = float(entry["fy"])
        if width_override:
            fx *= width_override / int(entry["width"])
        if height_override:
            fy *= height_override / int(entry["height"])
        cam = Camera.from_rt(
            np.asarray(entry["rotation"], np.float32),
            np.asarray(entry["position"], np.float32),
            width,
            height,
            fx,
            fy,
            znear=znear,
            zfar=zfar,
            device=device,
        )
        cams.append((entry.get("img_name", str(entry.get("id", len(cams)))), cam))
    return cams
