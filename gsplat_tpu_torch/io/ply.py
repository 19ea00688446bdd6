"""PLY scene IO in the graphdeco 3DGS format (port of `gsplat_tpu.io.ply`).

The same format rules as the JAX module: a binary_little_endian header
scanned to ``end_header``; vertex properties x/y/z, f_dc_0..2, f_rest_*,
opacity (logit), scale_0..2 (log), rot_0..3 (w, x, y, z); the SH degree
from the number of f_rest_* properties; f_rest channel-major; float and
uchar properties, uchar divided by 255. The vertex block is parsed with one
numpy structured-dtype view and moved to the device in one copy per field.
"""

from __future__ import annotations

import io
import math
import os

import numpy as np
import torch

from gsplat_tpu_torch.models.gaussians import GaussianScene

_PLY_TYPES = {
    "float": ("<f4", 4),
    "float32": ("<f4", 4),
    "double": ("<f8", 8),
    "uchar": ("u1", 1),
    "uint8": ("u1", 1),
    "int": ("<i4", 4),
    "uint": ("<u4", 4),
    "short": ("<i2", 2),
    "ushort": ("<u2", 2),
}


def _decode_header(data: bytes):
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header")
    # Skip past 'end_header' and its newline.
    body_offset = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines()]
    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file: missing magic")
    fmt = next((ln for ln in lines if ln.startswith("format")), "")
    if "binary_little_endian" not in fmt:
        raise ValueError(f"unsupported PLY format: {fmt!r} (need binary_little_endian)")
    vertex_count = 0
    props: list[tuple[str, str]] = []  # (name, type)
    in_vertex = False
    for ln in lines:
        if ln.startswith("element"):
            parts = ln.split()
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                vertex_count = int(parts[2])
        elif ln.startswith("property") and in_vertex:
            _, ptype, pname = ln.split()[:3]
            if ptype == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((pname, ptype))
    return vertex_count, props, body_offset


def load_ply(path_or_bytes, device="cuda") -> GaussianScene:
    """Load a 3DGS PLY (a path, or its bytes) into a GaussianScene of
    float32 tensors on `device`."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = bytes(path_or_bytes)

    n, props, off = _decode_header(data)
    dtype = np.dtype([(name, _PLY_TYPES[t][0]) for name, t in props])
    rec = np.frombuffer(data, dtype=dtype, count=n, offset=off)

    def col(name, scale=1.0):
        arr = rec[name].astype(np.float32)
        t = dict(props)[name]
        if t in ("uchar", "uint8"):
            arr = arr / 255.0  # reference: ply.ts:117
        return arr * scale

    names = {name for name, _ in props}
    required = {"x", "y", "z", "opacity", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3", "f_dc_0", "f_dc_1", "f_dc_2"}
    missing = required - names
    if missing:
        raise ValueError(f"PLY missing 3DGS properties: {sorted(missing)}")

    n_rest = sum(1 for name in names if name.startswith("f_rest_"))
    n_per_color = n_rest // 3
    degree = int(round(math.sqrt(n_per_color + 1))) - 1
    if (degree + 1) ** 2 - 1 != n_per_color:
        raise ValueError(f"f_rest count {n_rest} is not a valid SH layout")
    k = (degree + 1) ** 2

    means = np.stack([col("x"), col("y"), col("z")], -1)
    log_scales = np.stack([col("scale_0"), col("scale_1"), col("scale_2")], -1)
    quats = np.stack([col("rot_0"), col("rot_1"), col("rot_2"), col("rot_3")], -1)
    opacity = col("opacity")

    sh = np.zeros((n, k, 3), np.float32)
    for c in range(3):
        sh[:, 0, c] = col(f"f_dc_{c}")
    # channel-major rest order (reference: ply.ts:183-187)
    for i in range(n_per_color):
        for c in range(3):
            sh[:, i + 1, c] = col(f"f_rest_{c * n_per_color + i}")

    device = torch.device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return GaussianScene(
        means=t(means),
        log_scales=t(log_scales),
        quats=t(quats),
        opacity_logits=t(opacity),
        sh=t(sh),
    )


def save_ply(scene: GaussianScene, path: str | os.PathLike) -> None:
    """Export to the graphdeco PLY layout (interop with graphdeco viewers).
    Exact inverse of load_ply."""

    def host(x):
        return x.detach().to("cpu", torch.float32).numpy()

    means = host(scene.means)
    log_scales = host(scene.log_scales)
    quats = host(scene.quats)
    opacity = host(scene.opacity_logits)
    sh = host(scene.sh)
    n, k, _ = sh.shape
    n_per_color = k - 1

    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(3 * n_per_color)]
    names += ["opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]

    rec = np.zeros(n, dtype=np.dtype([(nm, "<f4") for nm in names]))
    rec["x"], rec["y"], rec["z"] = means.T
    for c in range(3):
        rec[f"f_dc_{c}"] = sh[:, 0, c]
    for i in range(n_per_color):
        for c in range(3):
            rec[f"f_rest_{c * n_per_color + i}"] = sh[:, i + 1, c]
    rec["opacity"] = opacity
    for i in range(3):
        rec[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]

    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n")
    for nm in names:
        header.write(f"property float {nm}\n")
    header.write("end_header\n")

    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(rec.tobytes())
