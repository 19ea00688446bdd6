"""Spherical-harmonics -> RGB evaluation, degrees 0..3 (constants, sign
convention, +0.5 offset and clamp >= 0 of `gsplat_tpu.ops.sh`)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """sh: (..., K, 3) with K >= (degree+1)**2; dirs: (..., 3) unit view
    directions. Returns (..., 3) RGB, offset by +0.5 and clamped >= 0."""
    return torch.clamp_min(eval_sh_unclamped(sh, dirs, degree), 0.0)


def eval_sh_unclamped(sh: torch.Tensor, dirs: torch.Tensor,
                      degree: int) -> torch.Tensor:
    """`eval_sh` before its clamp at 0 (the projection's backward reads
    where the clamp passed)."""
    if degree not in (0, 1, 2, 3):
        raise ValueError(f"Unsupported SH degree {degree}")
    if sh.shape[-2] < (degree + 1) ** 2:
        raise ValueError(
            f"Scene has {sh.shape[-2]} SH coeffs; degree {degree} needs {(degree + 1) ** 2}"
        )

    # One unbind, not a select per coefficient: the backward of each select
    # would zero-fill and add a gradient the size of all of `sh`, where
    # unbind's backward stacks the coefficients' gradients once.
    c = sh.unbind(-2)
    result = SH_C0 * c[0]
    if degree >= 1:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result + SH_C1 * (-y * c[1] + z * c[2] - x * c[3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        result = result + (
            SH_C2[0] * xy * c[4]
            + SH_C2[1] * yz * c[5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * c[6]
            + SH_C2[3] * xz * c[7]
            + SH_C2[4] * (xx - yy) * c[8]
        )
    if degree >= 3:
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * c[9]
            + SH_C3[1] * xy * z * c[10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * c[11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c[12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * c[13]
            + SH_C3[5] * z * (xx - yy) * c[14]
            + SH_C3[6] * x * (xx - 3.0 * yy) * c[15]
        )
    return result + 0.5
