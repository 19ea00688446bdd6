"""The work counts against a hand-counted scene: a few Gaussians over one
16 x 16 tile, each covering it whole with a flat profile (conic 0, so
alpha is the opacity at every pixel)."""

import pytest
import torch

from splatbench import roofline
from splatbench.reference import render as R

RC = dict(width=16, height=16, tile_size=16, alpha_min=1.0 / 255.0,
          alpha_clamp=0.99, transmittance_min=1e-4, stream_format="packed4",
          grad_readout="bf16", gather_backward="bf16")


def _flat(opacities):
    n = len(opacities)
    f = torch.zeros((9, 1, n))
    f[0], f[1] = 8.0, 8.0            # centre of the tile
    f[5:8] = 0.5                     # grey
    f[8, 0] = torch.tensor(opacities)
    return f


def test_walked_and_applied_pairs_by_hand():
    # A first splat under alpha_min is walked and skipped; then alpha 0.95
    # four times: T = 0.05, 0.0025, 1.25e-4, then 6.25e-6 < 1e-4, so the
    # fifth finishes every pixel unapplied, and the sixth is never walked.
    f = _flat([0.001, 0.95, 0.95, 0.95, 0.95, 0.95])
    tally = {"walked": 0, "applied": 0}
    rgb = R.blend(f, torch.ones((1, 6), dtype=torch.bool),
                  torch.zeros((1,), dtype=torch.int64), RC, tally=tally)
    assert tally == {"walked": 256 * 5, "applied": 256 * 3}
    want = 0.5 * (0.95 + 0.05 * 0.95 + 0.0025 * 0.95)
    assert torch.allclose(rgb, torch.full_like(rgb, want), rtol=1e-6)


def test_kernel_work_formulas():
    tally = {"walked": 256 * 5, "applied": 256 * 3, "slots": 6,
             "rect_lanes": 6}
    ops, nbytes = roofline.k1_work(tally, RC)
    assert ops == 20 * 1280
    # 6 slots of 4 packed4 words, 2 range words, image and transmittance.
    assert nbytes == 4 * (6 * 4 + 2 + 4 * 256)
    ops, nbytes = roofline.k2_work(tally, RC)
    assert ops == 20 * 1280 + 33 * 768 + 7 * 6
    # The stream and 5 bf16-pair words of gradient per slot, 2 range
    # words, the image gradient and the per-pixel sum.
    assert nbytes == 4 * (6 * (4 + 5) + 2 + 4 * 256)
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_step_and_frame_operations():
    tally = {"walked": 1000, "applied": 400, "slots": 50, "rect_lanes": 60}
    n = 10
    frame = (n * (roofline.PROJECT_OPS + roofline.SH_OPS
                  + roofline.K3_OPS_PER_SPLAT)
             + 70 * 60 + 20 * 1000)
    assert roofline.frame_ops(tally, RC, n) == frame
    step = (frame + (20 * 1000 + 33 * 400 + 7 * 50) + 10 * 50
            + 2 * n * (roofline.PROJECT_OPS + roofline.SH_OPS)
            + 16 * 16 * 3 * (roofline.L1_OPS + roofline.SSIM_OPS)
            + 12 * n * 59)
    assert roofline.step_ops(tally, RC, n, 59, 0.2) == step
