"""The work a cell's inputs need, and the card's peaks.

A roofline share is the least time the card needs for a kernel's work
(the larger of its FP32 operations at the peak rate and its bytes at the
peak bandwidth, each input byte read once and each output byte written
once) over the kernel's measured time. The work is counted here from the
reference's own pass over the traced poses (`tally`: the slots of the
binned lists, the (pixel, Gaussian) pairs each pixel walked up to and with
the one that finished it, the pairs applied, the rect lanes), never from
the program's counters, so it reads the same whatever implements a kernel.
The per-pair constants are those of the kernels' own notes (K1: about 20
FP32 operations per walked pair; K2: 20 per walked pair, 33 more per
applied pair, 7 per slot; K3: 70 per rect lane, 5 per splat).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, no sparsity, at the full 700 W.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

K1_OPS_PER_WALKED = 20
K2_OPS_PER_WALKED = 20
K2_OPS_PER_APPLIED = 33
K2_OPS_PER_SLOT = 7
K3_OPS_PER_LANE = 70
K3_OPS_PER_SPLAT = 5
# The gather backward's segmented sum over bf16 pairs (K5): two adds per
# int32 lane, five lanes per slot (9 features and a pad); over float32
# rows (K4) one add per feature.
SEGSUM_OPS_PER_SLOT = {"bf16": 10, "f32": 9}
# Per Gaussian, forward: the view and clip transforms (36), frustum tests
# (6), the Jacobian and J W (30), R S (25: normalise, 9 products), Sigma
# and the 2D covariance (60), det, eigenvalue, radius, conic (20),
# opacity, tau and the rect (25); SH colour of degree 3: the direction
# (9), 16 basis terms (30) and 48 multiply-adds (96). Their backward costs
# about twice the forward.
PROJECT_OPS = 202
SH_OPS = 135
BACKWARD_FACTOR = 2
# Per pixel and channel: L1 forward and backward (5); SSIM forward (the
# five planes, 3 products; five planes blurred by two 11-tap passes, 220;
# the index, 20) and backward (the same blur of five gradient planes and
# the chain, 245).
L1_OPS = 5
SSIM_OPS = 488
# Per parameter element: Adam's moments, bias corrections and update.
ADAM_OPS = 12
# Stream rows per slot, int32 or float32, by format; bf16-pair rows of the
# slot gradients K2 writes.
STREAM_ROWS = {"f32": 9, "packed16": 5, "packed4": 4}
GRAD_ROWS = {"bf16": 5, "f32": 9}


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card needs for the work."""
    return max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)


def _image_words(rc: dict) -> int:
    ts = rc["tile_size"]
    return (-(-rc["width"] // ts) * ts) * (-(-rc["height"] // ts) * ts)


def _tiles(rc: dict) -> int:
    ts = rc["tile_size"]
    return -(-rc["width"] // ts) * -(-rc["height"] // ts)


def k1_work(tally: dict, rc: dict) -> tuple[float, float]:
    """(ops, bytes) of the forward blend of one view: the stream in, the
    ranges, the image and its transmittance out."""
    ops = K1_OPS_PER_WALKED * tally["walked"]
    nbytes = 4 * (tally["slots"] * STREAM_ROWS[rc["stream_format"]]
                  + _tiles(rc) + 1 + 4 * _image_words(rc))
    return ops, nbytes


def k2_work(tally: dict, rc: dict) -> tuple[float, float]:
    """(ops, bytes) of the blend backward of one view: the stream, the
    ranges, the image gradient and the per-pixel sum in; the slot
    gradients out."""
    ops = (K2_OPS_PER_WALKED * tally["walked"]
           + K2_OPS_PER_APPLIED * tally["applied"]
           + K2_OPS_PER_SLOT * tally["slots"])
    grad_rows = GRAD_ROWS[rc.get("grad_readout", "f32")]
    nbytes = 4 * (tally["slots"] * (STREAM_ROWS[rc["stream_format"]]
                                    + grad_rows)
                  + _tiles(rc) + 1 + 4 * _image_words(rc))
    return ops, nbytes


def frame_ops(tally: dict, rc: dict, n: int) -> float:
    """FP32 operations of one forward frame of n Gaussians: projection, SH
    colour, the cull over the rect lanes, the blend."""
    return (n * (PROJECT_OPS + SH_OPS + K3_OPS_PER_SPLAT)
            + K3_OPS_PER_LANE * tally["rect_lanes"]
            + k1_work(tally, rc)[0])


def step_ops(tally: dict, rc: dict, n: int, params_per_gaussian: int,
             ssim_weight: float) -> float:
    """FP32 operations of one training step on one view: the frame, its
    backward (blend, gather, projection and SH), the loss and Adam."""
    pixels = rc["width"] * rc["height"] * 3
    loss = pixels * (L1_OPS + (SSIM_OPS if ssim_weight else 0))
    grad = "bf16" if rc.get("gather_backward") == "bf16" else "f32"
    return (frame_ops(tally, rc, n)
            + k2_work(tally, rc)[0]
            + SEGSUM_OPS_PER_SLOT[grad] * tally["slots"]
            + BACKWARD_FACTOR * n * (PROJECT_OPS + SH_OPS)
            + loss + ADAM_OPS * n * params_per_gaussian)
