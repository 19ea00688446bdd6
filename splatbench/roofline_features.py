"""The work of a Feature 3DGS training step (`kinds/train_features.py`),
counted from the reference's own pass (`reference/features.py`'s tally:
the slots, the walked and applied pairs, the rect lanes, the channels C),
never from the program: K6's and K7's operations and bytes, and the whole
step's FP32 operations.

Per applied pair and channel, K6 adds w f (2 operations) and K7 the dot
product g_F . f and the product g_F w (4), on top of K1's and K2's work
per pair (`roofline.py`). Bytes: each input read once and each output
written once, the feature table (N, C) and the maps (H, W, C) included.
The step adds to `roofline.step_ops` (the frame, the blend's backward,
the gather's, the projection's, L1 + DSSIM, Adam over the five fields)
the feature channels of the blend, the resize (forward and backward), the
decoder's GEMMs (2 D C h w forward, twice that backward), the feature L1
and Adam over the features and the decoder.
"""

from __future__ import annotations

from splatbench import roofline as RF

K6_OPS_PER_APPLIED_CHANNEL = 2
K7_OPS_PER_APPLIED_CHANNEL = 4
# Per output element and channel: bilinear interpolation's four weighted
# reads (7) forward, and their four scattered adds backward (8).
RESIZE_OPS = 15
# The kernels' names in a trace (csrc/feat_fwd.cu, csrc/feat_bwd.cu).
KERNEL_NAMES = {"K6": "feat_fwd_kernel", "K7": "feat_bwd_kernel"}


def _pixels(rc: dict) -> int:
    return rc["width"] * rc["height"]


def k6_work(tally: dict, rc: dict, n: int) -> tuple[float, float]:
    """(ops, bytes) of K6 on one view: the stream, the slots' ids, the
    ranges and the feature table in; the colour tiles, transmittance and
    feature map out."""
    c = tally["channels"]
    ops = (RF.K1_OPS_PER_WALKED * tally["walked"]
           + K6_OPS_PER_APPLIED_CHANNEL * c * tally["applied"])
    nbytes = 4 * (tally["slots"] * (RF.STREAM_ROWS[rc["stream_format"]] + 1)
                  + RF._tiles(rc) + 1 + 4 * RF._image_words(rc)
                  + n * c + _pixels(rc) * c)
    return ops, nbytes


def k7_work(tally: dict, rc: dict, n: int) -> tuple[float, float]:
    """(ops, bytes) of K7 on one view: the stream, the ids, the ranges,
    the colour's gradient and sum, the feature map and its gradient and
    the table in; the 9 float32 slot gradients and the table's gradient
    out."""
    c = tally["channels"]
    ops = (RF.K2_OPS_PER_WALKED * tally["walked"]
           + RF.K2_OPS_PER_APPLIED * tally["applied"]
           + RF.K2_OPS_PER_SLOT * tally["slots"]
           + K7_OPS_PER_APPLIED_CHANNEL * c * tally["applied"])
    nbytes = 4 * (tally["slots"] * (RF.STREAM_ROWS[rc["stream_format"]] + 1
                                    + 9)
                  + RF._tiles(rc) + 1 + 4 * RF._image_words(rc)
                  + 2 * _pixels(rc) * c + 2 * n * c)
    return ops, nbytes


def step_ops(tally: dict, rc: dict, fc: dict, n: int,
             params_per_gaussian: int, ssim_weight: float) -> float:
    """FP32 operations of one Feature 3DGS training step on one view."""
    c, d = tally["channels"], fc["decoder_out"]
    hw = fc["teacher_hw"][0] * fc["teacher_hw"][1]
    applied = tally["applied"]
    features = (K6_OPS_PER_APPLIED_CHANNEL + K7_OPS_PER_APPLIED_CHANNEL) \
        * c * applied
    decode = 3 * 2 * d * c * hw + 2 * d * hw
    resize = RESIZE_OPS * c * hw
    l1 = RF.L1_OPS * d * hw
    adam = RF.ADAM_OPS * (n * c + d * c + d)
    return (RF.step_ops(tally, rc, n, params_per_gaussian, ssim_weight)
            + features + decode + resize + l1 + adam)


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds per call of the kernel named in KERNEL_NAMES, by its
    name (the harness's kernel classes know K1-K5 alone): per name, the
    mean record times the eager launches per call, else the records' sum
    over the calls."""
    sub = KERNEL_NAMES[kernel]
    total = 0.0
    for name, k in trace["kernels"].items():
        if sub not in name:
            continue
        if name in trace["eager"]:
            total += k["sum_s"] / k["n"] * trace["eager"][name]
        else:
            total += k["sum_s"] / trace["calls"]
    return total


def roofline_pct(trace: dict, kernel: str):
    """The kernel's share of its roofline; None where the window ran none
    or the cell counts no such work."""
    work = trace.get("work", {}).get(kernel)
    t = kernel_seconds(trace, kernel)
    if work is None or t <= 0.0:
        return None
    return 100.0 * RF.bound_s(*work) / t


