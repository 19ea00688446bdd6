"""The whole frame's FP32 operations (roofline.frame_ops) over the card's
peak in the traced window's time per frame."""

from splatbench import tracing


def read(trace: dict):
    return tracing.mfu_pct(trace)
