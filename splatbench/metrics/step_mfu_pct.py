"""The whole training step's FP32 operations (roofline.step_ops) over the
card's peak in the traced window's time per step."""

from splatbench import tracing


def read(trace: dict):
    return tracing.mfu_pct(trace)
