"""Device ms per train step in Feature 3DGS's decode: the resize, the 1x1
decoder and the feature L1 (mark "train.decode"), and their backward from
the feature loss's gradient to the feature map's (mark
"train.decode.backward"), from the program's record of the traced
window."""

from splatbench import stages

STAGES = ("train.decode", "train.decode.backward")


def read(trace: dict):
    s = stages.summary(trace)
    if s is None or not any(k in s["stage_ms"] for k in STAGES):
        return None
    return sum(s["stage_ms"].get(k, 0.0) for k in STAGES)
