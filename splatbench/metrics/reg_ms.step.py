"""Device ms per train step in 2D Gaussian splatting's regularisers: the
depth map's normals, the normal-consistency and distortion losses (mark
"train.regularize"), and their backward from the regulariser's gradient to
the depth map's (mark "train.regularize.backward"), from the program's
record of the traced window."""

from splatbench import stages

STAGES = ("train.regularize", "train.regularize.backward")


def read(trace: dict):
    s = stages.summary(trace)
    if s is None or not any(k in s["stage_ms"] for k in STAGES):
        return None
    return sum(s["stage_ms"].get(k, 0.0) for k in STAGES)
