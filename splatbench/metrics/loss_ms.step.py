"""Device ms per train step in L1 + DSSIM and the mean over views, and
their backward up to the image's gradient: the intervals of its stages'
marks in the program's record of the traced window."""

from splatbench import stages


def read(trace: dict):
    return stages.layer_ms(trace, "loss")
