"""Device ms per train step in the blend (K1) and the backward of the blend
and the gather (K2, the slot sort, K5), from the image's gradient on:
the intervals of its stages' marks in the program's record of the traced
window."""

from splatbench import stages


def read(trace: dict):
    return stages.layer_ms(trace, "blend")
