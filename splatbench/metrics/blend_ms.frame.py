"""Device ms per frame in the blend (K1): the intervals of its stages'
marks in the program's record of the traced window."""

from splatbench import stages


def read(trace: dict):
    return stages.layer_ms(trace, "blend")
