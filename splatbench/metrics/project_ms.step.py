"""Device ms per train step in the projection and SH, forward and backward
(from the features' gradient on): the intervals of its stages' marks in
the program's record of the traced window."""

from splatbench import stages


def read(trace: dict):
    return stages.layer_ms(trace, "project")
