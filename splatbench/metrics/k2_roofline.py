"""K2, the blend backward (csrc/raster_bwd.cu): the least time its work
per step needs over its device time per step."""

from splatbench import tracing


def read(trace: dict):
    return tracing.roofline_pct(trace, "K2")
