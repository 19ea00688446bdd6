"""K1, the forward blend (csrc/raster_fwd.cu): the least time its work per
frame needs over its device time per frame."""

from splatbench import tracing


def read(trace: dict):
    return tracing.roofline_pct(trace, "K1")
