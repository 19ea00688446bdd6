"""K11, the backward of K10's blend (csrc/surfel_bwd.cu):
the least time of its work per step (`roofline_surfels.work`) over its
device time per step, the kernel found by its own name."""

from splatbench import roofline_surfels


def read(trace: dict):
    return roofline_surfels.roofline_pct(trace, "K11")
