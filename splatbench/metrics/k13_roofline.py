"""K13, the backward of K12's projection (csrc/surfel_project.cu):
the least time of its work per step (`roofline_surfels.work`) over its
device time per step, the kernel found by its own name."""

from splatbench import roofline_surfels


def read(trace: dict):
    return roofline_surfels.roofline_pct(trace, "K13")
