"""K7, the backward of K6's blend (csrc/feat_bwd.cu): the least time of its
work per step (`roofline_features.k7_work`) over its device time per step,
the kernel found by its own name."""

from splatbench import roofline_features


def read(trace: dict):
    return roofline_features.roofline_pct(trace, "K7")
