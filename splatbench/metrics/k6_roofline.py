"""K6, the blend of the colour and the feature channels (csrc/feat_fwd.cu):
the least time of its work per step (`roofline_features.k6_work`) over its
device time per step, the kernel found by its own name."""

from splatbench import roofline_features


def read(trace: dict):
    return roofline_features.roofline_pct(trace, "K6")
