"""The binning's useful share over the traced window: intersections over
the keys its sort ordered, from the bin stage's payloads."""

from splatbench import stages


def read(trace: dict):
    return stages.bin_useful_pct(trace)
