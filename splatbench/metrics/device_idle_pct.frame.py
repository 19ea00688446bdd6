"""The share of the traced serving window in which no operation ran on
the card."""

from splatbench import tracing


def read(trace: dict):
    return tracing.idle_pct(trace)
