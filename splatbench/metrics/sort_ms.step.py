"""Device ms per step in PyTorch's sort kernels (the key sorts of the
binning and of the gather backward), by kernel name."""

from splatbench import tracing


def read(trace: dict):
    return tracing.kernel_ms(trace, {"sort"})
