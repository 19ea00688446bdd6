"""Device ms per frame in PyTorch's sort kernels (the binning's key sort),
by kernel name."""

from splatbench import tracing


def read(trace: dict):
    return tracing.kernel_ms(trace, {"sort"})
