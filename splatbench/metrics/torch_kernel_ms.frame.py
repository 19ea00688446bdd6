"""Device ms per frame in the kernels that are neither the program's own
(K1-K5) nor NCCL's: the PyTorch ops around them."""

from splatbench import tracing


def read(trace: dict):
    return tracing.kernel_ms(trace, {"sort", "torch"})
