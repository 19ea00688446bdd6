"""On a CUDA card: the tiny cells through the program's captured paths
and kernels, traced and not, give correct lines."""

import pytest

from splatbench.tests import helpers


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [helpers.TRAIN, helpers.RENDER])
def test_tiny_cell_on_the_card(cell, trace, cuda_device):
    res = helpers.line(helpers.run_tiny(cell, trace=trace, device=cuda_device,
                                        seconds=1.0))
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert res["device"]["busy_s"] > 0
        assert res["breakdown"]["device_ops"]
