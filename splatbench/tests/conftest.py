"""The benchmark's tests: `python -m pytest splatbench/tests -q`. Tests
marked `card` need a CUDA card; they decide so in the `cuda_device`
fixture and skip on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA card")
    # Several workers share the CPU; one thread each keeps a frame short.
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
