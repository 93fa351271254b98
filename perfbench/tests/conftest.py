"""Settings of the benchmark's own tests.

``chip``: a test that needs a CUDA card; it decides inside the ``card``
fixture whether there is one and skips on a machine without. Run them on
the card with ``python3 -m pytest perfbench/tests -m chip``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_store(tmp_path_factory):
    from perfbench import data
    from perfbench.tests.tiny import DATASET

    cache = tmp_path_factory.mktemp("perfbench_data")
    data.ensure_store(DATASET, cache=cache)
    return cache
