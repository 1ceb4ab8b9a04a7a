"""Shared test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the single real CPU device; only launch/dryrun.py forces 512."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU "
        "mode); skips inside the test where there is none")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
