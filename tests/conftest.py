"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device
count (1); only launch/dryrun.py forces 512 host devices."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside a fixture without one")
