"""Test session config. IMPORTANT: no XLA_FLAGS here — smoke tests and
benches must see 1 CPU device; multi-device tests spawn subprocesses that
set --xla_force_host_platform_device_count themselves."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")
