import os
import sys

# NOTE: deliberately NO --xla_force_host_platform_device_count here — smoke
# tests and benches must see 1 device (the dry-run sets 512 for itself, and
# multi-device tests spawn subprocesses).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")
