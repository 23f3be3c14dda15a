"""Test configuration.

Tests run on the CPU unless JAX_PLATFORMS names another platform, with
8 virtual CPU devices so the sharded train step runs on a mesh without
a card. Tests marked `gpu` need a card and skip on the CPU (see
tests/test_gpu_numerics.py for the command that runs them).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(3)
