"""Test harness configuration.

Mirrors the reference's CPU-sim strategy (SURVEY §4): the reference tests
its 8-core kernel without hardware by compiling the same source against
tikicpulib (cmake/cpu/CMakeLists.txt:6). Here the same trick is
``--xla_force_host_platform_device_count=8`` — the multi-chip sharding
code paths run unchanged on 8 virtual CPU devices.

The platform is pinned in ``pytest_configure``, before any test module
is imported and before any backend starts.  Whether a GPU is present is
decided inside the ``gpu_device`` fixture, at run time.
"""

import os

import jax
import numpy as np
import pytest

GPU_MARKER_RUN = "gpu"


def pytest_configure(config):
    """Pin the CPU (8 virtual devices, float64) unless this run selects
    the ``gpu``-marked tests (``python -m pytest tests/ -m gpu``, which
    runs on the card).  No backend has started yet at this point; which
    tests exist does not depend on it."""
    if config.getoption("markexpr") == GPU_MARKER_RUN:
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    # Float64 is the numerically-stable parity gate (see
    # tests/test_reference_parity.py).
    jax.config.update("jax_enable_x64", True)


REFERENCE_PATH = "/root/reference"


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: tests marked ``gpu`` take this fixture."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX found {jax.default_backend()})")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def reference_scripts_dir():
    """Path to the upstream reference's scripts/, or skip if absent."""
    p = os.path.join(REFERENCE_PATH, "scripts")
    if not os.path.isdir(p):
        pytest.skip("reference repo not mounted")
    return p
