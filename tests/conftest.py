"""Test harness configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with a virtual 8-device
mesh, so multi-device sharding paths are exercised without accelerators,
and with x64 enabled so parity tests against the double-precision NumPy
oracle are exact.  Tests that need an NVIDIA GPU carry the ``gpu`` marker
and take the ``gpu_device`` fixture, which skips them elsewhere; on the
card they run with ``python -m pytest tests/test_chip_bringup.py -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

from img_env_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running convergence/e2e tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")


# Fast/full tier split: tests/slow_tests.txt lists the measured heavy
# tests (>~25 s on the CI box).  ``pytest tests/ -m "not slow" -q`` is the
# fast developer loop; the full suite (~55 min cold, ~25 min cached) stays
# the CI/judge target.  Explicit @pytest.mark.slow decorators also work.
def _slow_set():
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return {ln.strip() for ln in f if ln.strip()
                    and not ln.startswith("#")}
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    slow = _slow_set()
    for item in items:
        base = item.nodeid.split("[")[0]
        if base in slow:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "`python -m pytest tests/test_chip_bringup.py -m gpu`")
    return devs[0]
