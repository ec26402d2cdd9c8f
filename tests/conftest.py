"""Test configuration.

Tests run on CPU with 8 virtual devices (for sharding tests) and x64 enabled,
per the multi-chip test strategy in SURVEY.md §4: sharded paths must agree
with the single-chip path on a `xla_force_host_platform_device_count` mesh.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a machine
with one, run them with ``FOS_TEST_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import os

# NOTE: jax is pre-imported at interpreter startup in this image, so plain
# env-var configuration is too late here; use jax.config.update instead.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("FOS_TPU_X64", "1")

import jax

jax.config.update("jax_platforms", os.environ.get("FOS_TEST_PLATFORMS", "cpu"))
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (see the module docstring)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: FOS_TEST_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/ on a machine with one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound accumulated XLA CPU compile state across the full suite.

    With the whole suite in one process, the compiled executables
    accumulate until one of the late LARGE compilations segfaulted inside
    backend_compile (seen in full-suite runs, never in isolation or in
    sub-suites).  Dropping compiled programs between modules keeps the
    live-executable footprint flat; per-module tests still share
    compilations.
    """
    yield
    jax.clear_caches()
