"""Test environment: CPU with 8 virtual devices.

Distributed-behavior tests run on a simulated 8-device mesh
(`--xla_force_host_platform_device_count=8`) per SURVEY.md §4 — the
analog of "multi-node without a cluster".  The platform is pinned to the
CPU after ``import jax`` and before any backend is initialized, so the
suite never reaches for an accelerator even where one is present.  What
runs on the GPU is checked by ``python chip_smoke.py`` on a machine with
the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled-program caches between test modules, so the
    suite's accumulated XLA:CPU programs stay bounded in one process."""
    yield
    jax.clear_caches()
