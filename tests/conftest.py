"""Test harness configuration.

Runs the whole suite on an 8-device virtual CPU mesh so sharding tests
exercise the same SPMD code paths as a multi-GPU mesh.  Must run before
any test imports initialize a JAX backend.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite compiles ~15 distinct option
# combinations; caching makes re-runs start in seconds.
from noahmp_jax.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow at full depth (CI depth: the "
             "500-step resync fuzz, the 65s layout/chunk sweeps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test, skipped unless --runslow "
                   "(a subsampled default usually covers the same code)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def runslow(request):
    return request.config.getoption("--runslow")
