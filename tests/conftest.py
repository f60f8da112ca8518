"""Test config: CPU backend with 8 virtual devices (SURVEY §4(g)) and x64.

Multi-device sharding tests run on a simulated 8-device CPU mesh via
--xla_force_host_platform_device_count.  JAX_PLATFORMS defaults to cpu;
tests marked `gpu` need an NVIDIA GPU and run there with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

(they skip, with a reason, wherever JAX finds no GPU).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
# XLA:CPU's concurrency-optimized scheduler makes the float64 fused
# step segfault (17^3 nodes, -nlvls 2, -fused 1 -dtype float64)
if "concurrency_optimized_scheduler" not in _flags:
    _flags += " --xla_cpu_enable_concurrency_optimized_scheduler=false"
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (2-process multihost jobs); excluded "
        "from the default gate — set RUN_SLOW=1 (or -m slow) for the "
        "CI-style full run",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (compiled kernels, no interpret mode); "
        "skips elsewhere — run with JAX_PLATFORMS=cuda ... -m gpu",
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU (decided here,
    at run time, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found "
                    f"{jax.devices()[0].platform}")
    return jax.devices()[0]


def pytest_collection_modifyitems(config, items):
    """Default gate stays fast; slow tests still run in full CI-style
    sweeps with RUN_SLOW=1 or an explicit -m selection."""
    if os.environ.get("RUN_SLOW") or config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="slow test: set RUN_SLOW=1 (or -m slow) to include"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
