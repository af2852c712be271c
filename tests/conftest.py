"""Test harness.

By default the suite runs on the CPU backend with 8 virtual devices
(SURVEY.md §4.4), so every sharded code path runs on a simulated 8-device
mesh.  Tests marked `gpu` need the card and skip here; they run on a GPU
machine with

    DSR_GPU_TESTS=1 python -m pytest tests/ -m gpu -n 0

which keeps JAX's default (GPU) backend.
"""

import os
import sys

ON_GPU = bool(os.environ.get("DSR_GPU_TESTS"))
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # CPU suites skip the persistent compile cache: local CPU compiles are
    # cheap, and many workers writing one cache directory buys nothing.
    os.environ.setdefault("DSR_NO_CACHE", "1")
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # 8 virtual devices share few physical cores: a long-running
    # other-device computation can hold a collective rendezvous past
    # XLA:CPU's terminate timeout, which CHECK-fails the process (seen as
    # a flaky fatal in a contended dryrun).  Warn early, terminate late.
    if "--xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
        flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=120"
                  " --xla_cpu_collective_call_terminate_timeout_seconds=3600")
    os.environ["XLA_FLAGS"] = flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8

# NaN-guard test mode (SURVEY.md §5 sanitizer analogue): DSR_DEBUG_NANS=1
# flips jax_debug_nans for the WHOLE suite; the `debug_nans` fixture scopes
# it to individual tests (tests/test_nan_guard.py runs the numeric core
# paths under it every run).
if os.environ.get("DSR_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)

import pytest  # noqa: E402


@pytest.fixture
def debug_nans():
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@pytest.fixture
def gpu():
    """The card, for tests marked `gpu`: skips unless JAX's default
    backend is a GPU (decided here, at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
