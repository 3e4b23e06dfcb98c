"""Test harness: run everything on an 8-device virtual CPU mesh so multi-chip
sharding semantics are exercised without TPU hardware (the driver's
dryrun_multichip uses the same mechanism).

Note: env vars alone are not enough — the site's PJRT plugin registration can
pin the platform before user code runs, so we also override programmatically
after importing jax (before any backend is initialised).
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
        "without one")
