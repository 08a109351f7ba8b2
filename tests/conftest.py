"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device code paths (parallel/, graph/) are exercised on CPU via
``xla_force_host_platform_device_count`` per SURVEY.md §4, and Pallas
kernels run in interpret mode (ops/pallas_match.interpret_for).  The card
itself is exercised by ``python chip_smoke.py`` (README.md).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from slamnet_tpu.runtime import setup_compile_cache  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
# the suite's wall clock is dominated by XLA CPU compiles of the same
# programs every run; the persistent cache cuts reruns to minutes (the
# cache keys on backend + HLO, so it is shared safely with GPU runs)
setup_compile_cache(min_compile_secs=1.0)


def pytest_configure(config):
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on CPU; got %s" % jax.devices())
