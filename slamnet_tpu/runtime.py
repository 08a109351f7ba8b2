"""Process set-up shared by bench.py, chip_smoke.py, the tests and scripts/:
the persistent compile cache and the record of the device a number was
measured on."""
from __future__ import annotations

import os
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    If $JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    else is set; otherwise the cache is the fixed path <checkout>/.jax_cache
    (a fixed path, because the path is part of the cache key).  Errors are
    raised, never swallowed."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


PLATFORMS = ("cpu", "gpu")


def select_platform(platform: str) -> None:
    """Pin JAX to "cpu" or "gpu" (the --platform flag of the examples and
    scripts); call before JAX's first use.  "gpu" fails when JAX finds no
    GPU instead of running on the CPU."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} not in {PLATFORMS}")
    name = "cpu" if platform == "cpu" else "cuda"
    os.environ["JAX_PLATFORMS"] = name
    import jax
    jax.config.update("jax_platforms", name)
    if platform == "gpu":
        require_gpu()


def device_record() -> dict:
    """The device JAX computes on, as every measurement names it."""
    import jax
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu() -> dict:
    """device_record(), or RuntimeError when JAX found no GPU: a
    measurement never falls back to the CPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX computes on {rec}")
    return rec


def gpu_card() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
