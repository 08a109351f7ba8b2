"""Process set-up helpers (slamnet_tpu/runtime.py) and chip_smoke.py's
refusal to run anywhere but on a GPU."""
import json
import os
import subprocess
import sys

import jax
import pytest

from slamnet_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/nonexistent/cache-from-env"])
def test_compile_cache_helper(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
        path = runtime.setup_compile_cache(min_compile_secs=1.0)
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    else:
        # JAX reads the variable itself: the helper sets nothing else
        monkeypatch.setenv(runtime.CACHE_ENV, env_dir)
        assert runtime.setup_compile_cache() == env_dir
        assert jax.config.jax_compilation_cache_dir == before


def test_device_record_names_the_device():
    rec = runtime.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
    assert rec["count"] == 8                   # tests/conftest.py's mesh
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


@pytest.mark.parametrize("args", [[], ["--multichip"]])
def test_chip_smoke_refuses_the_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
