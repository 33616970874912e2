"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR says,
else at the fixed `<checkout>/.jax_cache` (`stark_tpu.utils.compile_cache`)."""

import os
import subprocess
import sys

import pytest

from stark_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "explicit"])
def test_cache_dir(env, monkeypatch, tmp_path):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert compile_cache.cache_dir() == want


_PROBE = """
import os, sys
import jax
import jax.numpy as jnp
from stark_tpu.utils import compile_cache
path = compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * {salt} + 7)(jnp.arange(5)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_written_only_where_configured(env_set, tmp_path):
    """A compile lands in the configured directory; with the variable set
    the code names no other directory."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        want = os.path.join(REPO, ".jax_cache")
    salt = 1000 + int(env_set) + os.getpid() % 997  # a fresh executable
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(salt=salt)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    path, configured = out.stdout.split()[-2:]
    assert path == want and configured == want
    assert os.path.isdir(want) and os.listdir(want)
    assert not os.path.exists(tmp_path / ".jax_cache")
