"""Test configuration: run everything on CPU with an 8-device virtual mesh.

Must set env vars before jax is imported anywhere. Tests that need a GPU
carry the `gpu` marker, skip on hosts without one, and run their GPU work
in a subprocess (`python -m pytest -m gpu tests/` on the card).
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (after env setup)

jax.config.update("jax_platforms", "cpu")

from stark_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()


@pytest.fixture()
def gpu():
    """Skip the requesting test unless the host has an NVIDIA card. Decided
    at run time, never at import, so every xdist worker collects the same
    tests; asks `nvidia-smi` rather than JAX, so this process (held to the
    CPU) never reserves the card that the test's subprocess needs."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run(
        [smi, "-L"], capture_output=True, text=True, timeout=60
    ).stdout.strip()
    if not listed:
        pytest.skip("needs an NVIDIA GPU; run on the card")
