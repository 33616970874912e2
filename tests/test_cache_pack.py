"""Round-trip tests for `cli cache-pack` / `cache-unpack`.

The pack/unpack pair is the framework's answer to the reference's
zero-warmup standing start (`/root/reference/packages/r1cs-stark/src/main.rs:4-11`
runs an AOT-compiled binary; XLA compiles JIT, so a deployment ships the
persistent compile cache + NTT plan tables instead). These tests pin the
tar layout, the restore semantics, and the path-traversal guard without
touching the real caches (both dirs are env-overridable).
"""

import io
import os
import tarfile

import pytest

from stark_tpu import cli


@pytest.fixture()
def cache_dirs(tmp_path, monkeypatch):
    cache = tmp_path / "jax_cache"
    plans = tmp_path / "plans_cache"
    cache.mkdir()
    plans.mkdir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
    monkeypatch.setenv("STARK_TPU_PLANS_CACHE", str(plans))
    return cache, plans


@pytest.mark.quick
def test_cache_pack_unpack_round_trip(cache_dirs, tmp_path):
    cache, plans = cache_dirs
    (cache / "jit_foo-cache").write_bytes(b"executable-bytes" * 100)
    (cache / "jit_bar-cache").write_bytes(b"\x00\x01\x02")
    (plans / "ntt_abc.npz").write_bytes(b"plan-tables")

    archive = str(tmp_path / "warm.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    assert os.path.exists(archive)

    # wipe both caches, restore, and compare contents byte-for-byte
    for d in (cache, plans):
        for name in os.listdir(d):
            os.unlink(d / name)
    assert cli.main(["cache-unpack", archive]) == 0
    assert (cache / "jit_foo-cache").read_bytes() == b"executable-bytes" * 100
    assert (cache / "jit_bar-cache").read_bytes() == b"\x00\x01\x02"
    assert (plans / "ntt_abc.npz").read_bytes() == b"plan-tables"
    assert sorted(os.listdir(cache)) == ["jit_bar-cache", "jit_foo-cache"]
    assert sorted(os.listdir(plans)) == ["ntt_abc.npz"]


@pytest.mark.quick
def test_cache_unpack_restores_into_empty_dirs(cache_dirs, tmp_path):
    """Unpack must create the destination dirs on a pristine host."""
    cache, plans = cache_dirs
    (cache / "jit_x-cache").write_bytes(b"x")
    archive = str(tmp_path / "warm.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0

    import shutil

    shutil.rmtree(cache)
    shutil.rmtree(plans)
    assert cli.main(["cache-unpack", archive]) == 0
    assert (cache / "jit_x-cache").read_bytes() == b"x"


@pytest.mark.quick
def test_cache_unpack_refuses_traversal(cache_dirs, tmp_path):
    """Entries outside the two cache namespaces — wrong top dir, nested
    paths, `..` components, absolute paths — are silently skipped, never
    written anywhere."""
    cache, plans = cache_dirs

    archive = str(tmp_path / "evil.tar.gz")
    with tarfile.open(archive, "w:gz") as tf:

        def add(name, payload=b"evil"):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))

        add("jax_stark/ok-entry", b"good")
        add("jax_stark/../escape")
        add("jax_stark/nested/dir/entry")
        add("/etc/passwd-clobber")
        add("other_top/entry")
        add("jax_stark/../../outside")

    assert cli.main(["cache-unpack", archive]) == 0
    assert sorted(os.listdir(cache)) == ["ok-entry"]
    assert (cache / "ok-entry").read_bytes() == b"good"
    assert os.listdir(plans) == []
    assert not (tmp_path / "escape").exists()
    assert not (tmp_path / "outside").exists()


@pytest.mark.quick
def test_cache_pack_skips_missing_dirs(tmp_path, monkeypatch):
    """Packing on a host with no caches yet produces a valid empty archive."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "nonexistent"))
    monkeypatch.setenv(
        "STARK_TPU_PLANS_CACHE", str(tmp_path / "also_nonexistent")
    )
    archive = str(tmp_path / "empty.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    with tarfile.open(archive, "r:gz") as tf:
        assert tf.getmembers() == []
