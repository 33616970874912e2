"""`chip_smoke.py` refuses to run without a GPU, and the package carries no
TPU-only code. The smoke test itself runs on the card (`gpu` marker)."""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_smoke_refuses_cpu_backend(where, tmp_path):
    if where == "checkout":
        script = os.path.join(REPO, "chip_smoke.py")
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, script], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_smoke_on_card(gpu):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stdout[-4000:]
    assert '"ok": true' in out.stdout.splitlines()[-1]


_TPU_ONLY = {
    "pallas_tpu_import": re.compile(r"pallas\s*(\.|import\s+)\s*tpu|pltpu"),
    "tpu_backend_test": re.compile(r"""default_backend\(\)\s*[!=]=\s*["']tpu["']"""),
}


@pytest.mark.parametrize("pattern", sorted(_TPU_ONLY))
def test_package_has_no_tpu_only_code(pattern):
    rx = _TPU_ONLY[pattern]
    hits = []
    roots = [os.path.join(REPO, "stark_tpu")]
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for root in roots:
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if rx.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert hits == []
