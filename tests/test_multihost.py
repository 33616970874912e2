"""Multi-process (`jax.distributed`) prover core: the multi-host path.

Launches scripts/multihost_dryrun.py with 2 real OS processes x 4 CPU
devices and checks the m/l roots equal the single-process 8-device mesh
run from this process. Cross-process device arrays cannot be addressed
directly, so agreement here means every cross-chunk value moved through
collectives -- the same dataflow a multi-host job has across hosts.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single_process_roots(n_dev=8):
    import __graft_entry__ as ge
    from stark_tpu.ops import modmath as mm
    from stark_tpu.parallel.prove_sharded import build_sharded_prover_step
    from stark_tpu.protocol.core import make_example_inputs

    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        pytest.skip(f"need {n_dev} devices")
    mesh = Mesh(np.array(devs), ("d",))
    n_constraints = max(20, (n_dev * n_dev * 2) // 3 + 2)
    spec, arith, public_wires, params = ge._synthetic(n_constraints)
    fn = build_sharded_prover_step(
        spec, mesh, params.steps, params.precision, arith.original_steps
    )
    traces, r_mont, k_mont, i2_mont, pubx_mont = make_example_inputs(
        spec, arith, public_wires, params
    )
    xs_full = mm.power_table(spec, params.g2, params.precision)
    shard = NamedSharding(mesh, P(None, "d"))
    repl = NamedSharding(mesh, P(None, None))
    m_root, l_root, _ = fn(
        {k: jax.device_put(v, shard) for k, v in traces.items()},
        jax.device_put(xs_full, shard),
        jax.device_put(r_mont, repl),
        jax.device_put(k_mont, repl),
        jax.device_put(i2_mont, repl),
        jax.device_put(pubx_mont, repl),
    )
    return np.asarray(m_root).tolist(), np.asarray(l_root).tolist()


def test_two_process_full_proof_byte_identical():
    """The COMPLETE pipeline (FRI chain, branch gathers,
    device transcript, JSON assembly) across 2 OS processes under
    `jax.distributed` emits a proof byte-identical to the single-process
    prover's."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for attempt in range(2):
        res = subprocess.run(
            [
                sys.executable,
                os.path.join(REPO, "scripts", "multihost_dryrun.py"),
                "--procs", "2", "--devices-per-proc", "4", "--full",
            ],
            capture_output=True,
            text=True,
            timeout=int(os.environ.get("STARK_TPU_MULTIHOST_TIMEOUT", 2400)),
            cwd=REPO,
        )
        if res.returncode == 0:
            break
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(
        l for l in res.stdout.splitlines() if l.startswith("MULTIHOST_FULL ")
    )
    got = json.loads(line[len("MULTIHOST_FULL ") :])
    assert got["n_procs"] == 2 and got["devices"] == 8

    import hashlib

    from stark_tpu.protocol import proof as proof_mod
    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    r1cs, wb = squaring_chain(got["n_constraints"])
    js = proof_mod.to_json(runner.prove_with_witness(r1cs, wb))
    assert got["proof_bytes"] == len(js)
    assert got["proof_sha256"] == hashlib.sha256(js.encode()).hexdigest()


def test_two_process_core_matches_single_process():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # gloo's 30 s connectFullMesh window can expire when the host is under
    # heavy concurrent load; one retry rides out the transient
    for attempt in range(2):
        res = subprocess.run(
            [
                sys.executable,
                os.path.join(REPO, "scripts", "multihost_dryrun.py"),
                "--procs",
                "2",
                "--devices-per-proc",
                "4",
            ],
            capture_output=True,
            text=True,
            # generous: cold persistent-cache hosts pay full XLA compiles
            # inside the workers (observed >840 s under concurrent load)
            timeout=int(os.environ.get("STARK_TPU_MULTIHOST_TIMEOUT", 2400)),
            cwd=REPO,
        )
        if res.returncode == 0:
            break
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(
        l for l in res.stdout.splitlines() if l.startswith("MULTIHOST_RESULT ")
    )
    got = json.loads(line[len("MULTIHOST_RESULT ") :])
    assert got["n_procs"] == 2 and got["devices"] == 8

    m_root, l_root = _single_process_roots(8)
    assert got["m_root"] == m_root
    assert got["l_root"] == l_root
