"""Multi-host dry run: the sharded prover core across N real OS processes.

Each worker process initializes `jax.distributed` against a local
coordinator, owns `devices_per_proc` virtual CPU devices, and participates
in one sharded prover-core step (8 four-step-NTT LDEs + accumulator +
quotients + boundaries + linear combination + both Merkle roots) over the
global 1-D mesh. Process 0 prints the resulting m/l roots as JSON.

This is the closest a single machine gets to a multi-host job: the
processes genuinely cannot address each other's devices, so every
cross-process value moves through collectives, exactly as cross-host
traffic would. Run directly:

    python scripts/multihost_dryrun.py --procs 2 --devices-per-proc 4

`tests/test_multihost.py` launches this and checks the printed roots
against the single-process mesh run.
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import argparse
import json
import os
import subprocess
import sys


def worker_full(proc_id: int, n_procs: int, devices_per_proc: int, port: int) -> None:
    """FULL proof across OS processes: every stage (device transcript, both
    Merkle trees, branch gathers, the FRI recursion, JSON assembly) runs on
    the global mesh; the assembled proof must be byte-identical to the
    single-process prover's (`tests/test_multihost.py` asserts the sha)."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    jax.config.update("jax_platforms", "cpu")
    from stark_tpu.parallel import distributed as dist

    dist.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    import hashlib

    from stark_tpu.protocol import proof as proof_mod
    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    mesh = dist.global_mesh_1d()
    d = mesh.devices.size
    assert d == n_procs * devices_per_proc

    n_constraints = max(44, (d * d * 2) // 3 + 2)
    r1cs, wb = squaring_chain(n_constraints)
    proof = runner.prove_with_witness(r1cs, wb, mesh=mesh)
    js = proof_mod.to_json(proof)
    sha = hashlib.sha256(js.encode()).hexdigest()
    if proc_id == 0:
        out = {
            "n_procs": n_procs,
            "devices": d,
            "n_constraints": n_constraints,
            "proof_bytes": len(js),
            "proof_sha256": sha,
        }
        print("MULTIHOST_FULL " + json.dumps(out), flush=True)
    jax.distributed.shutdown()


def worker(proc_id: int, n_procs: int, devices_per_proc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    jax.config.update("jax_platforms", "cpu")
    # NOTE: deliberately NOT enabling the persistent compile cache here.
    # Cache hits load AOT results whose machine-feature stamps mismatch
    # this host (cpu_aot_loader warnings) and, worse, make one worker
    # reach the first collective tens of seconds before the other, blowing
    # gloo's 30 s connectFullMesh window.
    from stark_tpu.parallel import distributed as dist

    dist.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from stark_tpu.ops import modmath as mm
    from stark_tpu.parallel.prove_sharded import build_sharded_prover_step
    from stark_tpu.protocol.core import make_example_inputs

    import __graft_entry__ as ge

    mesh = dist.global_mesh_1d()
    d = mesh.devices.size
    assert d == n_procs * devices_per_proc

    n_constraints = max(20, (d * d * 2) // 3 + 2)
    spec, arith, public_wires, params = ge._synthetic(n_constraints)
    assert params.steps >= d * d

    fn = build_sharded_prover_step(
        spec, mesh, params.steps, params.precision, arith.original_steps
    )
    traces, r_mont, k_mont, i2_mont, pubx_mont = make_example_inputs(
        spec, arith, public_wires, params
    )
    xs_full = mm.power_table(spec, params.g2, params.precision)

    shard, repl = P(None, "d"), P(None, None)
    args = (
        dist.put_global_tree(traces, mesh, shard),
        dist.put_global(np.asarray(xs_full), mesh, shard),
        dist.put_global(np.asarray(r_mont), mesh, repl),
        dist.put_global(np.asarray(k_mont), mesh, repl),
        dist.put_global(np.asarray(i2_mont), mesh, repl),
        dist.put_global(np.asarray(pubx_mont), mesh, repl),
    )
    m_root, l_root, l_ev = fn(*args)
    jax.block_until_ready((m_root, l_root))
    if proc_id == 0:
        out = {
            "n_procs": n_procs,
            "devices": d,
            "steps": params.steps,
            "precision": params.precision,
            "m_root": np.asarray(m_root).tolist(),
            "l_root": np.asarray(l_root).tolist(),
        }
        print("MULTIHOST_RESULT " + json.dumps(out), flush=True)
    jax.distributed.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument(
        "--full", action="store_true",
        help="run the FULL proof pipeline (not just the core roots)",
    )
    ap.add_argument("--worker", type=int, default=-1, help="(internal)")
    args = ap.parse_args()

    if args.worker >= 0:
        fn = worker_full if args.full else worker
        fn(args.worker, args.procs, args.devices_per_proc, args.port)
        return 0

    port = args.port
    if port == 0:
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(args.procs):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.abspath(__file__),
                    "--worker",
                    str(pid),
                    "--procs",
                    str(args.procs),
                    "--devices-per-proc",
                    str(args.devices_per_proc),
                    "--port",
                    str(port),
                ]
                + (["--full"] if args.full else []),
                env=env,
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL,
                text=True,
                cwd=repo,
            )
        )
    out, _ = procs[0].communicate(timeout=2400)
    rcs = [procs[0].returncode] + [p.wait(timeout=2400) for p in procs[1:]]
    sys.stdout.write(out)
    if any(rcs):
        print(f"worker return codes: {rcs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
