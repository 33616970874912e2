"""Headline benchmark: STARK prover throughput on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...}.

Setup: a synthetic squaring-chain circuit sized to steps=2^17 (trace domain
2^20 after the 8x LDE blowup). Measures the steady-state device prover core
(8 LDEs + permutation accumulator + quotients + boundaries + linear
combination + both Merkle roots = everything between Fiat-Shamir round
trips) and reports R1CS constraints/second, then the full end-to-end prove,
verify and serving numbers, a phase-synced prove's phase walls and the
device timeline of a traced prove.

vs_baseline: the reference publishes NO numbers and this image has no Rust
toolchain, so the baseline is a documented cost model of the single-core
Rust reference on the same circuit:
  - Montgomery mul (4xu64, ff_derive, no asm): 65 ns
  - blake2s 64-byte compression: 300 ns
  - FFT(n) = n/2*log2(n) muls; 8 iNTT(steps) + 9 NTT(precision)
    (prove.rs:100-184), ~60*precision pointwise muls (quotients, inverses,
    linear comb), ~8*precision hash compressions (m/l/a trees incl. 4-block
    256-byte leaves), FRI ~7*precision muls + ~3*precision compressions.
This model ignores the reference's allocation churn and O(precision) table
materialization, so it FAVORS the reference.

Refuses to run on anything but a GPU backend: a CPU timing is not a device
number.
"""

import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time

import jax


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: backend is {jax.default_backend()!r}, not a GPU")
    from stark_tpu.utils import compile_cache

    compile_cache.enable()
    t_setup = time.time()
    import numpy as np
    from jax.sharding import Mesh

    from stark_tpu.fields.field import BN254_FR as spec
    from stark_tpu.protocol import proof as proof_mod
    from stark_tpu.protocol import runner
    from stark_tpu.protocol.core import build_staged_prover, make_example_inputs
    from stark_tpu.protocol.params import derive_params
    from stark_tpu.r1cs.arithmetize import arithmetize
    from stark_tpu.r1cs.synth import squaring_chain
    from stark_tpu.utils import tracing
    from stark_tpu.utils.profiling import parse_device_trace, phase_walls

    n_constraints = int(os.environ.get("BENCH_CONSTRAINTS", 43690))
    r1cs, wb = squaring_chain(n_constraints)
    witness = [spec.from_bytes_le(w) for w in wb]
    arith = arithmetize(spec, r1cs.constraints, witness, r1cs.header.n_wires, 2)
    params = derive_params(spec, arith.original_steps)
    steps, precision = params.steps, params.precision

    fn = build_staged_prover(spec, steps, precision, arith.original_steps)
    args = make_example_inputs(spec, arith, witness[:2], params)
    # Zb2^-1 is circuit-static and cached per circuit by the real prover
    # (prove.py); the steady-state core step reuses it the same way
    inv_zb2 = fn.prep(args[-1])

    jax.block_until_ready(fn(*args, inv_zb2=inv_zb2))  # compile
    setup_s = time.time() - t_setup

    iters = int(os.environ.get("BENCH_ITERS", 3))
    t0 = time.time()
    for _ in range(iters):
        jax.block_until_ready(fn(*args, inv_zb2=inv_zb2))
    core_s = (time.time() - t0) / iters
    constraints_per_s = n_constraints / core_s

    # single-core Rust reference cost model (see module docstring)
    MUL_NS, HASH_NS = 65e-9, 300e-9
    fft_muls = 8 * (steps / 2) * math.log2(steps) + 9 * (precision / 2) * math.log2(
        precision
    )
    model_s = (
        (fft_muls + 60 * precision + 7 * precision) * MUL_NS
        + 11 * precision * HASH_NS
    )
    ref_constraints_per_s = n_constraints / model_s

    # --- full end-to-end proof (arithmetize + commits + FS + branches +
    # FRI); proofs come back to the host, so each call ends synchronized
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, wb)
    e2e_cold_s = time.time() - t0
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, wb)
    e2e_s = time.time() - t0
    t0 = time.time()
    ok = runner.verify_with_witness(r1cs, wb[:2], proof)
    verify_cold_s = time.time() - t0
    t0 = time.time()
    ok = runner.verify_with_witness(r1cs, wb[:2], proof) and ok
    verify_s = time.time() - t0
    # serving throughput: pipeline 4 proofs (enqueue i+1 while i's arrays
    # stream back) -- the deployment shape of a proving service
    t0 = time.time()
    proofs = runner.prove_many(r1cs, [wb] * 4, pipeline=2)
    many_s = time.time() - t0

    # the unified mesh prover on a 1-device mesh must match the plain one
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    pm = runner.prove_with_witness(r1cs, wb, mesh=mesh)  # compile
    t0 = time.time()
    pm = runner.prove_with_witness(r1cs, wb, mesh=mesh)
    mesh1 = {
        "prove_s": time.time() - t0,
        "byte_identical": proof_mod.to_json(pm) == proof_mod.to_json(proof),
    }

    # phase walls of a synced prove (no profiler: walls must reconcile with
    # the synced wall), then the device timeline of a second synced prove
    # under jax.profiler, segmented at the per-phase barrier kernels
    tracing.reset()
    os.environ["STARK_TPU_SYNC_PHASES"] = "1"
    t0 = time.time()
    runner.prove_with_witness(r1cs, wb)
    synced_s = time.time() - t0
    walls = phase_walls()
    prof_dir = os.environ.get("BENCH_PROFILE_DIR") or tempfile.mkdtemp()
    tracing.reset()
    with jax.profiler.trace(prof_dir):
        runner.prove_with_witness(r1cs, wb)
    timeline = parse_device_trace(prof_dir, tracing.exit_log())
    os.environ["STARK_TPU_SYNC_PHASES"] = "0"

    dev = jax.devices()[0]
    e2e = {
        "prove_s": e2e_s,
        "prove_cold_s": e2e_cold_s,
        "serving_proofs_per_s": len(proofs) / many_s,
        "verify_s": verify_s,
        "verify_cold_s": verify_cold_s,
        "verified": bool(ok),
        "vs_baseline": (n_constraints / e2e_s) / ref_constraints_per_s,
        "host_peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        // 1024,
        "device_peak_bytes": (dev.memory_stats() or {}).get("peak_bytes_in_use"),
        "mesh1": mesh1,
        "profile": {
            "synced_prove_s": synced_s,
            "phase_wall_sum_s": sum(walls.values()),
            "phase_walls_s": dict(sorted(walls.items(), key=lambda kv: -kv[1])),
            "device_timeline": timeline,
        },
    }
    print(
        json.dumps(
            {
                "metric": "prover_core_constraints_per_s",
                "value": constraints_per_s,
                "unit": "constraints/s",
                "vs_baseline": constraints_per_s / ref_constraints_per_s,
                "detail": {
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                        "card": _card(),
                    },
                    "n_constraints": n_constraints,
                    "steps": steps,
                    "precision": precision,
                    "core_step_s": core_s,
                    "setup_compile_s": setup_s,
                    "modeled_single_core_rust_s": model_s,
                    "e2e": e2e,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
