"""Device times of the prover's hot operations at the steps 2^17 cell's
shapes (16 limbs; trace 2^17, domain 2^20), on one GPU.

    python scripts/profile_ops.py            # per-op times
    python scripts/profile_ops.py --prove    # the 2^17 prove, in its own process

For each op: the mean wall time over a few calls that end in
`block_until_ready`, the device time from a `jax.profiler` trace of one
call (`utils.profiling.parse_device_trace`), and the least bytes the op
must move through device memory with the rate that the device time gives
them (no peak is assumed). Ops:

* `mmul` -- one Montgomery multiply over (16, 2^20);
* `lde` -- one butterfly LDE 2^17 -> 2^20;
* `leaf_hash` -- blake2s over the m-tree's 2^20 256-byte leaves;
* `prefix_prod` -- the prefix product at the accumulator's (16, 2^17)
  and at (16, 2^20);
* `minv_scalar` -- the accumulator's one Fermat inverse on (16, 1).

`--prove` instead times a cold and three warm 2^17 proves, then traces one
phase-synced prove (device busy time, idle share, per-phase device time).
Run it as its own process: the card holds one JAX process at a time.
Prints one JSON line per measurement; refuses a non-GPU backend.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np


def _rand(rng, shape):
    a = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    a[15] = rng.integers(0, 0x3000, size=shape[1:], dtype=np.uint32)
    return jnp.asarray(a)


def _measure(name, fn, args, min_bytes, iters=5, **extra):
    from stark_tpu.utils.profiling import parse_device_trace

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    wall = (time.perf_counter() - t0) / iters
    d = tempfile.mkdtemp()
    with jax.profiler.trace(d):
        jax.block_until_ready(fn(*args))
    tl = parse_device_trace(d) or {}
    dev = tl.get("device_busy_s")
    rec = {
        "op": name, "wall_s": wall, "device_s": dev,
        "device_idle_share": tl.get("idle_share"),
        "min_bytes": min_bytes,
        "min_bytes_per_device_s": min_bytes / dev if dev else None,
        "top_kernels_ms": dict(list(tl.get("top_kernels_ms", {}).items())[:4]),
        **extra,
    }
    print(json.dumps(rec), flush=True)
    return rec


def ops(log_n: int = 20, log_steps: int = 17):
    from stark_tpu.fields.field import BN254_FR as spec
    from stark_tpu.ops import blake2s as b2
    from stark_tpu.ops import modmath as mm
    from stark_tpu.ops import ntt

    rng = np.random.default_rng(0)
    N, steps = 1 << log_n, 1 << log_steps
    a, b = _rand(rng, (16, N)), _rand(rng, (16, N))
    _measure("mmul", jax.jit(lambda x, y: mm.mmul(spec, x, y)), (a, b), 3 * 64 * N)

    g2 = spec.root_of_unity(N)
    g1 = pow(g2, N // steps, spec.p)
    plan = ntt.make_lde_plan(spec, g1, g2, steps, N)
    lde = jax.jit(lambda t, pl: ntt.lde(spec, t, pl))
    _measure("lde", lde, (_rand(rng, (16, steps)), plan), 64 * (steps + N))

    msgs = jnp.asarray(rng.integers(0, 1 << 32, size=(64, N), dtype=np.uint32))
    leaf = jax.jit(lambda m: b2.blake2s_words(m, 256))
    _measure("leaf_hash", leaf, (msgs,), 4 * (64 + 8) * N)

    scan = jax.jit(lambda x: mm.prefix_prod(spec, x))
    for n in (steps, N):
        _measure("prefix_prod", scan, (_rand(rng, (16, n)),), 2 * 64 * n, n=n)

    x = _rand(rng, (16, 1))
    _measure("minv_scalar", jax.jit(lambda y: mm.minv(spec, y)), (x,), 128)


def prove(n_constraints: int = 43690) -> None:
    """Cold and warm 2^17 prove times, then one traced synced prove."""
    import hashlib

    from stark_tpu.protocol import proof as proof_mod
    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    r1cs, wb = squaring_chain(n_constraints)
    t0 = time.perf_counter()
    proof = runner.prove_with_witness(r1cs, wb)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        proof = runner.prove_with_witness(r1cs, wb)
        warm.append(time.perf_counter() - t0)
    sha = hashlib.sha256(proof_mod.to_json(proof).encode()).hexdigest()
    print(json.dumps({"op": "prove_2^17", "cold_s": cold, "warm_s": warm,
                      "sha256": sha}), flush=True)

    # one phase-synced warm prove under the profiler: device busy time,
    # idle share and per-phase device time
    from stark_tpu.utils import tracing
    from stark_tpu.utils.profiling import parse_device_trace, phase_walls

    os.environ["STARK_TPU_SYNC_PHASES"] = "1"
    runner.prove_with_witness(r1cs, wb)  # compiles the barrier
    tracing.reset()
    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        runner.prove_with_witness(r1cs, wb)
    traced = time.perf_counter() - t0
    tl = parse_device_trace(d, tracing.exit_log())
    print(json.dumps({"op": "prove_2^17_traced", "wall_s": traced,
                      "phase_walls_s": phase_walls(), "device_timeline": tl}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prove", action="store_true")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit(f"profile_ops.py: backend is {jax.default_backend()!r}, not a GPU")
    from stark_tpu.utils import compile_cache

    compile_cache.enable()
    if args.prove:
        return prove()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    ops()


if __name__ == "__main__":
    main()
