"""On-card smoke test: drive the prover's main path once on one GPU.

    python chip_smoke.py              # phases 1-4 on one card
    python chip_smoke.py --ceiling    # size ceiling only (precision 2^23)
    python chip_smoke.py --four       # sharded prove over a mesh of 4 cards

`--ceiling` proves and verifies a 349,525-constraint chain (steps 2^20,
precision 2^23) and proves the `bits` and `pedersen_test` fixtures against
their goldens. `--four` proves the phase-4 circuit over a 1-D mesh of 4
cards and requires the single-card pinned sha and a verifying proof.

Phases, each printing one JSON line {"phase", "seconds", "passed", ...}:

1. device: refuse anything but a GPU backend (never fall back to the CPU);
   print the card's name and power limit and whether the C++ host runtime
   loaded.
2. primitives at the widths of the steps 2^17 cell (16 limbs, N = 2^20):
   Montgomery multiply, prefix products, batched inversion, the LDE
   (2^17 -> 2^20) against Python-int ground truth, blake2s on a full m-tree
   leaf batch against hashlib, Poseidon against the host implementation,
   and the CRT-engine LDE against the butterfly LDE byte for byte. All of
   it is exact integer arithmetic: the tolerance is zero.
3. the circom fixtures through `stark_tpu.cli` in-process (proof bytes
   equal the pure-Python oracle's goldens), then a few requests through
   `serve.serve` on an in-memory stream.
4. a 43,690-constraint squaring chain (steps 2^17, precision 2^20): cold
   prove, two warm proves, verify, and `prove_many` over 4 witnesses; every
   proof verifies and hashes to the sha256 pinned in
   `tests/fixtures/squaring_chain_43690_proof_sha256.json`.

The last line of stdout is {"ok": true, "device": {...}} and is printed
only when every phase passed. Everything runs in this one process: a second
JAX process on the same card would fail for want of memory.
"""

from __future__ import annotations

import argparse
import faulthandler
import hashlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "tests", "fixtures")
PINNED = os.path.join(FIX, "squaring_chain_43690_proof_sha256.json")
LOG_N, LOG_STEPS = 20, 17  # primitive widths of the steps 2^17 cell
N_CONSTRAINTS = 43690  # steps 2^17, precision 2^20
CEILING_CONSTRAINTS = 349525  # steps 2^20, precision 2^23
WITNESS_SEEDS = (3, 4, 5, 6)  # x0 of the squaring chains proved in phase 4


class PhaseFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def run_phase(name, fn):
    t0 = time.time()
    try:
        info = fn() or {}
    except Exception as e:  # report the phase, then stop the run
        print(
            json.dumps(
                {"phase": name, "seconds": time.time() - t0, "passed": False,
                 "error": f"{type(e).__name__}: {e}"[:2000]}
            ),
            flush=True,
        )
        raise
    print(
        json.dumps({"phase": name, "seconds": time.time() - t0,
                    "passed": True, **info}),
        flush=True,
    )
    return info


def device_phase():
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: JAX backend is {jax.default_backend()!r}, not a "
            "GPU; refusing to run",
            file=sys.stderr,
        )
        sys.exit(2)
    sys.path.insert(0, REPO)
    from stark_tpu import native
    from stark_tpu.utils import compile_cache

    cache = compile_cache.enable()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    d = jax.devices()[0]
    return {
        "device_kind": d.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "nvidia_smi": smi,
        "native_host_runtime": native.available(),
        "compile_cache": cache,
    }


# ---------------------------------------------------------------------------
# phase 2: primitives against plain references
# ---------------------------------------------------------------------------

def _rand_limbs(rng, n, top_limit):
    """(16, n) uint32 limbs of uniform values below top_limit * 2^240."""
    import numpy as np

    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    a[15] = rng.integers(0, top_limit, size=n, dtype=np.uint32)
    return a


def _ints(arr, spec):
    from stark_tpu.ops import modmath as mm

    by = mm.limbs_to_bytes_le_np(arr, spec)
    return [int.from_bytes(row.tobytes(), "little") for row in by]


def primitives_phase():
    import numpy as np
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import parity_oracle as oracle
    from stark_tpu.fields.field import BLS12_381_FR, BN254_FR as spec
    from stark_tpu.ops import blake2s as b2
    from stark_tpu.ops import modmath as mm
    from stark_tpu.ops import ntt
    from stark_tpu.ops.poseidon import poseidon_digest, poseidon_hash_pairs

    p, N, steps = spec.p, 1 << LOG_N, 1 << LOG_STEPS
    R = spec.r_mod_p
    r_inv = pow(R, -1, p)
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(N, min(N, 4096), replace=False))
    out = {}

    # Montgomery multiply: out = a*b*R^-1
    a = _rand_limbs(rng, N, 0x3000)
    b = _rand_limbs(rng, N, 0x3000)
    got = np.asarray(jax.block_until_ready(mm.mmul(spec, jnp.asarray(a), jnp.asarray(b))))
    ai, bi, gi = _ints(a[:, idx], spec), _ints(b[:, idx], spec), _ints(got[:, idx], spec)
    check(all(g == x * y * r_inv % p for x, y, g in zip(ai, bi, gi)), "mmul")
    out["mmul_positions"] = len(idx)

    # prefix products, both directions, every position: in Montgomery form
    # P_i = prod_{j<=i} (v_j R^-1) * R
    v = _rand_limbs(rng, N, 0x3000)
    vi = _ints(v, spec)
    want, acc = [], R
    for x in vi:
        acc = acc * x % p * r_inv % p
        want.append(acc)
    fwd = mm.prefix_prod(spec, jnp.asarray(v))
    check(_ints(np.asarray(fwd), spec) == want, "prefix_prod forward")
    want_rev, acc = [0] * N, R
    for i in range(N - 1, -1, -1):
        acc = acc * vi[i] % p * r_inv % p
        want_rev[i] = acc
    rev = mm.prefix_prod(spec, jnp.asarray(v), True)
    check(_ints(np.asarray(rev), spec) == want_rev, "prefix_prod reverse")
    out["prefix_prod_positions"] = 2 * N

    # batched inversion with zero skipping: inv(x)_mont * x_mont = R^2
    z = rng.choice(N, 16, replace=False)
    v[:, z] = 0
    inv = _ints(np.asarray(mm.multi_inv(spec, jnp.asarray(v))), spec)
    vi = _ints(v, spec)
    r2 = R * R % p
    check(
        all((y == 0) if x == 0 else (x * y % p == r2) for x, y in zip(vi, inv)),
        "multi_inv",
    )
    out["multi_inv_positions"] = N

    # LDE 2^17 -> 2^20: on the coset g2^r * <g1> the extension equals an
    # order-2^17 DFT of the interpolant's coefficients scaled by g2^(r*i).
    g2 = spec.root_of_unity(N)
    g1 = pow(g2, N // steps, p)
    trace = _rand_limbs(rng, steps, 0x3000)
    ti = _ints(trace, spec)
    os.environ["STARK_TPU_MXU"] = "0"
    lde = ntt.make_best_lde(spec, g1, g2, steps, N)
    ev = np.asarray(lde(jnp.asarray(trace)))
    coeffs = oracle.inv_best_fft(ti, g1, LOG_STEPS)
    for r in (0, 5):
        c = pow(g2, r, p)
        scaled, s = [], 1
        for x in coeffs:
            scaled.append(x * s % p)
            s = s * c % p
        check(
            _ints(ev[:, r :: N // steps], spec) == oracle.best_fft(scaled, g1, LOG_STEPS),
            f"lde coset {r}",
        )
    out["lde_positions"] = 2 * steps

    # the CRT engine must give the same bytes
    os.environ["STARK_TPU_MXU"] = "1"
    try:
        lde_crt = ntt.make_best_lde(spec, g1, g2, steps, N)
        ev_crt = np.asarray(lde_crt(jnp.asarray(trace)))
    finally:
        os.environ["STARK_TPU_MXU"] = "0"
    check(np.array_equal(ev, ev_crt), "crt lde bytes")
    out["crt_lde_equal"] = True

    # blake2s over a full m-tree leaf batch (256-byte leaves)
    msgs = rng.integers(0, 1 << 32, size=(64, N), dtype=np.uint32)
    dig = b2.digest_words_to_bytes_np(
        b2.blake2s_words(jnp.asarray(msgs), 256)
    )
    for i in idx:
        m = msgs[:, i].astype("<u4").tobytes()
        check(
            dig[i].tobytes() == hashlib.blake2s(m).digest(), "blake2s"
        )
    out["blake2s_positions"] = len(idx)

    # Poseidon 2-to-1 over BLS12-381 Fr
    bls = BLS12_381_FR
    n_pos = 1 << 14
    left = _rand_limbs(rng, n_pos, 0x7000)
    right = _rand_limbs(rng, n_pos, 0x7000)
    dig = mm.limbs_to_bytes_le_np(
        np.asarray(poseidon_hash_pairs(bls, jnp.asarray(left), jnp.asarray(right))),
        bls,
    )
    sample = idx[idx < n_pos][:64]
    for i in sample:
        msg = (
            mm.limbs_to_bytes_le_np(left[:, i : i + 1], bls)[0].tobytes()
            + mm.limbs_to_bytes_le_np(right[:, i : i + 1], bls)[0].tobytes()
        )
        check(dig[i].tobytes() == poseidon_digest(msg), "poseidon")
    out["poseidon_positions"] = len(sample)
    return out


# ---------------------------------------------------------------------------
# phase 3: circom fixtures through the CLI and the stdio worker
# ---------------------------------------------------------------------------

def _golden(name):
    with open(os.path.join(FIX, name)) as f:
        return f.read()


def _cli_fixture(tmp, name, golden, digest=None):
    from stark_tpu import cli

    out = os.path.join(tmp, f"{name}_{digest or 'blake2s'}.json")
    argv = ["run", os.path.join(FIX, f"{name}.r1cs"),
            os.path.join(FIX, f"{name}.wtns"), out]
    if digest:
        argv += ["--digest", digest]
    t0 = time.time()
    check(cli.main(argv) == 0, f"cli run {name}")
    with open(out) as f:
        check(f.read() == _golden(golden), f"{name} proof != golden {golden}")
    return time.time() - t0


def fixtures_phase():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["compute_s"] = _cli_fixture(tmp, "compute", "compute_proof_golden.json")
        out["compute_poseidon_s"] = _cli_fixture(
            tmp, "compute", "compute_proof_poseidon_golden.json", "poseidon"
        )
        out["poseidon3_s"] = _cli_fixture(
            tmp, "poseidon3_test", "poseidon3_proof_golden.json"
        )

        from stark_tpu.serve import serve

        r1cs = os.path.join(FIX, "compute.r1cs")
        wtns = os.path.join(FIX, "compute.wtns")
        pj = os.path.join(tmp, "served.json")
        reqs = [
            {"id": 1, "method": "ping"},
            {"id": 2, "method": "prove",
             "params": {"r1cs": r1cs, "wtns": wtns, "proof_json": pj}},
            {"id": 3, "method": "verify",
             "params": {"r1cs": r1cs, "wtns": wtns, "proof_json": pj}},
            {"id": 4, "method": "run",
             "params": {"r1cs": r1cs, "wtns": wtns, "inline": True}},
            {"id": 5, "method": "shutdown"},
        ]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
        stdout = io.StringIO()
        check(serve(stdin, stdout) == 0, "serve exit")
        resp = {}
        for line in stdout.getvalue().splitlines():
            if line.startswith("RPC "):
                msg = json.loads(line[4:])
                resp[msg["id"]] = msg
        for i in range(1, 6):
            check("result" in resp.get(i, {}), f"serve request {i}: {resp.get(i)}")
        gold = _golden("compute_proof_golden.json")
        with open(pj) as f:
            check(f.read() == gold, "served proof != golden")
        check(resp[3]["result"]["verified"], "served verify")
        check(resp[4]["result"]["verified"], "served run verify")
        check(resp[4]["result"]["proof"] == gold, "served inline proof")
        out["serve_prove_s"] = resp[2]["result"]["seconds"]
    return out


# ---------------------------------------------------------------------------
# phase 4: a SHA-256-sized circuit
# ---------------------------------------------------------------------------

def _sha(proof):
    from stark_tpu.protocol import proof as proof_mod

    return hashlib.sha256(proof_mod.to_json(proof).encode()).hexdigest()


def _pinned():
    with open(PINNED) as f:
        return json.load(f)


def _peak_bytes():
    import jax

    return max(
        (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        for d in jax.local_devices()
    )


def squaring_phase():
    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    pinned = _pinned()
    r1cs, wb = squaring_chain(N_CONSTRAINTS, x0=WITNESS_SEEDS[0])
    want = pinned[str(WITNESS_SEEDS[0])]
    out = {}
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, wb)
    out["prove_cold_s"] = time.time() - t0
    check(_sha(proof) == want, f"cold proof sha {_sha(proof)} != pinned {want}")
    for i in (1, 2):
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, wb)
        out[f"prove_warm{i}_s"] = time.time() - t0
        check(_sha(proof) == want, f"warm proof {i} sha {_sha(proof)}")
    for i in (1, 2):
        t0 = time.time()
        ok = runner.verify_with_witness(r1cs, wb[:2], proof)
        out[f"verify{i}_s"] = time.time() - t0
        check(ok, "verify")

    batch = [squaring_chain(N_CONSTRAINTS, x0=x)[1] for x in WITNESS_SEEDS]
    t0 = time.time()
    proofs = runner.prove_many(r1cs, batch, pipeline=2)
    out["prove_many_4_s"] = time.time() - t0
    for x, wbx, pr in zip(WITNESS_SEEDS, batch, proofs):
        check(_sha(pr) == pinned[str(x)], f"prove_many x0={x} sha {_sha(pr)}")
        check(runner.verify_with_witness(r1cs, wbx[:2], pr), f"verify x0={x}")
    out["proof_sha256"] = want
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


# ---------------------------------------------------------------------------
# --ceiling and --four
# ---------------------------------------------------------------------------

def ceiling_phase():
    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    r1cs, wb = squaring_chain(CEILING_CONSTRAINTS)
    out = {}
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, wb)
    out["prove_cold_s"] = time.time() - t0
    t0 = time.time()
    check(runner.verify_with_witness(r1cs, wb[:2], proof), "ceiling verify")
    out["verify_s"] = time.time() - t0
    out["proof_sha256"] = _sha(proof)
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def big_fixtures_phase():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["bits_s"] = _cli_fixture(tmp, "bits", "bits_proof_golden.json")
        out["pedersen_s"] = _cli_fixture(
            tmp, "pedersen_test", "pedersen_proof_golden.json"
        )
    return out


def four_phase():
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from stark_tpu.protocol import runner
    from stark_tpu.r1cs.synth import squaring_chain

    check(len(jax.devices()) >= 4, f"need 4 cards, have {len(jax.devices())}")
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    r1cs, wb = squaring_chain(N_CONSTRAINTS, x0=WITNESS_SEEDS[0])
    want = _pinned()[str(WITNESS_SEEDS[0])]
    out = {}
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, wb, mesh=mesh)
    out["prove_cold_s"] = time.time() - t0
    check(_sha(proof) == want, f"sharded sha {_sha(proof)} != pinned {want}")
    t0 = time.time()
    check(runner.verify_with_witness(r1cs, wb[:2], proof), "sharded verify")
    out["verify_cold_s"] = time.time() - t0
    out["proof_sha256"] = want
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def _join_warmup(timeout=600.0):
    """Let the background compile pool finish before the process exits."""
    deadline = time.time() + timeout
    for t in threading.enumerate():
        if t.name == "stark-warmup":
            t.join(max(0.0, deadline - time.time()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ceiling", action="store_true",
                      help="only the size ceiling: steps 2^20, precision 2^23")
    mode.add_argument("--four", action="store_true",
                      help="only the sharded prove over a mesh of 4 cards")
    args = ap.parse_args(argv)
    # a run cut at its time limit leaves every thread's stack on stderr
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    dev = run_phase("device", device_phase)
    try:
        if args.four:
            run_phase("four_cards", four_phase)
        elif args.ceiling:
            run_phase("ceiling", ceiling_phase)
            run_phase("big_fixtures", big_fixtures_phase)
        else:
            run_phase("primitives", primitives_phase)
            run_phase("fixtures", fixtures_phase)
            run_phase("squaring_2^17", squaring_phase)
    except Exception:
        return 1
    finally:
        _join_warmup()

    import jax

    print(dev["nvidia_smi"])
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
