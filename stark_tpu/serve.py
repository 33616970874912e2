"""Persistent proving worker: line-delimited JSON-RPC over stdio.

Restores the reference napi binding's in-process call semantics
(`/root/reference/packages/napi/src/lib.rs:23-30`: prove/verify without
paying process startup per call): one long-lived Python/JAX process holds
the compiled executables, the parsed-circuit caches, and the
device-resident circuit statics, so repeat calls pay only the proof itself.

Protocol (one JSON object per line on stdin; one `RPC {...}` line per
response on stdout — the prefix keeps stray library prints from corrupting
the stream):

    {"id": 1, "method": "prove",
     "params": {"r1cs": "c.r1cs", "wtns": "w.wtns", "proof_json": "p.json"}}
    -> RPC {"id": 1, "result": {"ok": true, "seconds": 1.02,
                                "proof_bytes": 3649501}}

Methods: ping, prove, verify, run (prove+verify), warmup, shutdown.
`prove` accepts "inline": true to return the proof JSON in the response
instead of writing a file; `prove`/`verify` accept "digest":
"blake2s"|"poseidon" (the reference's `H: Digest` parameter). Errors come
back as {"id", "error": {"message", "type"}} — the worker never dies on a
bad request.

Used by `packages/node/index.js` (spawned once, shared by every call) and
directly scriptable: `python -m stark_tpu.cli serve`.
"""

from __future__ import annotations

import json
import os
import sys
import time


class _CircuitCache:
    """Parsed circuits keyed by (path, mtime, size); holds the arith/LDE
    caches the runner attaches to the parsed object, so repeat requests for
    one circuit skip parse + arithmetize + static uploads."""

    def __init__(self, max_entries: int = 8):
        self._d: dict = {}
        self._max = max_entries

    def get(self, path: str):
        from stark_tpu.r1cs.reader import read_r1cs

        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        hit = self._d.get(key)
        if hit is not None:
            return hit
        with open(path, "rb") as f:
            r1cs = read_r1cs(f.read())
        if len(self._d) >= self._max:
            self._d.pop(next(iter(self._d)))
        self._d[key] = r1cs
        return r1cs


def _read_witness(path: str):
    from stark_tpu.r1cs.reader import read_witness

    with open(path, "rb") as f:
        return read_witness(f.read())


def serve(stdin=None, stdout=None) -> int:
    """Blocking request loop; returns on EOF or the shutdown method."""
    from stark_tpu.protocol import proof as proof_mod
    from stark_tpu.protocol import runner

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    circuits = _CircuitCache()

    def _emit(obj):
        stdout.write("RPC " + json.dumps(obj, separators=(",", ":")) + "\n")
        stdout.flush()

    _emit({"id": None, "result": {"ok": True, "event": "ready"}})

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        req_id = None
        try:
            req = json.loads(line)
            req_id = req.get("id")
            method = req.get("method")
            prm = req.get("params") or {}
            t0 = time.time()

            if method == "ping":
                result = {"ok": True}

            elif method == "shutdown":
                _emit({"id": req_id, "result": {"ok": True}})
                return 0

            elif method == "warmup":
                from stark_tpu.protocol.params import derive_params
                from stark_tpu.protocol.warmup import warmup_prover
                from stark_tpu.r1cs.arithmetize import arithmetize

                r1cs = circuits.get(prm["r1cs"])
                spec = runner._spec_for(r1cs)
                h = r1cs.header
                n_pub = 1 + h.n_public_inputs + h.n_public_outputs
                arith = arithmetize(
                    spec, r1cs.constraints, None, h.n_wires, n_pub
                )
                params = derive_params(spec, arith.original_steps)
                n = warmup_prover(
                    spec,
                    params.steps,
                    params.precision,
                    arith.original_steps,
                    len(arith.public_first_indices),
                    threads=prm.get("threads"),
                    n_wires=(h.n_wires if runner._device_arith() else 0),
                )
                result = {"ok": True, "warmed": n, "steps": params.steps}

            elif method in ("prove", "verify", "run"):
                digest = prm.get("digest", "blake2s")
                r1cs = circuits.get(prm["r1cs"])
                witness = _read_witness(prm["wtns"])
                n_pub = (
                    1
                    + r1cs.header.n_public_inputs
                    + r1cs.header.n_public_outputs
                )
                result = {"ok": True}
                if method in ("prove", "run"):
                    proof = runner.prove_with_witness(
                        r1cs, witness, digest=digest
                    )
                    pj = proof_mod.to_json(proof)
                    result["proof_bytes"] = len(pj)
                    if prm.get("inline"):
                        result["proof"] = pj
                    if prm.get("proof_json"):
                        with open(prm["proof_json"], "w") as f:
                            f.write(pj)
                if method in ("verify", "run"):
                    if method == "verify":
                        with open(prm["proof_json"]) as f:
                            proof = proof_mod.from_json(f.read())
                    ok = runner.verify_with_witness(
                        r1cs, witness[:n_pub], proof, digest=digest
                    )
                    result["verified"] = bool(ok)

            else:
                raise ValueError(f"unknown method {method!r}")

            result["seconds"] = round(time.time() - t0, 3)
            _emit({"id": req_id, "result": result})
        except Exception as e:  # keep serving; report the failure
            _emit(
                {
                    "id": req_id,
                    "error": {
                        "type": type(e).__name__,
                        "message": str(e)[:2000],
                    },
                }
            )
    return 0
