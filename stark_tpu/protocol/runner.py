"""Top-level prove/verify entry points over parsed circuits.

Parity with `prove_with_witness` / `verify_with_witness` and the file-path
wrappers (`/root/reference/packages/r1cs-stark/src/run.rs:310-625`).
"""

from __future__ import annotations

import os

import numpy as np

from stark_tpu import native
from stark_tpu.fields.field import BN254_FR, FieldSpec
from stark_tpu.protocol import proof as proof_mod
from stark_tpu.protocol.prove import mk_r1cs_proof
from stark_tpu.protocol.verify import verify_r1cs_proof
from stark_tpu.r1cs.arithmetize import Arithmetization, arithmetize
from stark_tpu.r1cs.reader import R1csContents, read_r1cs, read_witness
from stark_tpu.utils.tracing import phase


def _use_native() -> bool:
    return os.environ.get("STARK_TPU_NATIVE", "1") != "0" and native.available()

# the reference hard-asserts the circuit field is the BN254/circom scalar
# field (run.rs:344-350); same limitation here (TargetFF = Fp TODO upstream)
_BN254_PRIME_LE = bytes(
    [
        1, 0, 0, 240, 147, 245, 225, 67, 145, 112, 185, 121, 72, 232, 51, 40,
        93, 88, 129, 129, 182, 69, 80, 184, 41, 160, 49, 225, 114, 78, 100, 48,
    ]
)


def _spec_for(r1cs: R1csContents) -> FieldSpec:
    assert r1cs.header.prime_number == _BN254_PRIME_LE, (
        "only the BN254/circom scalar field is supported (like the reference)"
    )
    return BN254_FR


def prove_with_witness(
    r1cs: R1csContents, witness_bytes: list[bytes], mesh=None,
    digest: str = "blake2s",
):
    """run.rs:310-452. `mesh`: optional 1-D device mesh; the unified prover
    (same staged jits + device transcript for every geometry) shards the
    evaluation domain over it (see `core.build_proof_stages`)."""
    spec = _spec_for(r1cs)
    h = r1cs.header
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    public_wires = [spec.from_bytes_le(w) for w in witness_bytes[:n_pub]]
    assert (
        spec.from_bytes_le(witness_bytes[0]) == 1
    ), "witness[0] must be 1"  # run.rs:358

    with phase("arithmetize"):
        if _use_native():
            # C++ arithmetizer; numpy columns flow straight to the device
            wit_np = np.zeros((h.n_wires, 32), np.uint8)
            for i, wb in enumerate(witness_bytes):
                wit_np[i, : len(wb)] = np.frombuffer(wb[:32], np.uint8)
            if _device_arith():
                # everything except the witness is circuit-static: cache the
                # witness-less arithmetization (and its device uploads) on
                # the parsed circuit, so repeat proves only move the witness
                arith = getattr(r1cs, "_dev_arith_cache", None)
                if arith is None:
                    flat = native.flat_from_contents(r1cs)
                    arith = _arith_native(spec, flat, None, n_pub)
                    r1cs._dev_arith_cache = arith
                arith.witness_le = wit_np
            else:
                flat = native.flat_from_contents(r1cs)
                arith = _arith_native(spec, flat, wit_np, n_pub)
        else:
            witness = [spec.from_bytes_le(w) for w in witness_bytes]
            arith = arithmetize(
                spec, r1cs.constraints, witness, h.n_wires, len(public_wires)
            )
    return mk_r1cs_proof(
        spec, arith, public_wires, h.n_constraints, h.n_wires, mesh=mesh,
        digest=digest,
    )


def prove_many(
    r1cs: R1csContents, witness_bytes_list, pipeline: int = 2, mesh=None
) -> list:
    """Serving-mode throughput: prove many witnesses of ONE circuit.

    The prover enqueues each proof as a single async device-dispatch chain
    (all Fiat-Shamir challenges are device-derived), so proofs pipeline
    naturally: while proof i's arrays stream back and format on the host,
    proof i+1's dispatches (and the host arithmetization for i+2) already
    run. `pipeline` bounds the in-flight chains (each holds O(precision)
    device arrays; 2 was sized for a 16 GB device at steps 2^17, and is not
    re-tuned for 80 GB yet).

    No reference counterpart (main.rs proves one file per process); this is
    the deployment shape a proving service wants.
    """
    from stark_tpu.protocol.prove import (
        enqueue_r1cs_proof,
        materialize_r1cs_proof,
    )

    spec = _spec_for(r1cs)
    h = r1cs.header
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    flat = native.flat_from_contents(r1cs) if _use_native() else None
    # with device arithmetization everything except the witness is
    # circuit-static: run the arithmetizer ONCE and swap the witness per
    # proof (the static device uploads are cached on the arith object)
    shared_arith = (
        _arith_native(spec, flat, None, n_pub)
        if flat is not None and _device_arith()
        else None
    )

    def _wit_np(witness_bytes):
        wit_np = np.zeros((h.n_wires, 32), np.uint8)
        for i, wb in enumerate(witness_bytes):
            wit_np[i, : len(wb)] = np.frombuffer(wb[:32], np.uint8)
        return wit_np

    def _arith(witness_bytes):
        public_wires = [spec.from_bytes_le(w) for w in witness_bytes[:n_pub]]
        assert public_wires[0] == 1, "witness[0] must be 1"
        if shared_arith is not None:
            shared_arith.witness_le = _wit_np(witness_bytes)
            return shared_arith, public_wires
        if flat is not None:
            return _arith_native(spec, flat, _wit_np(witness_bytes), n_pub), public_wires
        witness = [spec.from_bytes_le(w) for w in witness_bytes]
        return (
            arithmetize(spec, r1cs.constraints, witness, h.n_wires, n_pub),
            public_wires,
        )

    # pre-upload witnesses one proof ahead (single-device serving): the
    # H2D starts asynchronously while the previous proof's arrays stream
    # back, hiding the witness transfer behind the materialize
    pre_upload = mesh is None and shared_arith is not None
    wit_devs: list = [None] * len(witness_bytes_list)

    def _upload(i):
        if pre_upload and wit_devs[i] is None:
            import jax as _jax

            wit_devs[i] = _jax.device_put(_wit_np(witness_bytes_list[i]))

    proofs: list = []
    in_flight: list = []
    for i, wb in enumerate(witness_bytes_list):
        arith, public_wires = _arith(wb)
        if pre_upload:
            _upload(i)
            arith.witness_le = wit_devs[i]
        in_flight.append(
            enqueue_r1cs_proof(
                spec, arith, public_wires, h.n_constraints, h.n_wires, mesh=mesh
            )
        )
        wit_devs[i] = None  # the enqueued chain holds its own reference
        if i + 1 < len(witness_bytes_list):
            _upload(i + 1)
        if len(in_flight) >= pipeline:
            proofs.append(materialize_r1cs_proof(spec, in_flight.pop(0)))
    while in_flight:
        proofs.append(materialize_r1cs_proof(spec, in_flight.pop(0)))
    return proofs


def _device_arith() -> bool:
    """Derive S/P on device from the witness (gather + gated scan) instead
    of computing them on host and shipping two full trace columns. Default
    on; STARK_TPU_DEVICE_ARITH=0 restores the host path."""
    return os.environ.get("STARK_TPU_DEVICE_ARITH", "1") != "0"


def _arith_native(spec, flat, witness_np, n_pub) -> Arithmetization:
    """FlatArithmetization -> the Arithmetization shape the prover consumes,
    with columns left as numpy arrays (the device path converts them
    vectorized; no python-int round trip). With device arithmetization the
    host never computes S/P at all: the C++ arithmetizer runs witness-less
    (K/flags/permutation only) and the prover derives S/P on device from
    the attached witness + per-slot wire ids."""
    from stark_tpu.r1cs.arithmetize import slot_wire_ids_np

    dev = _device_arith()
    fa = native.arithmetize_flat(
        flat, None if dev else witness_np, spec.p.to_bytes(32, "little"), n_pub
    )
    n = fa.original_steps
    return Arithmetization(
        witness_trace=None if dev else fa.s,
        computational_trace=None if dev else fa.p,
        coefficients=fa.k,
        flag0=np.ones(n, dtype=np.uint8),
        flag1=fa.flag1,
        flag2=fa.flag2,
        permuted_indices=fa.permuted_indices,
        public_first_indices=fa.public_first_indices,
        last_coeff_list=fa.last_coeff_list,
        slot_wire_ids=(
            slot_wire_ids_np(flat.ncoeffs, flat.wire_ids, flat.n_wires)
            if dev
            else None
        ),
        witness_le=witness_np if dev else None,
    )


def prove_with_witness_native(r1cs_bytes: bytes, wtns_bytes: bytes):
    """File-bytes prove through the C++ parser/arithmetizer fast path."""
    flat = native.read_r1cs_flat(r1cs_bytes)
    assert flat.prime_number == _BN254_PRIME_LE
    spec = BN254_FR
    with phase("parse+arithmetize"):
        witness_np = native.read_witness_flat(wtns_bytes)
        n_pub = 1 + flat.n_public_inputs + flat.n_public_outputs
        arith = _arith_native(spec, flat, witness_np, n_pub)
    w0 = int.from_bytes(witness_np[0].tobytes(), "little") % spec.p
    assert w0 == 1, "witness[0] must be 1"  # run.rs:358
    public_wires = [
        int.from_bytes(witness_np[i].tobytes(), "little") % spec.p
        for i in range(n_pub)
    ]
    return mk_r1cs_proof(spec, arith, public_wires, flat.n_constraints, flat.n_wires)


def verify_with_witness(
    r1cs: R1csContents, public_wires_bytes: list[bytes], proof,
    digest: str = "blake2s",
) -> bool:
    spec = _spec_for(r1cs)
    h = r1cs.header
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    public_wires = [spec.from_bytes_le(w) for w in public_wires_bytes]
    assert public_wires[0] == 1

    # verifier-side re-derivation without the witness (run.rs:482-511),
    # through the C++ arithmetizer when available (numpy columns flow to
    # the device without a python-int round trip); cached per circuit
    with phase("v_arithmetize"):
        if _use_native():
            arith = getattr(r1cs, "_v_arith_cache", None)
            if arith is None:
                flat = native.flat_from_contents(r1cs)
                arith = _arith_native(spec, flat, None, n_pub)
                arith.witness_le = None  # verifier never sees the witness
                r1cs._v_arith_cache = arith
        else:
            arith = arithmetize(
                spec, r1cs.constraints, None, h.n_wires, len(public_wires)
            )

    # keep the circuit-static column LDEs resident for repeat verifies of
    # one circuit when they fit comfortably (6*L*4*precision bytes; ~400 MB
    # at domain 2^20). STARK_TPU_VERIFY_CACHE=0/1 overrides the size gate.
    from stark_tpu.protocol.params import derive_params as _dp

    cache_env = os.environ.get("STARK_TPU_VERIFY_CACHE", "auto")
    precision = _dp(spec, arith.original_steps).precision
    want_cache = (
        cache_env == "1"
        or (cache_env == "auto" and 6 * spec.num_limbs * 4 * precision <= 512 << 20)
    )
    ev_cache = None
    if want_cache:
        ev_cache = getattr(r1cs, "_v_ev_cache", None)
        if ev_cache is None:
            ev_cache = {}
            r1cs._v_ev_cache = ev_cache
    return verify_r1cs_proof(
        spec,
        proof,
        public_wires,
        arith.public_first_indices,
        arith.permuted_indices,
        arith.coefficients,
        arith.flag0,
        arith.flag1,
        arith.flag2,
        h.n_constraints,
        h.n_wires,
        ev_cache=ev_cache,
        digest=digest,
    )


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def prove_with_file_path(
    r1cs_path, witness_path, proof_json_path, digest: str = "blake2s"
) -> None:
    if _use_native() and digest == "blake2s":
        proof = prove_with_witness_native(_read(r1cs_path), _read(witness_path))
    else:
        r1cs = read_r1cs(_read(r1cs_path))
        witness = read_witness(_read(witness_path))
        proof = prove_with_witness(r1cs, witness, digest=digest)
    with open(proof_json_path, "w") as f:
        f.write(proof_mod.to_json(proof))


def verify_with_file_path(
    r1cs_path, witness_path, proof_json_path, digest: str = "blake2s"
) -> None:
    r1cs = read_r1cs(_read(r1cs_path))
    witness = read_witness(_read(witness_path))
    with open(proof_json_path) as f:
        proof = proof_mod.from_json(f.read())
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    public_wires = witness[:n_pub]
    assert verify_with_witness(r1cs, public_wires, proof, digest=digest)


def run_with_file_path(
    r1cs_path, witness_path, proof_json_path, digest: str = "blake2s"
) -> None:
    """prove + serialize + verify, like run.rs:590-625.

    The reference also dumps the witness JSON to a hardcoded
    ./tests/sha256_2_test.wtns.json (run.rs:609-611); that quirk mutates
    checked-in content when run from a repo root, so it is opt-in here via
    STARK_TPU_WTNS_DUMP=1 (proof bytes do not depend on it)."""
    r1cs = read_r1cs(_read(r1cs_path))
    witness = read_witness(_read(witness_path))

    if os.environ.get("STARK_TPU_WTNS_DUMP") == "1" and os.path.isdir("./tests"):
        wtns_json_path = "./tests/sha256_2_test.wtns.json"
        ints = [int.from_bytes(w, "little") for w in witness]
        with open(wtns_json_path, "w") as f:
            f.write("[" + ", ".join(str(v) for v in ints) + "]")

    if _use_native() and digest == "blake2s":
        proof = prove_with_witness_native(_read(r1cs_path), _read(witness_path))
    else:
        proof = prove_with_witness(r1cs, witness, digest=digest)
    with open(proof_json_path, "w") as f:
        f.write(proof_mod.to_json(proof))

    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    public_wires = witness[:n_pub]
    assert verify_with_witness(r1cs, public_wires, proof, digest=digest)
