"""Mesh-sharded prover entry points — now the SAME prover as single-chip.

Round 2 kept a separate eager prover here (host transcript, per-stage
syncs, Pallas force-disabled). It is gone: `protocol.prove.enqueue_r1cs_proof`
takes a `mesh` argument and runs the identical orchestration for every
geometry — device-resident Fiat-Shamir transcript
(`protocol/device_transcript.py`), staged jits, ONE materializing
device->host transfer — with a single mesh-dependent stage (`columns`,
see `core.build_proof_stages`):

* d=1: the single-device engine — the four-step factorization is the
  identity decomposition at d=1, so this IS the sharded kernel's
  degenerate case;
* d>1: the four-step NTT + quotient body under shard_map
  (`prove_sharded.build_sharded_columns_step`), with the downstream
  commits / linear combination / FRI running the same jnp code on the
  global sharded arrays.

This replaces the reference's one parallel axis — crossbeam threads over
FFT and Merkle (`/root/reference/packages/fri/src/fft.rs:195-251`,
`commitment/src/pallarel_merkle_tree.rs:59-114`) — with mesh collectives,
and the emitted proof is byte-identical to the single-device prover's
(asserted by `tests/test_parallel_full.py` on an 8-way mesh and by the
driver's `dryrun_multichip`).
"""

from __future__ import annotations

from jax.sharding import Mesh

from stark_tpu.fields.field import FieldSpec
from stark_tpu.protocol.proof import StarkProof
from stark_tpu.protocol.prove import (
    enqueue_r1cs_proof,
    materialize_r1cs_proof,
)
from stark_tpu.r1cs.arithmetize import Arithmetization, arithmetize


def mk_r1cs_proof_sharded(
    spec: FieldSpec,
    arith: Arithmetization,
    public_wires: list[int],
    n_constraints: int,
    n_wires: int,
    mesh: Mesh,
) -> StarkProof:
    """`mk_r1cs_proof` over a device mesh (see module docstring)."""
    return materialize_r1cs_proof(
        spec,
        enqueue_r1cs_proof(
            spec, arith, public_wires, n_constraints, n_wires, mesh=mesh
        ),
    )


def prove_with_witness_sharded(r1cs, witness: list[bytes], mesh: Mesh) -> StarkProof:
    """Mesh-parallel `prove_with_witness` (run.rs:310-452): same header
    checks and arithmetization as the single-device runner, proof emitted
    from the unified mesh prover."""
    from stark_tpu.protocol.runner import _spec_for

    spec = _spec_for(r1cs)
    witness_ints = [spec.from_bytes_le(w) for w in witness]
    assert witness_ints[0] == 1, "witness[0] must be 1"  # run.rs:358
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    public_wires = witness_ints[:n_pub]
    arith = arithmetize(
        spec, r1cs.constraints, witness_ints, r1cs.header.n_wires, n_pub
    )
    return mk_r1cs_proof_sharded(
        spec,
        arith,
        public_wires,
        r1cs.header.n_constraints,
        r1cs.header.n_wires,
        mesh,
    )
