"""Full sharded prover: byte-identical proof on an 8-way mesh.

The mesh run covers the a-tree, both Merkle trees + branch gathering, the
Fiat-Shamir round trips, and the FRI recursion on sharded arrays -- the
proof JSON must equal the single-device prover's exactly, and verify.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import proof as proof_mod
from stark_tpu.protocol import runner
from stark_tpu.protocol.prove import mk_r1cs_proof
from stark_tpu.r1cs.arithmetize import arithmetize
from stark_tpu.r1cs.synth import squaring_chain


def _make(n_constraints):
    r1cs, witness_bytes = squaring_chain(n_constraints)
    witness = [spec.from_bytes_le(w) for w in witness_bytes]
    public_wires = witness[:2]
    arith = arithmetize(spec, r1cs.constraints, witness, r1cs.header.n_wires, 2)
    return r1cs, witness_bytes, public_wires, arith


def test_sharded_prover_matches_single_device():
    from stark_tpu.parallel.prove_full import mk_r1cs_proof_sharded

    n_dev = 8
    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        pytest.skip(f"need {n_dev} devices")
    mesh = Mesh(np.array(devs), ("d",))

    # steps >= n_dev^2 for the four-step NTT
    r1cs, witness_bytes, public_wires, arith = _make(44)
    h = r1cs.header

    want = mk_r1cs_proof(spec, arith, public_wires, h.n_constraints, h.n_wires)
    got = mk_r1cs_proof_sharded(
        spec, arith, public_wires, h.n_constraints, h.n_wires, mesh
    )
    assert proof_mod.to_json(got) == proof_mod.to_json(want)

    # and the proof verifies
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    assert runner.verify_with_witness(r1cs, witness_bytes[:n_pub], got)


def test_sharded_prover_mxu_engine_matches_single_device(monkeypatch):
    """The shard_map columns body with the CRT/MXU matmul
    engine as the local M-point DFT (ntt4 step 5) emits the same bytes as
    the plain prover. Forced on via STARK_TPU_MESH_MXU=1 (the auto gate
    keeps butterflies below production sizes)."""
    from stark_tpu.parallel.prove_full import mk_r1cs_proof_sharded

    n_dev = 8
    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        pytest.skip(f"need {n_dev} devices")
    monkeypatch.setenv("STARK_TPU_MESH_MXU", "1")
    # the stage-set lru cache keys on (sizes, mesh) only -- drop any stage
    # set the earlier test built with the butterfly engine, or this test
    # would reuse it and pass vacuously
    from stark_tpu.protocol.prove import _stages_cached

    _stages_cached.cache_clear()
    monkeypatch.setattr(
        "stark_tpu.protocol.warmup._warmed", set(), raising=False
    )
    mesh = Mesh(np.array(devs), ("d",))

    r1cs, witness_bytes, public_wires, arith = _make(44)
    h = r1cs.header
    want = mk_r1cs_proof(spec, arith, public_wires, h.n_constraints, h.n_wires)
    got = mk_r1cs_proof_sharded(
        spec, arith, public_wires, h.n_constraints, h.n_wires, mesh
    )
    assert proof_mod.to_json(got) == proof_mod.to_json(want)
