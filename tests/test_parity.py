"""Byte-parity tests: the production prover must emit JSON byte-identical
to the independent pure-Python oracle (`tests/parity_oracle.py`).

This is the only check in the repo that can catch *symmetric* deviations
from the reference semantics (run.rs / prove.rs / fri.rs): the oracle
shares no code with `stark_tpu`, so both pipelines agreeing byte-for-byte
means two independent readings of the reference produced the same
transcript, leaf layouts, and serde layout.

The committed golden (`tests/fixtures/compute_proof_golden.json`) pins the
agreed output; both sides are checked against it.
"""

import json
import os

import pytest

import parity_oracle as oracle
from stark_tpu.protocol import proof as proof_mod
from stark_tpu.protocol import runner

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = os.path.join(FIXTURES, "compute_proof_golden.json")


def _fixture_bytes(name):
    with open(os.path.join(FIXTURES, f"{name}.r1cs"), "rb") as f:
        r1cs = f.read()
    with open(os.path.join(FIXTURES, f"{name}.wtns"), "rb") as f:
        wtns = f.read()
    return r1cs, wtns


@pytest.mark.quick
def test_oracle_matches_golden():
    """Guards the oracle itself against accidental edits."""
    r1cs, wtns = _fixture_bytes("compute")
    got = oracle.prove_fixture(r1cs, wtns)
    with open(GOLDEN) as f:
        assert got == f.read()


@pytest.mark.quick
def test_prover_matches_golden(tmp_path):
    """The production prover's JSON is byte-identical to the oracle's."""
    out = str(tmp_path / "compute_proof.json")
    runner.prove_with_file_path(
        os.path.join(FIXTURES, "compute.r1cs"),
        os.path.join(FIXTURES, "compute.wtns"),
        out,
    )
    with open(out) as f:
        got = f.read()
    with open(GOLDEN) as f:
        assert got == f.read()


@pytest.mark.quick
def test_verifier_accepts_golden():
    """The production verifier accepts the oracle-generated proof."""
    from stark_tpu.r1cs.reader import read_r1cs, read_witness

    r1cs_bytes, wtns_bytes = _fixture_bytes("compute")
    r1cs = read_r1cs(r1cs_bytes)
    witness = read_witness(wtns_bytes)
    with open(GOLDEN) as f:
        proof = proof_mod.from_json(f.read())
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    assert runner.verify_with_witness(r1cs, witness[:n_pub], proof)


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,golden",
    [
        ("bits", "bits_proof_golden.json"),
        ("pedersen_test", "pedersen_proof_golden.json"),
        # poseidon3 is the cheapest multi-round-FRI golden (~3 min on a
        # 1-vCPU host), so it doubles as the `midslow` tier: re-prove
        # multi-round FRI byte parity every round without the 1,460 s
        # bits run (pytest -m midslow)
        pytest.param(
            "poseidon3_test",
            "poseidon3_proof_golden.json",
            marks=pytest.mark.midslow,
        ),
    ],
)
def test_prover_matches_golden_all_fixtures(tmp_path, name, golden):
    """Every fixture circuit in the reference snapshot has a committed
    oracle golden (sha256_2_test.r1cs is absent upstream); the production
    prover must reproduce each byte-for-byte and the verifier must accept
    it (run.rs:627-657's fixture sweep, upgraded from self-consistency to
    independent-oracle parity)."""
    out = str(tmp_path / f"{name}_proof.json")
    runner.prove_with_file_path(
        os.path.join(FIXTURES, f"{name}.r1cs"),
        os.path.join(FIXTURES, f"{name}.wtns"),
        out,
    )
    with open(out) as f:
        got = f.read()
    with open(os.path.join(FIXTURES, golden)) as f:
        want = f.read()
    assert json.loads(got)["m_root"] == json.loads(want)["m_root"]
    assert got == want

    from stark_tpu.r1cs.reader import read_r1cs, read_witness

    r1cs_bytes, wtns_bytes = _fixture_bytes(name)
    r1cs = read_r1cs(r1cs_bytes)
    witness = read_witness(wtns_bytes)
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    assert runner.verify_with_witness(
        r1cs, witness[:n_pub], proof_mod.from_json(want)
    )


@pytest.mark.slow
def test_prover_matches_oracle_poseidon3(tmp_path):
    """Second circuit (steps=8192, precision=65536): live oracle-vs-prover
    byte comparison, exercising multi-round FRI and real-scale transcripts."""
    r1cs_bytes, wtns_bytes = _fixture_bytes("poseidon3_test")
    want = oracle.prove_fixture(r1cs_bytes, wtns_bytes)
    out = str(tmp_path / "poseidon3_proof.json")
    runner.prove_with_file_path(
        os.path.join(FIXTURES, "poseidon3_test.r1cs"),
        os.path.join(FIXTURES, "poseidon3_test.wtns"),
        out,
    )
    with open(out) as f:
        got = f.read()
    assert json.loads(got)["m_root"] == json.loads(want)["m_root"]
    assert got == want


@pytest.mark.midslow
def test_prover_matches_oracle_ragged():
    """Ragged mixed-width circuit (sha256_2-class shape):
    per-constraint widths 1..32, scattered wire locality. The production
    prover (device arithmetization path) must agree byte-for-byte with the
    oracle on the NON-uniform n_coeff paths the uniform synthetic chains
    never exercise."""
    import hashlib

    from stark_tpu.r1cs.synth import ragged_mix

    r1cs, wb = ragged_mix(120)
    h = r1cs.header
    widths = {max(f.n_coefficient for f in c.factors) for c in r1cs.constraints}
    assert len(widths) > 4  # genuinely ragged

    # oracle-side dict shape (tests/parity_oracle.py::arithmetize)
    od = {
        "prime": h.prime_number,
        "n_wires": h.n_wires,
        "n_public_inputs": h.n_public_inputs,
        "n_public_outputs": h.n_public_outputs,
        "constraints": [
            [
                [(c.wire_id, c.value) for c in f.coefficients]
                for f in con.factors
            ]
            for con in r1cs.constraints
        ],
    }
    witness = [oracle.from_bytes_le(w) for w in wb]
    n_public = 1 + h.n_public_inputs + h.n_public_outputs
    (
        witness_trace, computational_trace, coefficients,
        flag0, flag1, flag2, permuted_indices, public_first_indices,
    ) = oracle.arithmetize(od, witness)
    want = json.dumps(
        oracle.mk_r1cs_proof(
            witness_trace, computational_trace, witness[:n_public],
            public_first_indices, permuted_indices, coefficients,
            flag0, flag1, flag2,
        ),
        separators=(",", ":"),
    )

    got = proof_mod.to_json(runner.prove_with_witness(r1cs, wb))
    assert got == want
    # pin the agreed bytes so future runs can detect symmetric drift
    sha = hashlib.sha256(got.encode()).hexdigest()
    golden = os.path.join(FIXTURES, "ragged120_proof_sha256.txt")
    if os.path.exists(golden):
        with open(golden) as f:
            assert f.read().strip() == sha
