"""The R1CS STARK verifier.

Parity with `verify_r1cs_proof` (`/root/reference/packages/r1cs-stark/src/
verify.rs:13-258`), with one capability-preserving efficiency change flagged
by the survey: instead of evaluating the K/F0/F1/F2 coefficient polynomials
with an O(steps) Horner per spot check (`verify.rs:202-205`), the verifier
low-degree-extends them once on device and gathers the 80 checked positions
-- identical values, batched.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec
from stark_tpu.fri import fri
from stark_tpu.merkle import tree as mt
from stark_tpu.ops import modmath as mm
from stark_tpu.protocol import transcript as ts
from stark_tpu.protocol.params import SPOT_CHECK_SECURITY_FACTOR, derive_params
from stark_tpu.protocol.proof import StarkProof
from stark_tpu.protocol.prove import augmented_positions
from stark_tpu.utils import poly_host as ph
from stark_tpu.utils.tracing import phase


def _validate_proof_shape(proof: StarkProof, precision: int) -> None:
    """Structural well-formedness of an untrusted proof BEFORE any crypto.

    The reference verifier is assert/panic-driven and only type-checks the
    FRI round sequence (`fri.rs:332-334,366-371`); a malformed proof (e.g.
    truncated branch lists) would index out of bounds. Here every count and
    byte-length the verifier later relies on is checked up front, so a bad
    proof always fails with a clean ValueError, never an IndexError or a
    shape error inside a kernel."""

    def _chk(cond, msg):
        if not cond:
            raise ValueError(f"malformed proof: {msg}")

    for name in ("m_root", "l_root", "a_root"):
        root = getattr(proof, name)
        _chk(isinstance(root, (bytes, bytearray)), f"{name} is not bytes")
        _chk(len(root) == 32, f"{name} must be 32 bytes, got {len(root)}")

    def _chk_branches(branches, n_expect, leaf_bytes, what):
        _chk(isinstance(branches, list), f"{what} is not a list")
        _chk(
            len(branches) == n_expect,
            f"{what} must have {n_expect} entries, got {len(branches)}",
        )
        for b in branches:
            _chk(
                isinstance(b.leaf, (bytes, bytearray)),
                f"{what} leaf is not bytes",
            )
            _chk(
                len(b.leaf) == leaf_bytes,
                f"{what} leaf must be {leaf_bytes} bytes, got {len(b.leaf)}",
            )
            _chk(isinstance(b.nodes, list), f"{what} nodes is not a list")
            _chk(len(b.nodes) <= 64, f"{what} branch deeper than any tree")
            for n in b.nodes:
                _chk(
                    isinstance(n, (bytes, bytearray)) and len(n) == 32,
                    f"{what} sibling nodes must be 32 bytes",
                )

    n_pos = SPOT_CHECK_SECURITY_FACTOR
    _chk_branches(proof.main_branches, 4 * n_pos, 256, "main_branches")
    _chk_branches(
        proof.linear_comb_branches, n_pos, 32, "linear_comb_branches"
    )

    # FRI round sequence: the exact Middle count for this domain, one Last
    fri_rounds = 0
    mdp = precision // 4
    while mdp > fri.MIN_DEG_DIRECT_CHECKING:
        fri_rounds += 1
        mdp //= 4
    _chk(isinstance(proof.fri_proof, list), "fri_proof is not a list")
    _chk(
        len(proof.fri_proof) == fri_rounds + 1,
        f"fri_proof must have {fri_rounds + 1} rounds, got {len(proof.fri_proof)}",
    )
    for i, f in enumerate(proof.fri_proof[:-1]):
        _chk(
            isinstance(f, fri.FriMiddle),
            f"fri_proof[{i}] must be Middle",
        )
        _chk(
            isinstance(f.root2, (bytes, bytearray)) and len(f.root2) == 32,
            f"fri_proof[{i}].root2 must be 32 bytes",
        )
        _chk_branches(
            f.column_branches, fri.QUERIES_PER_ROUND, 32,
            f"fri_proof[{i}].column_branches",
        )
        _chk_branches(
            f.poly_branches, 4 * fri.QUERIES_PER_ROUND, 32,
            f"fri_proof[{i}].poly_branches",
        )
    last = proof.fri_proof[-1]
    _chk(isinstance(last, fri.FriLast), "fri_proof must end with Last")
    _chk(isinstance(last.last, list), "Last.last is not a list")
    expect_n = max(precision >> (2 * fri_rounds), 1)
    _chk(
        len(last.last) == expect_n,
        f"Last.last must have {expect_n} values, got {len(last.last)}",
    )
    for v in last.last:
        _chk(
            isinstance(v, (bytes, bytearray)) and len(v) == 32,
            "Last.last values must be 32 bytes",
        )


@functools.lru_cache(maxsize=2)
def _gather_j(spec):
    import jax

    def f(es, q):
        return jnp.stack([mm.from_mont(spec, e[:, q]) for e in es])

    return jax.jit(f)


def verify_r1cs_proof(
    spec: FieldSpec,
    proof: StarkProof,
    public_wires: list[int],
    public_first_indices: list[tuple[int, int]],
    permuted_indices: list[int],
    coefficients: list[int],
    flag0: list[int],
    flag1: list[int],
    flag2: list[int],
    n_constraints: int,
    n_wires: int,
    ev_cache: dict | None = None,
    digest: str = "blake2s",
) -> bool:
    """ev_cache: optional per-circuit dict; the 6 public-column LDEs are
    circuit-static (K/F0/F1/F2/idx/perm never depend on the proof), so a
    verification service can pass the same dict across proofs and pay the
    v_lde device work once (6*L*4*precision bytes of HBM stay resident)."""
    p = spec.p
    original_steps = len(coefficients)
    assert original_steps <= 3 * n_constraints * n_wires
    params = derive_params(spec, original_steps)
    steps, precision, skips = params.steps, params.precision, params.skips

    from stark_tpu.protocol.prove import _col_bytes_np, _pad_col, _stages_cached

    # columns may be python-int lists (the pure-python arithmetizer) or
    # numpy arrays (the native witness-less arithmetizer, run.rs:21-107)
    if isinstance(permuted_indices, np.ndarray):
        permuted = np.concatenate(
            [
                permuted_indices.astype(np.uint64),
                np.arange(original_steps, steps, dtype=np.uint64),
            ]
        )
    else:
        permuted = list(permuted_indices) + list(range(original_steps, steps))
    coeffs = _pad_col(coefficients, steps)
    f1 = _pad_col(flag1, steps)
    f2 = _pad_col(flag2, steps)

    _validate_proof_shape(proof, precision)

    # FRI first (verify.rs:82-85)
    with phase("v_fri"):
        assert fri.verify_low_degree_proof(
            spec, proof.l_root, params.g2, proof.fri_proof, precision // 4,
            skips, digest
        )

    positions = ts.get_pseudorandom_indices(
        proof.l_root, precision, SPOT_CHECK_SECURITY_FACTOR, skips
    )
    aug = augmented_positions(positions, params)

    with phase("v_branches"):
        # the m-tree is blake2s under EITHER digest (256-byte leaves exceed
        # Poseidon's 64-byte cap, poseidon.rs:33); l/FRI trees follow `digest`
        main_leaves = mt.verify_multi_branch(proof.m_root, aug, proof.main_branches)
        l_leaves = mt.verify_multi_branch(
            proof.l_root, positions, proof.linear_comb_branches, digest
        )

    # device LDEs of the public columns, gathered at the spot checks
    # (backend chosen by STARK_TPU_MXU: butterfly kernels or CRT matmuls).
    # All 6 columns go through ONE transfer + ONE to-Montgomery + one
    # lde_many + ONE gather dispatch (reusing the prover's compiled stages;
    # eager per-column chains cost a dispatch per op).
    with phase("v_lde"):
        # EXACTLY the prover's positional call shape: lru_cache keys on the
        # raw argument tuple, so `_stages_cached(spec, s, p, o)` and
        # `_stages_cached(spec, s, p, o, None, "blake2s")` are DIFFERENT
        # entries -- the mismatch built a second stage set whose domain/NTT
        # plan tables duplicated ~2.5 GB of HBM at precision 2^23 (enough
        # to OOM a prove issued after a verify)
        stages = _stages_cached(
            spec, steps, precision, original_steps, None, digest
        )
        evs = ev_cache.get("evs") if ev_cache is not None else None
        if evs is None:
            perm_np = np.asarray(permuted, dtype=np.uint64)
            smalls = stages["v_cols"](
                jnp.asarray(_col_bytes_np(spec, coeffs)),
                jnp.asarray(np.asarray(f1, dtype=np.uint8)),
                jnp.asarray(np.asarray(f2, dtype=np.uint8)),
                jnp.asarray((perm_np & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                jnp.asarray((perm_np >> np.uint64(32)).astype(np.uint32)),
            )
            evs = stages["lde_many"](smalls)
            if ev_cache is not None:
                ev_cache["evs"] = evs
        pos_arr = jnp.asarray(np.asarray(positions, dtype=np.int64))
        gathered = np.asarray(_gather_j(spec)(evs, pos_arr))  # (6, L, n_pos)
        k_at, f0_at, f1_at, f2_at, idx_at, perm_at = (
            mm.limbs_to_ints_np(gathered[i], spec) for i in range(6)
        )

    # boundary interpolants (host; verify.rs:153-157)
    pub_xs = [pow(params.g2, skips * w, p) for (_, w) in public_first_indices]
    pub_ys = [public_wires[k] for (k, _) in public_first_indices]
    interpolant2 = ph.lagrange_interp(spec, pub_xs, pub_ys)
    x_of_last_step = pow(params.g2, (steps - 1) * skips, p)

    r = ts.get_random_ff_values(spec, proof.a_root, precision, 3, 0)
    k_coeffs = [1] + [
        ts.seed_to_field(spec, [proof.m_root, bytes([i])]) for i in range(1, 11)
    ]
    omega = pow(params.g2, steps, p)

    for i, pos in enumerate(positions):
        x = pow(params.g2, pos, p)
        br = [main_leaves[i * 4 + j] for j in range(4)]
        chunk = lambda leaf, c: spec.from_bytes_le(leaf[c * 32 : (c + 1) * 32])
        p_of_x = chunk(br[0], 0)
        p_of_prev_x = chunk(br[1], 0)
        p_of_x_plus_w = chunk(br[2], 0)
        p_of_x_plus_2w = chunk(br[3], 0)
        a_of_x = chunk(br[0], 1)
        a_of_prev_x = chunk(br[1], 1)
        s_of_x = chunk(br[0], 2)
        d1_of_x = chunk(br[0], 3)
        d2_of_x = chunk(br[0], 4)
        d3_of_x = chunk(br[0], 5)
        b_of_x = chunk(br[0], 6)
        b3_of_x = chunk(br[0], 7)

        z_value = (pow(omega, pos % skips, p) - 1) % p

        # Q1: transition of the running dot product (verify.rs:207-211)
        lhs = f0_at[i] * ((p_of_x - f1_at[i] * p_of_prev_x - k_at[i] * s_of_x) % p) % p
        assert lhs == z_value * d1_of_x % p, f"Q1 check failed at {pos}"

        # Q2: R1CS product A*B=C (verify.rs:213-217)
        lhs = f2_at[i] * ((p_of_x_plus_2w - p_of_x * p_of_x_plus_w) % p) % p
        assert lhs == z_value * d2_of_x % p, f"Q2 check failed at {pos}"

        # Q3: permutation accumulator (verify.rs:219-223)
        val_nmr = (r[0] + r[1] * idx_at[i] + r[2] * s_of_x) % p
        val_dnm = (r[0] + r[1] * perm_at[i] + r[2] * s_of_x) % p
        lhs = (a_of_x * val_dnm - a_of_prev_x * val_nmr) % p
        assert lhs == z_value * d3_of_x % p, f"Q3 check failed at {pos}"

        # boundary checks (verify.rs:226-235)
        zb2_of_x = 1
        for (_, w) in public_first_indices:
            zb2_of_x = zb2_of_x * (x - pow(params.g2, w * skips, p)) % p
        i2_of_x = ph.eval_poly_at(spec, interpolant2, x)
        assert (s_of_x - i2_of_x) % p == zb2_of_x * b_of_x % p, f"B2 failed at {pos}"
        zb3_of_x = (x - x_of_last_step) % p
        assert (a_of_x - 1) % p == zb3_of_x * b3_of_x % p, f"B3 failed at {pos}"

        # linear combination consistency (verify.rs:238-253)
        x_to_steps = pow(x, steps, p)
        l_of_x = spec.from_bytes_le(l_leaves[i])
        expect = (
            k_coeffs[0] * d1_of_x
            + k_coeffs[1] * d2_of_x
            + k_coeffs[2] * d3_of_x
            + k_coeffs[3] * p_of_x
            + k_coeffs[4] * p_of_x * x_to_steps
            + k_coeffs[5] * b_of_x
            + k_coeffs[6] * b_of_x * x_to_steps
            + k_coeffs[7] * b3_of_x
            + k_coeffs[8] * b3_of_x * x_to_steps
            + k_coeffs[9] * a_of_x
            + k_coeffs[10] * s_of_x
        ) % p
        assert l_of_x == expect, f"L consistency failed at {pos}"

    return True
