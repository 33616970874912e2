"""The R1CS STARK prover, re-expressed as batched device kernels.

Pipeline parity with `mk_r1cs_proof` (`/root/reference/packages/r1cs-stark/
src/prove.rs:14-378`), with a device-first structure:

* all 9 trace columns are low-degree-extended on device (iNTT@g1, NTT@g2);
* constraint/quotient/boundary evaluations are fused element-wise kernels
  over the whole extension domain;
* Z(x) = x^steps - 1 and x^steps are PERIODIC with period EXTENSION_FACTOR
  on the evaluation domain, so their (inverse) values are 8 host scalars
  tiled on device -- no O(precision) vanishing-poly FFT or host power table
  (`prove.rs:84,128-129,287-291` materialize all of these);
* the permutation accumulator A is a batched prefix-product scan + one
  batched inversion instead of the reference's sequential loop
  (`utils.rs:293-339`);
* Merkle leaves are byte-packed exactly as the reference (256-byte m-tree
  leaves `prove.rs:235-258`, 40-byte a-tree leaves `utils.rs:250-270`) and
  hashed layer-at-a-time on device.

The Fiat-Shamir transcript (roots -> k coefficients/r values/positions) is
byte-exact with the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.fri import fri
from stark_tpu.merkle import tree as mt
from stark_tpu.ops import modmath as mm
from stark_tpu.protocol import transcript as ts
from stark_tpu.protocol.params import (
    SPOT_CHECK_SECURITY_FACTOR,
    DomainParams,
    derive_params,
)
from stark_tpu.protocol.proof import StarkProof
from stark_tpu.r1cs.arithmetize import Arithmetization
from stark_tpu.utils import poly_host as ph
from stark_tpu.utils.tracing import phase


def _col_mont(spec, col):
    """Column -> (L, N) Montgomery limbs. Accepts python int lists (the
    classic path), (N, 32) uint8 canonical LE byte rows (the native
    arithmetizer's output), or 1-D integer numpy arrays (< 2^64)."""
    if isinstance(col, np.ndarray):
        if col.ndim == 2 and col.dtype == np.uint8:
            return mm.to_mont(spec, jnp.asarray(mm.bytes_le_to_limbs_np(col, spec)))
        if col.ndim == 1:
            v = col.astype(np.uint64)
            limbs = np.zeros((spec.num_limbs, v.shape[0]), dtype=np.uint32)
            for i in range(4):
                limbs[i] = ((v >> np.uint64(16 * i)) & np.uint64(0xFFFF)).astype(
                    np.uint32
                )
            return mm.to_mont(spec, jnp.asarray(limbs))
        raise TypeError(f"unsupported column array {col.shape}/{col.dtype}")
    return mm.to_mont(spec, mm.ints_to_limbs_np(col, spec))


def _pad_col(col, steps: int):
    """Zero-pad a column (list or numpy) to `steps` entries."""
    n = len(col)
    if isinstance(col, np.ndarray):
        if n == steps:
            return col
        shape = (steps,) + col.shape[1:]
        out = np.zeros(shape, dtype=col.dtype)
        out[:n] = col
        return out
    return list(col) + [0] * (steps - n)


def _tile_periodic(spec: FieldSpec, scalars: list[int], precision: int):
    """Host scalars v_0..v_{k-1} -> (L, precision) Montgomery with
    out[j] = v_{j mod k}."""
    k = len(scalars)
    base = mm.mont_consts(spec, scalars)  # (L, k)
    return jnp.tile(base, (1, precision // k))


def _canon_bytes(spec, mont_arr) -> np.ndarray:
    return mm.limbs_to_bytes_le_np(np.asarray(mm.from_mont(spec, mont_arr)), spec)


def augmented_positions(positions, params: DomainParams):
    """The 4 companion indices per spot check (`prove.rs:351-359`)."""
    out = []
    k = params.original_steps // 3 * params.skips
    for j in positions:
        out.extend(
            [
                j,
                (j + params.precision - params.skips) % params.precision,
                (j + k) % params.precision,
                (j + 2 * k) % params.precision,
            ]
        )
    return out


def _col_bytes_np(spec, col) -> np.ndarray:
    """Column -> (N, 2L) canonical little-endian uint8 byte rows -- the
    minimal-transfer wire format (bytes->limbs runs on device). The native
    arithmetizer already emits (N, 32) u8 rows, which pass through."""
    nb = spec.num_limbs * 2
    if isinstance(col, np.ndarray) and col.ndim == 2 and col.dtype == np.uint8:
        if col.shape[1] == nb:
            return col
        out = np.zeros((col.shape[0], nb), dtype=np.uint8)
        w = min(nb, col.shape[1])
        out[:, :w] = col[:, :w]
        return out
    if isinstance(col, np.ndarray) and col.ndim == 1:
        v = col.astype(np.uint64)
        out = np.zeros((v.shape[0], nb), dtype=np.uint8)
        for i in range(min(8, nb)):
            out[:, i] = ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
        return out
    b = mm.limbs_to_bytes_le_np(mm.ints_to_limbs_np(col, spec), spec)
    return _col_bytes_np(spec, b)  # normalize width to 2L


_TRACE_NAMES = ("k", "f0", "f1", "f2", "s", "p", "idx", "perm")


@functools.lru_cache(maxsize=8)
def _stages_cached(spec, steps, precision, original_steps, mesh, digest):
    """No default args ON PURPOSE: lru_cache keys on the raw argument
    tuple, so f(a,b,c,d) and f(a,b,c,d,None,"blake2s") would be two cache
    entries building two stage sets -- each holding multi-GB domain/NTT
    plan tables on device (the duplicate OOM'd prove-after-verify at
    precision 2^23). Every caller passes all six."""
    from stark_tpu.protocol.core import build_proof_stages

    return build_proof_stages(
        spec, steps, precision, original_steps, mesh, digest
    )


def mk_r1cs_proof(
    spec: FieldSpec,
    arith: Arithmetization,
    public_wires: list[int],
    n_constraints: int,
    n_wires: int,
    mesh=None,
    digest: str = "blake2s",
) -> StarkProof:
    return materialize_r1cs_proof(
        spec,
        enqueue_r1cs_proof(
            spec, arith, public_wires, n_constraints, n_wires, mesh=mesh,
            digest=digest,
        ),
    )


def enqueue_r1cs_proof(
    spec: FieldSpec,
    arith: Arithmetization,
    public_wires: list[int],
    n_constraints: int,
    n_wires: int,
    mesh=None,
    digest: str = "blake2s",
) -> dict:
    """Enqueue the ENTIRE proof as one async device-dispatch chain (every
    Fiat-Shamir challenge is device-derived) and return the pending record;
    `materialize_r1cs_proof` syncs once and formats the StarkProof. Split
    so a serving loop can pipeline: enqueue proof i+1 while proof i's
    arrays stream back (`runner.prove_many`).

    `mesh`: optional 1-D device mesh ("d" axis). The SAME orchestration
    (device transcript, staged jits, one materializing transfer) runs for
    every geometry; only the `columns` stage is mesh-dependent (shard_map
    four-step NTT at d>1, the fused single-chip engine otherwise). See
    `core.build_proof_stages`."""
    p = spec.p
    original_steps = arith.original_steps
    assert original_steps <= 3 * n_constraints * n_wires
    params = derive_params(spec, original_steps)
    steps, precision, skips = params.steps, params.precision, params.skips
    if mesh is not None:
        d = int(mesh.devices.size)
        assert steps >= d * d, (
            f"four-step NTT needs steps >= n_devices^2 ({steps} < {d * d})"
        )

    # build the stages FIRST so the background warmup thread hits the lru
    # cache instead of racing a second (device-table-materializing) build
    stages = _stages_cached(spec, steps, precision, original_steps, mesh, digest)

    from stark_tpu.protocol.warmup import maybe_warmup

    if mesh is None and digest == "blake2s":
        maybe_warmup(
            spec, steps, precision, original_steps,
            len(arith.public_first_indices),
            n_wires=(
                arith.witness_le.shape[0] if arith.witness_le is not None else 0
            ),
        )
    xs_full = stages["xs_full"]
    put_rows, put_repl = stages["put_rows"], stages["put_repl"]

    # --- pad traces to the power-of-two domain (prove.rs:55-68) ---
    if isinstance(arith.permuted_indices, np.ndarray):
        permuted = np.concatenate(
            [
                arith.permuted_indices.astype(np.uint64),
                np.arange(original_steps, steps, dtype=np.uint64),
            ]
        )
    else:
        permuted = np.asarray(
            list(arith.permuted_indices) + list(range(original_steps, steps)),
            dtype=np.uint64,
        )

    # --- all 8 small-domain columns from a minimal host transfer: flags
    # travel as u8, the permutation as u32 pairs, f0/idx are generated on
    # device. Device arithmetization (witness_le + slot_wire_ids set):
    # only K (circuit-static) and the witness move, and S/P are derived on
    # device. Legacy: K/S/P move as full byte columns. ---
    with phase("traces"):
        f1_u8 = np.asarray(_pad_col(arith.flag1, steps), dtype=np.uint8)
        f2_u8 = np.asarray(_pad_col(arith.flag2, steps), dtype=np.uint8)
        perm_lo = (permuted & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        perm_hi = (permuted >> np.uint64(32)).astype(np.uint32)
        if arith.witness_le is not None and arith.slot_wire_ids is not None:
            # circuit-static arrays upload ONCE per (arith, steps, mesh):
            # serving loops (prove_many) reuse the same arith across
            # witnesses, so only the witness is uploaded per proof
            statics = getattr(arith, "_device_statics", None)
            if statics is None or statics[0] != (steps, mesh):
                wids = np.zeros(steps, dtype=np.uint32)
                wids[:original_steps] = arith.slot_wire_ids
                statics = (
                    (steps, mesh),
                    put_rows(
                        _col_bytes_np(spec, _pad_col(arith.coefficients, steps))
                    ),
                    put_rows(wids),
                    put_rows(f1_u8),
                    put_rows(f2_u8),
                    put_rows(perm_lo),
                    put_rows(perm_hi),
                )
                arith._device_statics = statics
            _, k_d, wids_d, f1_d, f2_d, plo_d, phi_d = statics
            wit = arith.witness_le
            if isinstance(wit, jax.Array):
                # serving path: the witness was pre-uploaded (async H2D)
                # while the PREVIOUS proof materialized (runner.prove_many)
                wit_d = wit
            else:
                wit_d = put_repl(_col_bytes_np(spec, wit))
            traces = stages["wit_traces"](
                k_d,
                wit_d,
                wids_d,
                f1_d,
                f2_d,
                plo_d,
                phi_d,
            )
        else:
            ksp = np.concatenate(
                [
                    _col_bytes_np(spec, _pad_col(arith.coefficients, steps)),
                    _col_bytes_np(spec, _pad_col(arith.witness_trace, steps)),
                    _col_bytes_np(spec, _pad_col(arith.computational_trace, steps)),
                ],
                axis=0,
            )
            plo_d = put_rows(perm_lo)
            phi_d = put_rows(perm_hi)
            traces = stages["traces"](
                put_rows(ksp),
                put_rows(f1_u8),
                put_rows(f2_u8),
                plo_d,
                phi_d,
            )

    # From here to the final materialization, EVERYTHING is an async device
    # dispatch: every Fiat-Shamir challenge (r, k, positions, FRI special_x
    # and query indices) is derived on device (`protocol/device_transcript`),
    # so no host sync sits inside the transcript chain. One transfer at the
    # end moves the whole proof to the host.

    # --- a-tree root (utils.rs:250-270) + r (utils.rs:272-290) ---
    with phase("a_tree"):
        a_root_words = stages["a_root"](plo_d[None], phi_d[None], traces["s"])
        r_mont = stages["r"](a_root_words)

    # --- 9 LDEs + accumulator + quotients + boundaries
    # (prove.rs:100-184, utils.rs:181-524) via the unified columns stage
    # (fused single-chip engine, or shard_map four-step NTT on a mesh) ---
    with phase("columns"):
        pub_xs = [
            pow(params.g2, skips * w, p) for (_, w) in arith.public_first_indices
        ]
        pub_ys = [public_wires[k] for (k, _) in arith.public_first_indices]
        interpolant2 = ph.lagrange_interp(spec, pub_xs, pub_ys)
        pubx_d = put_repl(mm.mont_consts(spec, pub_xs))
        if stages["inv_zb2"] is not None:
            # Zb2^-1 is circuit-static (utils.rs:438-455): compute once per
            # circuit and keep the (L, N) table device-resident across
            # proves (~64 MB at 2^20; big domains recompute per prove
            # inside the B2 program instead, like Zb3^-1)
            zb2c = getattr(arith, "_inv_zb2_cache", None)
            if zb2c is None or zb2c[0] != (steps, mesh, digest):
                zb2c = (
                    (steps, mesh, digest),
                    stages["inv_zb2"](pubx_d, xs_full),
                )
                arith._inv_zb2_cache = zb2c
            b2in = zb2c[1]
        else:
            b2in = pubx_d
        cols, q_bad = stages["columns"](
            traces,
            r_mont,
            put_repl(mm.mont_consts(spec, interpolant2)),
            b2in,
        )
        # nothing downstream reads the small-domain traces: dropping the
        # dict frees ~0.5 GB (at steps 2^20) once the queued columns run
        del traces

    # --- m-tree (prove.rs:235-264) -> k (prove.rs:274-283) -> L -> l-tree ---
    big = bool(stages.get("big"))
    with phase("commits"):
        if big:
            # streamed commit: no (64, N) leaf-word buffer (2.1 GB at
            # 2^23); branch leaves are re-packed from the columns below
            m_layers = stages["m_commit_stream"](cols)
            m_tree = mt.DeviceMerkleTree(
                None, 256, list(m_layers), leaf_word_count=64
            )
            m_root_w = m_layers[-1][:, 0]
            k_mont = stages["k"](m_root_w)
            l_ev = stages["linc"](k_mont, cols)
            l_words, l_layers = stages["l_commit"](l_ev)
        elif stages.get("commit_chain") is not None:
            # one dispatch for the whole statically-chained middle
            m_words, m_layers, k_mont, l_ev, l_words, l_layers = stages[
                "commit_chain"
            ](cols)
            m_tree = mt.DeviceMerkleTree(m_words, 256, list(m_layers))
            m_root_w = m_layers[-1][:, 0]
            del cols
        else:
            m_words, m_layers = stages["m_commit"](cols)
            m_tree = mt.DeviceMerkleTree(m_words, 256, list(m_layers))
            m_root_w = m_layers[-1][:, 0]
            k_mont = stages["k"](m_root_w)
            l_ev = stages["linc"](k_mont, cols)
            l_words, l_layers = stages["l_commit"](l_ev)
            del cols  # the m-tree leaves/layers carry everything from here
        l_tree = mt.DeviceMerkleTree(l_words, 32, list(l_layers))
        l_root_w = l_layers[-1][:, 0]

    # --- spot checks (prove.rs:337-362) with device-derived positions ---
    with phase("branches"):
        if big:
            positions_d, aug_d = stages["pos"](l_root_w)
            l_flat = l_tree._gather_device(positions_d)
            m_flat = stages["m_gather"](cols, tuple(m_layers), aug_d)
            del cols  # the queued gather holds its own reference
        elif stages.get("pos_gather") is not None:
            l_flat, m_flat = stages["pos_gather"](
                l_root_w, l_words, tuple(l_layers), m_words, tuple(m_layers)
            )
        else:
            positions_d, aug_d = stages["pos"](l_root_w)
            l_flat = l_tree._gather_device(positions_d)
            m_flat = m_tree._gather_device(aug_d)

    # --- FRI (prove.rs:367); the l_tree IS FRI round 0's value tree ---
    with phase("fri"):
        pending = fri.prove_low_degree_pending(
            spec, l_ev, xs_full, precision // 4, skips, first_tree=l_tree,
            digest=digest,
        )

    # every gather against these trees is dispatched above; dropping the
    # device arrays lets the runtime free ~4 GB (at 2^23) as soon as the
    # queued gathers execute, instead of at materialize time
    m_tree.release_device()
    l_tree.release_device()

    return {
        "pending": pending,
        "device_arrays": [a_root_words, m_root_w, l_root_w, q_bad, l_flat, m_flat]
        + pending["device_arrays"],
        "l_tree": l_tree,
        "m_tree": m_tree,
    }


def materialize_r1cs_proof(spec: FieldSpec, st: dict) -> StarkProof:
    """One device->host transfer + host-side formatting of a pending proof
    chain from `enqueue_r1cs_proof`."""
    with phase("materialize"):
        mats = fri.materialize_u32(st["device_arrays"])
        a_root_np, m_root_np, l_root_np, bad, l_flat_np, m_flat_np = mats[:6]
        for i, what in enumerate(("D1", "D2", "D3")):
            if bad[i]:
                raise AssertionError(f"invalid {what}: quotient not divisible by Z")
        n_pos = SPOT_CHECK_SECURITY_FACTOR
        linear_comb_branches = st["l_tree"]._proofs_from_flat(l_flat_np, n_pos)
        main_branches = st["m_tree"]._proofs_from_flat(m_flat_np, 4 * n_pos)
        fri_proof = fri.assemble_fri(spec, st["pending"], mats[6:])

    return StarkProof(
        m_root=m_root_np.astype("<u4").tobytes(),
        l_root=l_root_np.astype("<u4").tobytes(),
        a_root=a_root_np.astype("<u4").tobytes(),
        main_branches=main_branches,
        linear_comb_branches=linear_comb_branches,
        fri_proof=fri_proof,
    )
