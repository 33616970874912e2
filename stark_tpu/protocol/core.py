"""Fully-jittable single-chip prover core.

One compiled step covering everything between the Fiat-Shamir round trips of
`mk_r1cs_proof`: 8 LDEs, permutation accumulator, quotients, boundaries,
linear combination, and both Merkle roots -- given the transcript scalars
(r, k) as inputs. Used by the driver entry point (`__graft_entry__.entry`)
and the throughput benchmark; the orchestrated prover in
:mod:`stark_tpu.protocol.prove` computes identical values stage by stage.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec
from stark_tpu.protocol.params import SPOT_CHECK_SECURITY_FACTOR
from stark_tpu.ops import blake2s as b2
from stark_tpu.ops import modmath as mm
from stark_tpu.ops import ntt as nttm
from stark_tpu.protocol import kernels
from stark_tpu.parallel.prove_sharded import _leaves_to_words

# Above this precision the CRT engine's fused multi-column LDE module holds
# ~1 GB of live temporaries per column across 9 columns (sized for a 16 GB
# device); larger domains dispatch one column per jit call instead.
_MXU_FUSE_MAX_PRECISION = 1 << 20


def merkle_root_local(leaf_words, leaf_bytes: int):
    """(W, N) leaf words -> (8,) root digest words, all on device."""
    h = b2.blake2s_words(leaf_words, leaf_bytes)
    while h.shape[1] > 1:
        m = h.shape[1] // 2
        pair = h.reshape(8, m, 2)
        msg = jnp.concatenate([pair[:, :, 0], pair[:, :, 1]], axis=0)
        h = b2.blake2s_words(msg, 64)
    return h[:, 0]


def build_single_chip_step(
    spec: FieldSpec, steps: int, precision: int, original_steps: int
):
    """Returns a jitted fn(traces, r_mont, k_mont, i2_mont, pubx_mont) ->
    (m_root_words, l_root_words, l_evaluations)."""
    p = spec.p
    skips = precision // steps
    kshift = original_steps // 3 * skips
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    xs_full = mm.power_table(spec, g2, precision)
    lde_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)
    omega = pow(g2, steps, p)
    inv_z_scalars = [0] + [
        pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)
    ]
    pow_scalars = [pow(omega, t, p) for t in range(skips)]
    x_last = pow(g2, precision - skips, p)
    x_last_mont = mm.mont_const(spec, x_last)
    inv_z_base = mm.mont_consts(spec, inv_z_scalars)
    x2s_base = mm.mont_consts(spec, pow_scalars)

    @jax.jit
    def step(traces, r_mont, k_mont, i2_mont, pubx_mont):
        lde = lambda t: nttm.lde(spec, t, lde_plan)
        k_ev = lde(traces["k"])
        f0_ev = lde(traces["f0"])
        f1_ev = lde(traces["f1"])
        f2_ev = lde(traces["f2"])
        s_ev = lde(traces["s"])
        p_ev = lde(traces["p"])
        idx_ev = lde(traces["idx"])
        perm_ev = lde(traces["perm"])

        vn, vd = kernels.rand_combination(
            spec, r_mont, traces["idx"], traces["perm"], traces["s"]
        )
        a_ev = lde(kernels.accumulator_mini(spec, vn, vd))

        q1 = kernels.q1_eval(spec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips)
        q2 = kernels.q2_eval(spec, p_ev, f2_ev, kshift)
        vn_big, vd_big = kernels.rand_combination(spec, r_mont, idx_ev, perm_ev, s_ev)
        q3 = kernels.q3_eval(spec, a_ev, vn_big, vd_big, skips)

        inv_z = jnp.tile(inv_z_base, (1, precision // skips))
        d1 = mm.mmul(spec, q1, inv_z)
        d2 = mm.mmul(spec, q2, inv_z)
        d3 = mm.mmul(spec, q3, inv_z)

        i2_ev = kernels.horner_eval(spec, i2_mont, xs_full)
        one_big = jnp.broadcast_to(mm.mont_one(spec), s_ev.shape)
        zb2 = kernels.vanishing_eval(spec, xs_full, pubx_mont)
        zb3 = mm.msub(spec, xs_full, jnp.broadcast_to(x_last_mont, xs_full.shape))
        b2_ev = mm.mmul(spec, mm.msub(spec, s_ev, i2_ev), mm.multi_inv(spec, zb2))
        b3_ev = mm.mmul(spec, mm.msub(spec, a_ev, one_big), mm.multi_inv(spec, zb3))

        x_to_steps = jnp.tile(x2s_base, (1, precision // skips))
        l_ev = kernels.linear_combination(
            spec, k_mont, x_to_steps, p_ev, a_ev, s_ev, d1, d2, d3, b2_ev, b3_ev
        )

        m_root = merkle_root_local(
            _leaves_to_words(spec, [p_ev, a_ev, s_ev, d1, d2, d3, b2_ev, b3_ev]), 256
        )
        l_root = merkle_root_local(_leaves_to_words(spec, [l_ev]), 32)
        return m_root, l_root, l_ev

    return step


def build_staged_prover(
    spec: FieldSpec, steps: int, precision: int, original_steps: int
):
    """Same computation as `build_single_chip_step`, but split into a few
    jitted pieces with ONE compiled LDE executable reused for all 9 columns
    (the mono-jit version inlines every LDE at its call site). Returns
    fn(traces, r, k, i2, pubx) -> (m_root_words, l_root_words, l_ev)."""
    p = spec.p
    skips = precision // steps
    kshift = original_steps // 3 * skips
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    xs_full = mm.power_table(spec, g2, precision)
    lde_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)
    omega = pow(g2, steps, p)
    inv_z_scalars = [0] + [
        pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)
    ]
    pow_scalars = [pow(omega, t, p) for t in range(skips)]
    x_last = pow(g2, precision - skips, p)
    x_last_mont = mm.mont_const(spec, x_last)
    inv_z_base = mm.mont_consts(spec, inv_z_scalars)
    x2s_base = mm.mont_consts(spec, pow_scalars)

    # one jit per LDE. The plan is a pytree ARGUMENT: closed over, its
    # tables would be baked into the module as multi-MB constants.
    #
    # STARK_TPU_MXU=1 swaps in the CRT four-step matmul LDE (ops/mxu_ntt):
    # both transforms become matrix contractions instead of butterflies.
    use_mxu = nttm.use_mxu_lde(steps, precision)
    if use_mxu:
        from stark_tpu.ops import mxu_ntt

        inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision)
        lde_base = jax.jit(lambda t, ip, bp: mxu_ntt.lde_mxu(ip, bp, t))
        lde_j = lambda t: lde_base(t, inv_plan, big_plan)

        @jax.jit
        def lde_many_j(ts, ip, bp):
            return mxu_ntt.lde_mxu_many(ip, bp, ts)

        lde_many_base = lde_many_j
        if precision > _MXU_FUSE_MAX_PRECISION:
            # per-column dispatches: the fused multi-column module's live
            # HLO temps (~1 GB/column in the three-level plan)
            lde_many = lambda ts: [lde_j(t) for t in ts]
        else:
            # all 9 columns in ONE dispatch (sequentially scheduled by XLA)
            lde_many = lambda ts: lde_many_base(ts, inv_plan, big_plan)
    else:
        lde_base = jax.jit(lambda t, pl: nttm.lde(spec, t, pl))
        lde_j = lambda t: lde_base(t, lde_plan)
        lde_many = None

    @jax.jit
    def acc_j(traces, r_mont):
        vn, vd = kernels.rand_combination(
            spec, r_mont, traces["idx"], traces["perm"], traces["s"]
        )
        return kernels.accumulator_mini(spec, vn, vd)

    inv_z_full = jnp.tile(inv_z_base, (1, precision // skips))
    x2s_full = jnp.tile(x2s_base, (1, precision // skips))
    # Zb3 = x - g2^(precision-skips) and its inverse depend only on the
    # domain: precompute the inverse once per circuit size
    zb3 = mm.msub(spec, xs_full, jnp.broadcast_to(x_last_mont, xs_full.shape))
    inv_zb3 = mm.multi_inv(spec, zb3)

    def rest_fn(evs, a_ev, r_mont, k_mont, i2_mont, inv_zb2, dom):
        inv_z_full, x2s_full, xs_full, inv_zb3 = dom
        q1 = kernels.q1_eval(
            spec, evs["s"], evs["k"], evs["p"], evs["f0"], evs["f1"], skips
        )
        q2 = kernels.q2_eval(spec, evs["p"], evs["f2"], kshift)
        vn_big, vd_big = kernels.rand_combination(
            spec, r_mont, evs["idx"], evs["perm"], evs["s"]
        )
        q3 = kernels.q3_eval(spec, a_ev, vn_big, vd_big, skips)
        d1 = kernels.mmul_periodic_const(spec, q1, inv_z_full)
        d2 = kernels.mmul_periodic_const(spec, q2, inv_z_full)
        d3 = kernels.mmul_periodic_const(spec, q3, inv_z_full)
        i2_ev = kernels.horner_eval(spec, i2_mont, xs_full)
        one_big = jnp.broadcast_to(mm.mont_one(spec), evs["s"].shape)
        b2_ev = kernels.sub_mul_ev(spec, evs["s"], i2_ev, inv_zb2)
        b3_ev = kernels.sub_mul_ev(spec, a_ev, one_big, inv_zb3)
        l_ev = kernels.linear_combination(
            spec, k_mont, x2s_full, evs["p"], a_ev, evs["s"],
            d1, d2, d3, b2_ev, b3_ev,
        )
        m_words = _leaves_to_words(
            spec, [evs["p"], a_ev, evs["s"], d1, d2, d3, b2_ev, b3_ev]
        )
        l_words = _leaves_to_words(spec, [l_ev])
        return m_words, l_words, l_ev

    rest = jax.jit(rest_fn)
    dom = (inv_z_full, x2s_full, xs_full, inv_zb3)

    root_m_j = jax.jit(lambda w: merkle_root_local(w, 256))
    root_l_j = jax.jit(lambda w: merkle_root_local(w, 32))

    # Zb2 = prod_i (x - x_i) over the PUBLIC wire positions and its inverse
    # depend only on the circuit (utils.rs:438-455): compute once per
    # circuit via `run.prep(pubx_mont)` and reuse across proves (the
    # orchestrated prover caches it the same way; see prove.py). xs rides
    # as an argument so the table is not baked into the module.
    inv_zb2_j = jax.jit(
        lambda pubx_mont, xs: mm.multi_inv(
            spec, kernels.vanishing_eval(spec, xs, pubx_mont)
        )
    )

    names = ("k", "f0", "f1", "f2", "s", "p", "idx", "perm")

    def run(traces, r_mont, k_mont, i2_mont, pubx_mont, inv_zb2=None):
        if inv_zb2 is None:
            inv_zb2 = inv_zb2_j(pubx_mont, xs_full)
        a_mini = acc_j(traces, r_mont)
        if lde_many is not None:
            outs = lde_many([traces[n] for n in names] + [a_mini])
            evs = dict(zip(names, outs[:8]))
            a_ev = outs[8]
        else:
            evs = {name: lde_j(traces[name]) for name in names}
            a_ev = lde_j(a_mini)
        m_words, l_words, l_ev = rest(
            evs, a_ev, r_mont, k_mont, i2_mont, inv_zb2, dom
        )
        return root_m_j(m_words), root_l_j(l_words), l_ev

    run.prep = lambda pubx_mont: inv_zb2_j(pubx_mont, xs_full)
    return run


def build_proof_stages(
    spec: FieldSpec, steps: int, precision: int, original_steps: int, mesh=None,
    digest: str = "blake2s",
):
    """Staged jits for the REAL (transcript-driven) prover.

    Same kernels as `build_staged_prover` but split at the Fiat-Shamir
    round trips, so `protocol.prove.mk_r1cs_proof` runs the whole device
    side in ~8 dispatches instead of eager op-at-a-time chains (each eager
    sync waits for the device and costs a host round trip).

    `digest`: the `H: Digest` type parameter of the reference's
    prove/verify/FRI (`run.rs:528-533`, `fri.rs:17-26`). "poseidon" commits
    the l-tree and every FRI tree (32-byte canonical-value leaves, always
    canonical BLS12-381 Fr chunks) with the reference-compatible Poseidon
    digest, fully device-resident. The m-tree's 256-byte leaves exceed
    Poseidon's 64-byte input cap — the reference's own limitation
    (`poseidon.rs:33` panics) — and the a-tree's 40-byte (perm||S) leaves
    straddle the 32-byte chunk boundary, making chunk canonicity
    witness-dependent (the reference would panic mid-prove); both stay
    blake2s under either digest, as does the Fiat-Shamir sampler (the
    reference's `get_pseudorandom_indices`/`mk_seed` are blake-only, not
    H-generic: `commitment/src/utils.rs:82-109`, `r1cs-stark/src/utils.rs:51-57`).

    `mesh`: an optional 1-D `jax.sharding.Mesh` ("d" axis). ONE prover
    serves every geometry (the reference's crossbeam `Worker` axis,
    `fft.rs:195-251`, generalized to a device mesh):

    * mesh=None / 1 device: the single-device engine -- at d=1 the
      four-step factorization is the identity decomposition, so the local
      kernel IS the sharded kernel's degenerate case;
    * d>1: the `columns` stage runs the four-step NTT + quotient body
      under shard_map, every downstream stage (commits, linear
      combination, FRI, branch gathers) runs the SAME jnp code on the
      global sharded arrays, and the device transcript + single-
      materialization orchestration in :mod:`stark_tpu.protocol.prove` is
      shared verbatim.
    """
    from stark_tpu.merkle import tree as mt

    sharded = mesh is not None and int(mesh.devices.size) > 1

    p = spec.p
    skips = precision // steps
    kshift = original_steps // 3 * skips
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    xs_full = mm.power_table(spec, g2, precision)
    omega = pow(g2, steps, p)
    inv_z_scalars = [0] + [
        pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)
    ]
    pow_scalars = [pow(omega, t, p) for t in range(skips)]
    x_last = pow(g2, precision - skips, p)
    x_last_mont = mm.mont_const(spec, x_last)
    # device-memory plan: Z^-1 and x^steps are periodic with period
    # `skips`; up to 2^22 the full (L, N) tiles stay resident, above it the
    # (L, skips) bases multiply through `kernels.mul_periodic` (saves 1 GB
    # at precision 2^23) and Zb3^-1 is recomputed per prove instead of
    # held resident (another 512 MB).
    _big = precision > int(
        os.environ.get("STARK_TPU_PERIODIC_TABLES_ABOVE", str(1 << 22))
    )
    def _inv_zb3(xs):
        zb3 = mm.msub(spec, xs, jnp.broadcast_to(x_last_mont, xs.shape))
        return mm.multi_inv(spec, zb3)

    if _big:
        inv_z_full = mm.mont_consts(spec, inv_z_scalars)  # (L, skips) base
        x2s_full = mm.mont_consts(spec, pow_scalars)
        inv_zb3 = None
    else:
        inv_z_full = jnp.tile(
            mm.mont_consts(spec, inv_z_scalars), (1, precision // skips)
        )
        x2s_full = jnp.tile(
            mm.mont_consts(spec, pow_scalars), (1, precision // skips)
        )
        inv_zb3 = _inv_zb3(xs_full)

    use_mxu = (not sharded) and nttm.use_mxu_lde(steps, precision)
    if use_mxu:
        from stark_tpu.ops import mxu_ntt

        inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision)

        @jax.jit
        def lde_many_j(ts, ip, bp):
            return mxu_ntt.lde_mxu_many(ip, bp, ts)

        lde_many_base = lde_many_j
        if precision > _MXU_FUSE_MAX_PRECISION:
            # see build_staged_prover: fused multi-column modules OOM >2^20
            lde_many = lambda ts: [
                lde_many_base([t], inv_plan, big_plan)[0] for t in ts
            ]
        else:
            lde_many = lambda ts: lde_many_base(ts, inv_plan, big_plan)
    elif not sharded:
        lde_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)

        @jax.jit
        def lde_butterfly_j(t, pl):
            return nttm.lde(spec, t, pl)

        lde_base = lde_butterfly_j
        lde_many = lambda ts: [lde_base(t, lde_plan) for t in ts]
    else:
        lde_many = None  # d>1: LDEs live inside the shard_map columns step

    to_mont_j = jax.jit(lambda raw: mm.to_mont(spec, raw))

    def _flag_idx_perm(f1_u8, f2_u8, perm_lo, perm_hi):
        """Shared device construction of the public columns: flags from u8
        vectors, f0 (all ones, run.rs:287) and idx (iota) generated on
        device, the permutation from u32 lo/hi pairs. Flags zero-pad
        beyond original_steps like every other column (prove.rs:100-116
        zero-pads inside inv_best_fft)."""
        L = spec.num_limbs
        one = jnp.broadcast_to(mm.mont_one(spec), (L, steps))
        zero = jnp.zeros((L, steps), jnp.uint32)
        iota0 = jnp.arange(steps, dtype=jnp.uint32)
        f0_m = jnp.where(iota0[None, :] < original_steps, one, zero)
        f1_m = jnp.where(f1_u8[None, :] != 0, one, zero)
        f2_m = jnp.where(f2_u8[None, :] != 0, one, zero)

        def from_u32pair(lo, hi):
            limbs = jnp.stack(
                [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
                + [jnp.zeros_like(lo)] * (L - 4),
                axis=0,
            )
            return mm.to_mont(spec, limbs)

        idx_m = from_u32pair(iota0, jnp.zeros_like(iota0))
        perm_m = from_u32pair(perm_lo, perm_hi)
        return f0_m, f1_m, f2_m, idx_m, perm_m

    @jax.jit
    def traces_j(ksp_bytes, f1_u8, f2_u8, perm_lo, perm_hi):
        """Montgomery trace columns from a minimal host transfer:
        ksp_bytes (3*steps, 2L) canonical LE byte rows of K||S||P (the
        native arithmetizer's output format -- half the bytes of limb
        planes), flag columns as u8 vectors, the
        permutation as u32 lo/hi."""
        ksp = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, ksp_bytes))
        k_m = jax.lax.slice_in_dim(ksp, 0, steps, axis=1)
        s_m = jax.lax.slice_in_dim(ksp, steps, 2 * steps, axis=1)
        p_m = jax.lax.slice_in_dim(ksp, 2 * steps, 3 * steps, axis=1)
        f0_m, f1_m, f2_m, idx_m, perm_m = _flag_idx_perm(
            f1_u8, f2_u8, perm_lo, perm_hi
        )
        return {
            "k": k_m, "f0": f0_m, "f1": f1_m, "f2": f2_m,
            "s": s_m, "p": p_m, "idx": idx_m, "perm": perm_m,
        }

    @jax.jit
    def wit_traces_j(k_bytes, wit_bytes, wids, f1_u8, f2_u8, perm_lo, perm_hi):
        """Device arithmetization of the witness-dependent columns: only the
        witness (n_wires rows) is uploaded per proof. S gathers
        the witness by per-slot wire id (run.rs:150-171 semantics, ids from
        `arithmetize.slot_wire_ids_np`); P is the gated accumulator
        P[j] = F1[j]*P[j-1] + K[j]*S[j] (run.rs:159, the recurrence Q1
        checks at utils.rs:181-213) as a log-depth associative scan whose
        combine uses only mod-adds and selects (the F1 gate is boolean)."""
        k_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, k_bytes))
        wit_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, wit_bytes))
        iota0 = jnp.arange(steps, dtype=jnp.uint32)
        live = iota0 < original_steps
        s_m = jnp.where(live[None, :], jnp.take(wit_m, wids, axis=1), 0)
        ks = mm.mmul(spec, k_m, s_m)
        # F1 is 0 at every constraint start; broadcast to the limb planes
        # (associative_scan wants identical leaf shapes on the scan axis)
        gate = jnp.broadcast_to(
            ((f1_u8 != 0) & live)[None, :], ks.shape
        )

        def combine(left, right):
            al, bl = left
            ar, br = right
            return (al & ar, jnp.where(ar, mm.madd(spec, bl, br), br))

        _, p_m = jax.lax.associative_scan(combine, (gate, ks), axis=1)
        f0_m, f1_m, f2_m, idx_m, perm_m = _flag_idx_perm(
            f1_u8, f2_u8, perm_lo, perm_hi
        )
        return {
            "k": k_m, "f0": f0_m, "f1": f1_m, "f2": f2_m,
            "s": s_m, "p": p_m, "idx": idx_m, "perm": perm_m,
        }

    @jax.jit
    def v_cols_j(k_bytes, f1_u8, f2_u8, perm_lo, perm_hi):
        """The verifier's 6 public columns (no S/P) from the same minimal
        transfer shape (K as canonical LE byte rows)."""
        k_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, k_bytes))
        f0_m, f1_m, f2_m, idx_m, perm_m = _flag_idx_perm(
            f1_u8, f2_u8, perm_lo, perm_hi
        )
        return [k_m, f0_m, f1_m, f2_m, idx_m, perm_m]

    @jax.jit
    def a_root_j(perm_lo, perm_hi, s_small):
        # 40-byte (perm u64 LE || S) leaves, root only (utils.rs:250-270;
        # the reference commits with gen_proofs(&[]) -- no branches)
        s_words = _leaves_to_words(spec, [s_small])[:8]
        a_words = jnp.concatenate(
            [perm_lo, perm_hi, s_words,
             jnp.zeros((6, s_words.shape[1]), jnp.uint32)],
            axis=0,
        )
        return merkle_root_local(a_words, 40)

    @jax.jit
    def acc_j(idx_small, perm_small, s_small, r_mont):
        vn, vd = kernels.rand_combination(spec, r_mont, idx_small, perm_small, s_small)
        return kernels.accumulator_mini(spec, vn, vd)

    # Donation aliases a stage's dead inputs to its outputs. CPU jit
    # ignores donation (and warns), so only donate on accelerators.
    # STARK_TPU_DONATE=0 disables donation (per-stage profiling re-invokes
    # stages on the same buffers, which donation would delete).
    _donate = (
        jax.default_backend() != "cpu"
        and os.environ.get("STARK_TPU_DONATE", "1") != "0"
    )

    # Quotient and boundary columns (utils.rs:181-524), one program per
    # column: fused, the three quotients' and both batched inversions'
    # temporaries are live at once (~64 GiB at precision 2^23 on an 80 GB
    # H100). Each D also returns its divisibility flag (utils.rs:379-418),
    # which piggybacks on the final sync. Domain tables travel as
    # arguments, never closures: closed-over concrete arrays would be baked
    # into every module as constants.
    def _q_bad(q):
        return jnp.any(q[:, ::skips] != 0)

    @jax.jit
    def d1_j(s, k, p_ev, f0, f1, inv_z):
        q = kernels.q1_eval(spec, s, k, p_ev, f0, f1, skips)
        return kernels.mmul_periodic_const(spec, q, inv_z), _q_bad(q)

    @jax.jit
    def d2_j(p_ev, f2, inv_z):
        q = kernels.q2_eval(spec, p_ev, f2, kshift)
        return kernels.mmul_periodic_const(spec, q, inv_z), _q_bad(q)

    @jax.jit
    def d3_j(a_ev, idx, perm, s, r_mont, inv_z):
        vn_big, vd_big = kernels.rand_combination(spec, r_mont, idx, perm, s)
        q = kernels.q3_eval(spec, a_ev, vn_big, vd_big, skips)
        return kernels.mmul_periodic_const(spec, q, inv_z), _q_bad(q)

    def _inv_zb2(pubx_mont, xs):
        return mm.multi_inv(spec, kernels.vanishing_eval(spec, xs, pubx_mont))

    @jax.jit
    def b2_j(s, i2_mont, xs, b2in):
        """`b2in`: the resident (L, N) Zb2^-1 table (circuit-static,
        utils.rs:438-455, made once per circuit by the `inv_zb2` stage) or,
        on big domains, pubx_mont, and Zb2^-1 is recomputed here (512 MB
        at 2^23)."""
        inv_zb2 = _inv_zb2(b2in, xs) if _big else b2in
        i2_ev = kernels.horner_eval(spec, i2_mont, xs)
        return kernels.sub_mul_ev(spec, s, i2_ev, inv_zb2)

    @jax.jit
    def b3_j(a_ev, xs, inv_zb3):
        """`inv_zb3`: the resident table, or None on big domains, where it
        is recomputed here."""
        if inv_zb3 is None:
            inv_zb3 = _inv_zb3(xs)
        one_big = jnp.broadcast_to(mm.mont_one(spec), a_ev.shape)
        return kernels.sub_mul_ev(spec, a_ev, one_big, inv_zb3)

    def rest_a(evs, a_ev, r_mont, i2_mont, b2in):
        """The single-use LDE columns (k/f0/f1/f2/idx/perm) are popped from
        `evs`, so each frees after its last reader; s/p/a pass through."""
        s, p_ev = evs["s"], evs["p"]
        d1, bad1 = d1_j(
            s, evs.pop("k"), p_ev, evs.pop("f0"), evs.pop("f1"), inv_z_full
        )
        d2, bad2 = d2_j(p_ev, evs.pop("f2"), inv_z_full)
        d3, bad3 = d3_j(
            a_ev, evs.pop("idx"), evs.pop("perm"), s, r_mont, inv_z_full
        )
        cols = {
            "p": p_ev, "a": a_ev, "s": s, "d1": d1, "d2": d2, "d3": d3,
            "b2": b2_j(s, i2_mont, xs_full, b2in),
            "b3": b3_j(a_ev, xs_full, inv_zb3),
        }
        return cols, jnp.stack([bad1, bad2, bad3]).astype(jnp.uint32)

    # per-circuit Zb2^-1 table stage (small domains; see b2_j)
    inv_zb2_j = None if (_big or sharded) else jax.jit(_inv_zb2)

    _COLS = ("p", "a", "s", "d1", "d2", "d3", "b2", "b3")

    @jax.jit
    def m_commit_j(cols):
        words = _leaves_to_words(spec, [cols[n] for n in _COLS])
        return words, mt._build_layers(words, 256)

    @jax.jit
    def m_commit_stream_j(cols):
        """Big-domain m-tree commit: first-layer digests are hashed from
        the columns in SEQUENTIAL chunks (lax.map bounds the transient
        leaf-word buffer to one chunk) and the (64, N) leaf words are never
        materialized -- at precision 2^23 that buffer alone is 2.1 GB and
        its packing concat another 2.1 GB. Branch leaves are instead
        re-packed from gathered column values (`m_gather_j`), the same
        recompute-at-proof-time economy as the reference's double
        `gen_proofs` call (`prove.rs:331,348`). Returns layers only."""
        n_chunks = 8
        chunk = precision // n_chunks

        def body(i):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk, 1)
            words = _leaves_to_words(spec, [sl(cols[c]) for c in _COLS])
            return b2.blake2s_words(words, 256)  # (8, chunk)

        digs = jax.lax.map(body, jnp.arange(n_chunks))  # (C, 8, chunk)
        h = jnp.moveaxis(digs, 0, 1).reshape(8, precision)
        layers = [h]
        while h.shape[1] > 1:
            m = h.shape[1] // 2
            pair = h.reshape(8, m, 2)
            msg = jnp.concatenate([pair[:, :, 0], pair[:, :, 1]], axis=0)
            h = b2.blake2s_words(msg, 64)
            layers.append(h)
        return tuple(layers)

    @jax.jit
    def m_gather_j(cols, layers, aug_idx):
        """Branch gather for the streamed m-tree: leaf words are packed
        on the fly from the ~320 gathered column values; sibling digests
        gather from the retained layers. Output layout matches
        `mt._gather_flat_j` (leaf words then 8-row nodes per level)."""
        idx = aug_idx.astype(jnp.int32)
        vals = [cols[c][:, idx] for c in _COLS]
        words = _leaves_to_words(spec, vals)  # (64, k)
        gathered = [words]
        t = idx
        for layer in layers[:-1]:
            gathered.append(layer[:, t ^ 1])
            t = t // 2
        return jnp.concatenate(gathered, axis=0)

    # linc is the LAST consumer of the 8 m-tree columns on SMALL domains
    # (m_commit executes before it on the stream); donating them frees
    # ~4.3 GB as soon as L is computed instead of at python del time. On
    # big domains the columns must SURVIVE linc (m_gather_j re-packs branch
    # leaves from them), so they are not donated there.
    @functools.partial(
        jax.jit, donate_argnums=(1,) if (_donate and not _big) else ()
    )
    def linc_base_j(k_mont, cols, x2s_full):
        # on big domains eleven live (L, N) terms would not fit beside the
        # columns, so 8 sequential chunks (each a whole number of x^steps
        # periods, which needs the periodic x2s base) bound them to one
        # chunk's worth; smaller domains run it as one chunk
        chunk = max(precision // 8, skips) if _big else precision

        def body(i):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk, 1)
            return kernels.linear_combination(
                spec, k_mont, x2s_full, *[sl(cols[n]) for n in _COLS]
            )

        out = jax.lax.map(body, jnp.arange(precision // chunk))
        return jnp.moveaxis(out, 0, 1).reshape(spec.num_limbs, precision)

    def linc_j(k_mont, cols):
        return linc_base_j(k_mont, cols, x2s_full)

    @jax.jit
    def l_commit_j(l_ev):
        words = _leaves_to_words(spec, [l_ev])
        return words, mt.build_layers_digest(words, 32, digest)

    from stark_tpu.protocol import device_transcript as dt

    @jax.jit
    def r_j(a_root_words8):
        # utils.rs:272-290 via the device transcript
        return dt.random_ff_mont(spec, a_root_words8, precision, 3, 0)

    @jax.jit
    def k_j(m_root_words8):
        # prove.rs:274-283 via the device transcript
        return dt.k_coeffs_mont(spec, m_root_words8)

    @jax.jit
    def pos_j(l_root_words8):
        # prove.rs:337-359: spot-check positions + their 4 companions
        pos = dt.pseudorandom_indices(
            l_root_words8, precision, SPOT_CHECK_SECURITY_FACTOR, skips
        )
        offs = jnp.asarray(
            np.array(
                [0, precision - skips, kshift, 2 * kshift], dtype=np.uint32
            )
        )
        aug = (pos[:, None] + offs[None, :]) % np.uint32(precision)
        return pos, aug.reshape(-1)

    # --- dispatch-count fusions (small domains, single device) ------------
    # Fusing the statically-chained middle of the prove (commit -> k ->
    # linear combination -> l-commit, and positions -> both branch
    # gathers) removes 5 dispatches per prove. Big domains keep the
    # separate stages (the streamed m-tree path interleaves differently);
    # meshes keep them too (GSPMD partitioning is per-stage).

    @functools.partial(
        jax.jit, donate_argnums=(0,) if (_donate and not _big) else ()
    )
    def commit_chain_j(cols, x2s_arg):
        """m-commit -> k coefficients -> linear combination -> l-commit,
        one dispatch (prove.rs:235-332 between Fiat-Shamir round trips)."""
        m_words = _leaves_to_words(spec, [cols[n] for n in _COLS])
        m_layers = mt._build_layers(m_words, 256)
        m_root_w = m_layers[-1][:, 0]
        k_mont = dt.k_coeffs_mont(spec, m_root_w)
        l_ev = kernels.linear_combination(
            spec, k_mont, x2s_arg, *[cols[n] for n in _COLS]
        )
        l_words = _leaves_to_words(spec, [l_ev])
        l_layers = mt.build_layers_digest(l_words, 32, digest)
        return (
            m_words, tuple(m_layers), k_mont, l_ev, l_words, tuple(l_layers)
        )

    def commit_chain(cols):
        return commit_chain_j(cols, x2s_full)

    @jax.jit
    def pos_gather_j(l_root_words8, l_words, l_layers, m_words, m_layers):
        """Spot-check positions + BOTH branch gathers, one dispatch."""
        pos = dt.pseudorandom_indices(
            l_root_words8, precision, SPOT_CHECK_SECURITY_FACTOR, skips
        )
        offs = jnp.asarray(
            np.array(
                [0, precision - skips, kshift, 2 * kshift], dtype=np.uint32
            )
        )
        aug = ((pos[:, None] + offs[None, :]) % np.uint32(precision)).reshape(-1)
        l_flat = mt._gather_flat_j(
            l_words, tuple(l_layers[:-1]), pos.astype(jnp.int32)
        )
        m_flat = mt._gather_flat_j(
            m_words, tuple(m_layers[:-1]), aug.astype(jnp.int32)
        )
        return l_flat, m_flat

    def warm_targets(n_pub: int, n_wires: int = 0):
        """(jit_fn, example_args) pairs covering every compile a prove (and
        the verifier's column stages) will trigger at this circuit size, so
        :mod:`stark_tpu.protocol.warmup` can lower+compile them from a
        thread pool. Args are ShapeDtypeStructs except the LDE plans, whose
        concrete tables double as trace-time constants. Pass n_wires to
        also cover the device-arithmetization stage (its compile depends on
        the witness length)."""
        L = spec.num_limbs
        S = lambda sh, dt=jnp.uint32: jax.ShapeDtypeStruct(sh, dt)
        u8 = jnp.uint8
        col = S((L, steps))
        ev = S((L, precision))
        cols_av = {n: ev for n in _COLS}
        root8 = S((8,))
        t = [
            (v_cols_j, (S((steps, 2 * L), u8), S((steps,), u8),
                        S((steps,), u8), S((steps,)), S((steps,)))),
        ]
        if n_wires:
            # device arithmetization active: the legacy traces_j upload path
            # is never called, so don't spend cold-start time compiling it
            t.append(
                (wit_traces_j, (S((steps, 2 * L), u8), S((n_wires, 2 * L), u8),
                                S((steps,)), S((steps,), u8), S((steps,), u8),
                                S((steps,)), S((steps,))))
            )
        else:
            t.append(
                (traces_j, (S((3 * steps, 2 * L), u8), S((steps,), u8),
                            S((steps,), u8), S((steps,)), S((steps,))))
            )
        t += [
            (a_root_j, (S((1, steps)), S((1, steps)), col)),
            (acc_j, (col, col, col, S((L, 3)))),
        ]
        iz = S(inv_z_full.shape)
        t += [
            (d1_j, (ev, ev, ev, ev, ev, iz)),
            (d2_j, (ev, ev, iz)),
            (d3_j, (ev, ev, ev, ev, S((L, 3)), iz)),
            (b2_j, (ev, S((L, n_pub)), ev, S((L, n_pub)) if _big else ev)),
            (b3_j, (ev, ev, None if _big else ev)),
        ]
        t += [
            (linc_base_j, (S((L, 11)), cols_av, S((L, skips)) if _big else ev)),
            (l_commit_j, (ev,)),
            (r_j, (root8,)),
            (k_j, (root8,)),
            (pos_j, (root8,)),
        ]
        if inv_zb2_j is not None:
            t.append((inv_zb2_j, (S((L, n_pub)), ev)))
        if not (_big or sharded):
            n_layers = precision.bit_length()
            m_layer_avals = tuple(S((8, precision >> i)) for i in range(n_layers))
            t.append((commit_chain_j, (cols_av, ev)))
            t.append(
                (pos_gather_j,
                 (root8, S((16, precision)), m_layer_avals,
                  S((64, precision)), m_layer_avals))
            )
        if _big:
            n_layers = precision.bit_length()  # widths N..1
            layer_avals = tuple(
                S((8, precision >> k)) for k in range(n_layers)
            )
            t.append((m_commit_stream_j, (cols_av,)))
            t.append(
                (m_gather_j,
                 (cols_av, layer_avals,
                  S((4 * SPOT_CHECK_SECURITY_FACTOR,), jnp.int32)))
            )
        else:
            t.append((m_commit_j, (cols_av,)))
        if use_mxu:
            if precision > _MXU_FUSE_MAX_PRECISION:
                t.append((lde_many_base, ([col], inv_plan, big_plan)))
            else:
                t.append((lde_many_base, ([col] * 9, inv_plan, big_plan)))
                t.append((lde_many_base, ([col] * 6, inv_plan, big_plan)))
        elif not sharded:
            t.append((lde_base, (col, lde_plan)))
        return t

    # --- the unified `columns` stage: traces -> (8 m-tree columns, q_bad).
    # Single mesh-independent interface for the whole middle of the prover
    # (9 LDEs + accumulator + quotients + boundaries); the two bodies
    # compute identical field values (asserted byte-identical by
    # tests/test_parallel_full.py and the driver's dryrun_multichip).
    _TRACE8 = ("k", "f0", "f1", "f2", "s", "p", "idx", "perm")

    if sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from stark_tpu.parallel import prove_sharded as psh

        shard = NamedSharding(mesh, P(None, "d"))
        repl = NamedSharding(mesh, P(None, None))
        # multi-process jobs (jax.distributed) cannot device_put to other
        # hosts' devices: build global arrays shard-by-shard instead
        _multiproc = jax.process_count() > 1

        def _gput(x, pspec):
            if _multiproc:
                from stark_tpu.parallel import distributed as dist

                return dist.put_global(np.asarray(x), mesh, pspec)
            return jax.device_put(x, NamedSharding(mesh, pspec))

        xs_full = _gput(xs_full, P(None, "d"))
        sharded_cols = psh.build_sharded_columns_step(
            spec, mesh, steps, precision, original_steps
        )

        def columns(traces, r_mont, i2_mont, b2in):
            # b2in = pubx_mont on meshes: the sharded body computes Zb2^-1
            # itself (GSPMD partitions its pure-XLA multi_inv fine)
            return sharded_cols(traces, xs_full, r_mont, i2_mont, b2in)

        def put_rows(x):
            """Host (N, ...) arrays sharded contiguously on the row axis."""
            nd = getattr(x, "ndim", 1)
            return _gput(x, P(*(("d",) + (None,) * (nd - 1))))

        put_repl = lambda x: _gput(x, P(None, None))
    else:

        def columns(traces, r_mont, i2_mont, b2in):
            # b2in: cached Zb2^-1 table (small domains) or pubx_mont (big
            # domains); see b2_j
            a_mini = acc_j(traces["idx"], traces["perm"], traces["s"], r_mont)
            outs = lde_many([traces[n] for n in _TRACE8] + [a_mini])
            evs = dict(zip(_TRACE8, outs[:8]))
            a_ev = outs[8]
            # the 6 single-use LDE columns (k/f0/f1/f2/idx/perm) free as
            # soon as their quotient program has read them -- ~3.2 GB at 2^23
            del outs
            return rest_a(evs, a_ev, r_mont, i2_mont, b2in)

        if mesh is not None:
            _dev = mesh.devices.flat[0]
            put_rows = lambda x: jax.device_put(x, _dev)
            put_repl = put_rows
        else:
            put_rows = jnp.asarray
            put_repl = jnp.asarray

    def resident_bytes():
        """Device bytes this stage set holds RESIDENT between dispatches
        (domain tables + NTT plan tables). Per-circuit
        caches (Zb2^-1 table, device statics, retained tree layers) are
        owned by callers and accounted separately (bench.py)."""
        groups = {
            "xs_full": [xs_full],
            "domain_tables": [
                t for t in (inv_z_full, x2s_full, inv_zb3) if t is not None
            ],
        }
        if use_mxu:
            groups["ntt_plan_tables"] = [inv_plan, big_plan]
        elif not sharded:
            groups["ntt_plan_tables"] = [lde_plan]
        return {
            k: int(
                sum(
                    getattr(l, "nbytes", 0)
                    for l in jax.tree_util.tree_leaves(v)
                )
            )
            for k, v in groups.items()
        }

    return {
        "xs_full": xs_full,
        "to_mont": to_mont_j,
        "resident_bytes": resident_bytes,
        "traces": traces_j,
        "wit_traces": wit_traces_j,
        "v_cols": v_cols_j,
        "lde_many": lde_many,
        "a_root": a_root_j,
        "acc": acc_j,
        "inv_zb2": inv_zb2_j,
        "columns": columns,
        "put_rows": put_rows,
        "put_repl": put_repl,
        "big": _big,
        "m_commit": m_commit_j,
        "m_commit_stream": m_commit_stream_j,
        "m_gather": m_gather_j,
        "linc": linc_j,
        "l_commit": l_commit_j,
        "commit_chain": None if (_big or sharded) else commit_chain,
        "pos_gather": None if (_big or sharded) else pos_gather_j,
        "r": r_j,
        "k": k_j,
        "pos": pos_j,
        "warm_targets": warm_targets,
    }


def make_example_inputs(spec: FieldSpec, arith, public_wires, params):
    """Build the (traces, r, k, i2, pubx) inputs for the core step from an
    arithmetization (host side)."""
    from stark_tpu.utils import poly_host as ph

    steps = params.steps
    pad = steps - arith.original_steps
    permuted = list(arith.permuted_indices) + list(range(arith.original_steps, steps))
    tm = lambda ints: mm.to_mont(spec, mm.ints_to_limbs_np(ints, spec))
    traces = {
        "k": tm(arith.coefficients + [0] * pad),
        "f0": tm(arith.flag0 + [0] * pad),
        "f1": tm(arith.flag1 + [0] * pad),
        "f2": tm(arith.flag2 + [0] * pad),
        "s": tm(arith.witness_trace + [0] * pad),
        "p": tm(arith.computational_trace + [0] * pad),
        "idx": tm(list(range(steps))),
        "perm": tm(permuted),
    }
    r_mont = mm.mont_consts(spec, [5, 7, 11])  # stand-in transcript scalars
    k_mont = mm.mont_consts(spec, list(range(1, 12)))
    pub_xs = [
        pow(params.g2, params.skips * w, spec.p)
        for (_, w) in arith.public_first_indices
    ]
    pub_ys = [public_wires[k] for (k, _) in arith.public_first_indices]
    i2 = ph.lagrange_interp(spec, pub_xs, pub_ys)
    return traces, r_mont, k_mont, mm.mont_consts(spec, i2), mm.mont_consts(spec, pub_xs)
