"""Mesh-sharded prover core: the full device compute of `mk_r1cs_proof`
with the evaluation domain sharded over a 1-D device mesh.

This is the multi-chip mapping promised by SURVEY.md section 7/9: the
reference's only parallel axis (crossbeam threads over the FFT and Merkle
build, `fft.rs:195-251`, `pallarel_merkle_tree.rs:59-114`) becomes
collectives over a `jax.sharding.Mesh`:

* LDE: four-step NTT with all-to-all transposes (:mod:`ntt4`);
* trace-relation shifts (P(x/g2), P(x +/- k*skips)): global rolls built from
  `ppermute` boundary exchanges -- no data-dependent gathers;
* quotient/boundary/linear-combination kernels: embarrassingly parallel,
  run on local chunks unchanged;
* Merkle: leaves hashed and folded locally to per-device subroots, then an
  all_gather + replicated top fold (the reference's chunked in-place
  builder, `merkle_proof_in_place.rs:106-206`, has the same two-level
  shape).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import blake2s as b2
from stark_tpu.ops import modmath as mm
from stark_tpu.ops.ntt import _ntt_core
from stark_tpu.parallel import ntt4
from stark_tpu.protocol import kernels


def roll_sharded(x_local, shift: int, axis_name: str, n_devices: int):
    """Global jnp.roll(x, shift, axis=1) on a contiguously sharded (L, N)
    array; per-device body. shift may be any integer (static)."""
    L, M = x_local.shape
    d = n_devices
    n = d * M
    s = shift % n
    if s == 0:
        return x_local
    q, rem = divmod(s, M)

    def send(chunk, dev_shift):
        if dev_shift % d == 0:
            return chunk
        perm = [(src, (src + dev_shift) % d) for src in range(d)]
        return jax.lax.ppermute(chunk, axis_name, perm)

    if rem == 0:
        return send(x_local, q)
    hi = send(x_local[:, M - rem :], q + 1)  # becomes out[:, :rem]
    lo = send(x_local[:, : M - rem], q)  # becomes out[:, rem:]
    return jnp.concatenate([hi, lo], axis=1)


def merkle_root_words(spec_unused, leaf_words, leaf_bytes: int, axis_name, n_devices):
    """Per-device body: (W, M) local leaf words -> (8,) global root words.

    Local log-depth fold to one subroot per device, all_gather, replicated
    top fold. Requires leaves-per-device >= 1 and powers of two."""
    h = b2.blake2s_words(leaf_words, leaf_bytes)  # (8, M)
    while h.shape[1] > 1:
        m = h.shape[1] // 2
        pair = h.reshape(8, m, 2)
        msg = jnp.concatenate([pair[:, :, 0], pair[:, :, 1]], axis=0)
        h = b2.blake2s_words(msg, 64)
    sub = h[:, 0]  # (8,)
    allsub = jax.lax.all_gather(sub, axis_name, axis=1)  # (8, d)
    h = allsub
    while h.shape[1] > 1:
        m = h.shape[1] // 2
        pair = h.reshape(8, m, 2)
        msg = jnp.concatenate([pair[:, :, 0], pair[:, :, 1]], axis=0)
        h = b2.blake2s_words(msg, 64)
    return h[:, 0]


def lde_local(
    spec: FieldSpec,
    trace_local,
    axis_name: str,
    n_devices: int,
    steps_tabs,
    prec_tabs,
    n_inv_mont,
    ext: int,
    m_plans=(None, None),
):
    """Per-device LDE: sharded iNTT on the steps domain, all_gather the
    coefficients, local zero-pad slice, sharded NTT on the precision
    domain. trace_local: (L, steps/d).

    The *_tabs are the GLOBAL (w_d_half, w_m_half, tw_global) tables from
    `ntt4.make_tables` (closed over, hence replicated); the per-device
    twiddle slice is carved out here by mesh index."""
    L, Ms = trace_local.shape
    d = n_devices
    steps = Ms * d
    me = jax.lax.axis_index(axis_name)

    def tw_slice(tw_global):
        m = tw_global.shape[2]
        return jax.lax.dynamic_slice_in_dim(tw_global, me * (m // d), m // d, axis=2)

    coeff_local = ntt4.ntt_sharded_local(
        spec,
        trace_local,
        axis_name,
        d,
        w_d_half=steps_tabs[0],
        w_m_half=steps_tabs[1],
        tw_local=tw_slice(steps_tabs[2]),
        n_inv_mont=n_inv_mont,
        m_plan=m_plans[0],
    )
    # gather all coefficients (steps is 8x smaller than precision)
    coeffs = jax.lax.all_gather(coeff_local, axis_name, axis=1, tiled=True)
    # this device's precision-domain chunk of the zero-padded coefficients
    Mp = steps * ext // d
    start = me * Mp
    padded = jnp.concatenate(
        [coeffs, jnp.zeros((L, steps * ext - steps), jnp.uint32)], axis=1
    )
    chunk = jax.lax.dynamic_slice_in_dim(padded, start, Mp, axis=1)
    return ntt4.ntt_sharded_local(
        spec,
        chunk,
        axis_name,
        d,
        w_d_half=prec_tabs[0],
        w_m_half=prec_tabs[1],
        tw_local=tw_slice(prec_tabs[2]),
        m_plan=m_plans[1],
    )


def _use_mesh_mxu(spec, steps: int, precision: int, d: int) -> bool:
    """Route the sharded body's LOCAL M-point DFTs onto the CRT matmul
    engine? Same default as the single-chip engine,
    bounded by the two-level plan's exactness limit (local M <= 2^20).
    STARK_TPU_MESH_MXU=0/1 overrides."""
    import os

    from stark_tpu.ops import ntt as nttm

    env = os.environ.get("STARK_TPU_MESH_MXU", "auto")
    if env == "0":
        return False
    if precision // d > 1 << 20 or steps // d < 4 or spec.num_limbs != 16:
        return False
    if env == "1":
        return True
    return nttm.use_mxu_lde(steps, precision)


def _make_domain(spec: FieldSpec, mesh: Mesh, steps: int, precision: int):
    """Shared host-side domain constants for the sharded stages."""
    d = mesh.devices.size
    skips = precision // steps
    p = spec.p
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    omega = pow(g2, steps, p)
    # per-device CRT plans for the local M-point DFTs of the four-step
    # transforms (step 5 of ntt4.ntt_sharded_local); roots are w_N^d of
    # the (inverse) steps transform and the forward precision transform
    m_plan_steps = m_plan_prec = None
    if _use_mesh_mxu(spec, steps, precision, int(d)):
        from stark_tpu.ops import mxu_ntt

        m_plan_steps = mxu_ntt.make_ntt_plan_cached(
            spec, pow(spec.inv(g1), int(d), p), steps // int(d)
        )
        m_plan_prec = mxu_ntt.make_ntt_plan_cached(
            spec, pow(g2, int(d), p), precision // int(d)
        )
    return {
        "d": d,
        "skips": skips,
        "g1": g1,
        "g2": g2,
        "steps_tabs_inv": ntt4.make_tables(spec, g1, steps, d, inverse=True),
        "prec_tabs": ntt4.make_tables(spec, g2, precision, d),
        "m_plan_steps": m_plan_steps,
        "m_plan_prec": m_plan_prec,
        "n_inv": mm.mont_const(spec, spec.inv(steps)),
        "inv_z_scalars": [0]
        + [pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)],
        "pow_scalars": [pow(omega, t, p) for t in range(skips)],
        "x_last": pow(g2, precision - skips, p),
    }


def _columns_body(
    spec, dom, steps, precision, original_steps, axis,
    traces, xs_local, r_mont, i2_mont, pubx_mont,
):
    """Per-device body computing the 8 m-tree columns (everything up to but
    excluding the linear combination, which needs the m-root transcript
    round trip). Returns (cols dict, q_bad divisibility flags)."""
    d, skips = dom["d"], dom["skips"]
    kshift = original_steps // 3 * skips
    lde = lambda t: lde_local(
        spec, t, axis, d, dom["steps_tabs_inv"], dom["prec_tabs"], dom["n_inv"],
        skips, m_plans=(dom["m_plan_steps"], dom["m_plan_prec"]),
    )
    k_ev = lde(traces["k"])
    f0_ev = lde(traces["f0"])
    f1_ev = lde(traces["f1"])
    f2_ev = lde(traces["f2"])
    s_ev = lde(traces["s"])
    p_ev = lde(traces["p"])
    idx_ev = lde(traces["idx"])
    perm_ev = lde(traces["perm"])

    # accumulator on the small domain: needs a GLOBAL prefix product ->
    # gather the small domain (8x smaller), compute replicated, shard back
    s_small = jax.lax.all_gather(traces["s"], axis, axis=1, tiled=True)
    idx_small = jax.lax.all_gather(traces["idx"], axis, axis=1, tiled=True)
    perm_small = jax.lax.all_gather(traces["perm"], axis, axis=1, tiled=True)
    vn, vd_ = kernels.rand_combination(spec, r_mont, idx_small, perm_small, s_small)
    a_mini = kernels.accumulator_mini(spec, vn, vd_)
    me = jax.lax.axis_index(axis)
    a_local = jax.lax.dynamic_slice_in_dim(a_mini, me * (steps // d), steps // d, 1)
    a_ev = lde(a_local)

    q1 = _q1_local(spec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips, axis, d)
    q2 = _q2_local(spec, p_ev, f2_ev, kshift, axis, d)
    vn_big, vd_big = kernels.rand_combination(spec, r_mont, idx_ev, perm_ev, s_ev)
    q3 = _q3_local(spec, a_ev, vn_big, vd_big, skips, axis, d)

    # divisibility flags (utils.rs:379-418): Q must vanish where Z does.
    # Local chunk size is a multiple of skips, so local ::skips positions are
    # exactly the global ones.
    q_bad = jnp.stack(
        [
            jax.lax.psum(jnp.any(q[:, ::skips] != 0).astype(jnp.uint32), axis)
            for q in (q1, q2, q3)
        ]
    )

    inv_z = jnp.tile(
        mm.mont_consts(spec, dom["inv_z_scalars"]), (1, precision // d // skips)
    )
    d1 = mm.mmul(spec, q1, inv_z)
    d2 = mm.mmul(spec, q2, inv_z)
    d3 = mm.mmul(spec, q3, inv_z)

    i2_ev = kernels.horner_eval(spec, i2_mont, xs_local)
    one_big = jnp.broadcast_to(mm.mont_one(spec), s_ev.shape)
    zb2 = kernels.vanishing_eval(spec, xs_local, pubx_mont)
    zb3 = mm.msub(
        spec,
        xs_local,
        jnp.broadcast_to(mm.mont_const(spec, dom["x_last"]), xs_local.shape),
    )
    # batched inversion needs global products: use elementwise Fermat
    # locally instead (no cross-device dependence)
    b2_ev = mm.mmul(spec, mm.msub(spec, s_ev, i2_ev), mm.minv(spec, zb2))
    b3_ev = mm.mmul(spec, mm.msub(spec, a_ev, one_big), mm.minv(spec, zb3))

    cols = {
        "p": p_ev, "a": a_ev, "s": s_ev,
        "d1": d1, "d2": d2, "d3": d3, "b2": b2_ev, "b3": b3_ev,
    }
    return cols, q_bad


_COL_NAMES = ("p", "a", "s", "d1", "d2", "d3", "b2", "b3")


def build_sharded_columns_step(
    spec: FieldSpec, mesh: Mesh, steps: int, precision: int, original_steps: int
):
    """Jitted fn(traces, xs_local, r_mont, i2_mont, pubx_mont) -> (cols,
    q_bad): the m-tree columns as GLOBAL arrays sharded on the domain axis,
    for the full sharded prover (`parallel/prove_full.py`) which commits
    trees / runs FRI on them outside the shard_map."""
    dom = _make_domain(spec, mesh, steps, precision)
    axis = "d"

    def body(traces, xs_local, r_mont, i2_mont, pubx_mont):
        return _columns_body(
            spec, dom, steps, precision, original_steps, axis,
            traces, xs_local, r_mont, i2_mont, pubx_mont,
        )

    sharded = P(None, axis)
    in_specs = (
        {k: sharded for k in ["k", "f0", "f1", "f2", "s", "p", "idx", "perm"]},
        sharded,  # xs_local
        P(None, None),  # r_mont
        P(None, None),  # i2 coeffs
        P(None, None),  # public xs
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=({k: sharded for k in _COL_NAMES}, P(None)),
        check_vma=False,
    )
    return jax.jit(fn)


def build_sharded_prover_step(
    spec: FieldSpec, mesh: Mesh, steps: int, precision: int, original_steps: int
):
    """Returns a jitted fn computing the prover core over the mesh: 8
    sharded LDEs + accumulator + quotients + boundaries + linear
    combination + m/l Merkle roots.

    The jitted function takes Montgomery small-domain traces sharded on the
    steps domain plus transcript scalars, and returns (m_root_words,
    l_root_words, l_evaluations) -- the host transcript drives the rest.
    """
    dom = _make_domain(spec, mesh, steps, precision)
    d, skips = dom["d"], dom["skips"]
    axis = "d"

    def body(traces, xs_local, r_mont, k_mont, i2_mont, pubx_mont):
        # traces: dict of (L, steps/d) small-domain Montgomery chunks
        cols, _ = _columns_body(
            spec, dom, steps, precision, original_steps, axis,
            traces, xs_local, r_mont, i2_mont, pubx_mont,
        )
        x_to_steps = jnp.tile(
            mm.mont_consts(spec, dom["pow_scalars"]), (1, precision // d // skips)
        )
        l_ev = kernels.linear_combination(
            spec, k_mont, x_to_steps, *[cols[n] for n in _COL_NAMES]
        )

        # Merkle roots on-device (leaf bytes built with limb ops)
        m_leaf_words = _leaves_to_words(spec, [cols[n] for n in _COL_NAMES])
        m_root = merkle_root_words(spec, m_leaf_words, 256, axis, d)
        l_leaf_words = _leaves_to_words(spec, [l_ev])
        l_root = merkle_root_words(spec, l_leaf_words, 32, axis, d)
        return m_root, l_root, l_ev

    specs_small = P(None, axis)
    in_specs = (
        {k: specs_small for k in ["k", "f0", "f1", "f2", "s", "p", "idx", "perm"]},
        P(None, axis),  # xs_local
        P(None, None),  # r_mont
        P(None, None),  # k_mont
        P(None, None),  # i2 coeffs
        P(None, None),  # public xs
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None), P(None), P(None, axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def _q1_local(spec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips, axis, d):
    p_prev = roll_sharded(p_ev, skips, axis, d)
    return mm.mmul(
        spec,
        f0_ev,
        mm.msub(
            spec,
            p_ev,
            mm.madd(spec, mm.mmul(spec, f1_ev, p_prev), mm.mmul(spec, k_ev, s_ev)),
        ),
    )


def _q2_local(spec, p_ev, f2_ev, kshift, axis, d):
    p_plus_w = roll_sharded(p_ev, -kshift, axis, d)
    p_plus_2w = roll_sharded(p_ev, -2 * kshift, axis, d)
    return mm.mmul(spec, f2_ev, mm.msub(spec, p_plus_2w, mm.mmul(spec, p_ev, p_plus_w)))


def _q3_local(spec, a_ev, vn_big, vd_big, skips, axis, d):
    a_prev = roll_sharded(a_ev, skips, axis, d)
    return mm.msub(spec, mm.mmul(spec, a_ev, vd_big), mm.mmul(spec, a_prev, vn_big))


def _leaves_to_words(spec: FieldSpec, columns):
    """Device-side leaf packing: Montgomery columns -> (W, M) uint32 words of
    the concatenated canonical little-endian 32-byte encodings."""
    word_cols = []
    for col in columns:
        canon = mm.from_mont(spec, col)  # (L, M) 16-bit limbs
        # pack limb pairs into 32-bit LE words: word_i = limb_{2i} | limb_{2i+1}<<16
        lo = canon[0::2]
        hi = canon[1::2]
        word_cols.append(lo | (hi << np.uint32(16)))  # (L/2, M)
    words = jnp.concatenate(word_cols, axis=0)  # (8*ncols, M)
    total_bytes = 32 * len(columns)
    nblocks = max(1, (total_bytes + 63) // 64)
    padw = nblocks * 16 - words.shape[0]
    if padw:
        words = jnp.concatenate(
            [words, jnp.zeros((padw, words.shape[1]), jnp.uint32)], axis=0
        )
    return words
