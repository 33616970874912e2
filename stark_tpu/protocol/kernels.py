"""Pure-device prover kernels shared by the single-chip prover, the
multi-chip sharded path, and the driver entry points.

These are the fused element-wise stages of `mk_r1cs_proof`
(`/root/reference/packages/r1cs-stark/src/prove.rs:133-322`) expressed over
(L, precision) Montgomery limb planes. Everything here is jit-safe (no host
transcript I/O); the orchestration in :mod:`stark_tpu.protocol.prove`
interleaves these with the Fiat-Shamir commitments.
"""

from __future__ import annotations

import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import modmath as mm


def mul_periodic(spec: FieldSpec, a, base):
    """a * tile(base, N/k) WITHOUT materializing the (L, N) tile.

    Z(x)^-1 and x^steps are periodic with period EXTENSION_FACTOR on the
    evaluation domain (prove.rs:128-129,287-291 materialize the full
    tables); at precision 2^23 the two tiled tables alone cost 1 GB of
    HBM, so large domains multiply through an (L, N/k, k) x (L, 1, k)
    broadcast instead -- XLA fuses it like any elementwise op."""
    L, N = a.shape
    k = base.shape[1]
    out = mm.mmul(spec, a.reshape(L, N // k, k), base[:, None, :])
    return out.reshape(L, N)


def sub_mul_ev(spec: FieldSpec, a, b, c):
    """(a - b) * c elementwise — the boundary quotients B2/B3
    (`prove.rs:216-232`)."""
    return mm.mmul(spec, mm.msub(spec, a, b), c)


def mmul_periodic_const(spec: FieldSpec, q, mont_table):
    """q * a periodic per-domain constant (Z^-1, x^steps): the Montgomery
    table tiled full-width (small domains) or its (L, skips) periodic base
    (big domains)."""
    if mont_table.shape[1] != q.shape[1]:
        return mul_periodic(spec, q, mont_table)
    return mm.mmul(spec, q, mont_table)


def rand_combination(spec: FieldSpec, r_mont, idx_ev, perm_ev, s_ev):
    """val_nmr/val_dnm = r0 + r1*idx + r2*S (utils.rs:317-318,359-360).

    r_mont: (L, 3) Montgomery randomness columns."""
    shape = s_ev.shape
    r0 = jnp.broadcast_to(r_mont[:, 0:1], shape)
    r1 = jnp.broadcast_to(r_mont[:, 1:2], shape)
    r2 = jnp.broadcast_to(r_mont[:, 2:3], shape)
    r2s = mm.mmul(spec, r2, s_ev)
    nmr = mm.madd(spec, r0, mm.madd(spec, mm.mmul(spec, r1, idx_ev), r2s))
    dnm = mm.madd(spec, r0, mm.madd(spec, mm.mmul(spec, r1, perm_ev), r2s))
    return nmr, dnm


def accumulator_mini(spec: FieldSpec, val_nmr, val_dnm):
    """A(j) = prod(nmr)/prod(dnm) prefix ratios (utils.rs:293-339).

    inv(prefix_dnm_j) = inv(total) * suffix_excl_j, so one forward scan
    (nmr), one suffix scan (dnm) and ONE Fermat inversion suffice --
    multi_inv(prefix_dnm) would redundantly re-scan the already-scanned
    prefixes (4 sequential scan kernels instead of 2). Field values are
    identical; the (cryptographically impossible) all-zero-denominator
    case degenerates differently from multi_inv's zero-skip, which the
    reference's per-element batch inversion does not hit either."""
    L = val_nmr.shape[0]
    acc_nmr = mm.prefix_prod(spec, val_nmr)
    suf_inc = mm.prefix_prod(spec, val_dnm[:, ::-1])[:, ::-1]
    total_inv = mm.minv(spec, suf_inc[:, :1])  # suf_inc[:, 0] = prod(all)
    one = jnp.broadcast_to(mm.mont_one(spec), (L, 1))
    suf_exc = jnp.concatenate([suf_inc[:, 1:], one], axis=1)
    inv_prefix = mm.mmul(
        spec, jnp.broadcast_to(total_inv, val_dnm.shape), suf_exc
    )
    return mm.mmul(spec, acc_nmr, inv_prefix)


def q1_eval(spec: FieldSpec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips: int):
    """Q1 = F0*(P - F1*P_prev - K*S) (utils.rs:181-213)."""
    p_prev = jnp.roll(p_ev, skips, axis=1)
    return mm.mmul(
        spec,
        f0_ev,
        mm.msub(
            spec,
            p_ev,
            mm.madd(spec, mm.mmul(spec, f1_ev, p_prev), mm.mmul(spec, k_ev, s_ev)),
        ),
    )


def q2_eval(spec: FieldSpec, p_ev, f2_ev, kshift: int):
    """Q2 = F2*(P(+2k) - P*P(+k)), k = original_steps/3*skips
    (utils.rs:217-248)."""
    p_plus_w = jnp.roll(p_ev, -kshift, axis=1)
    p_plus_2w = jnp.roll(p_ev, -2 * kshift, axis=1)
    return mm.mmul(spec, f2_ev, mm.msub(spec, p_plus_2w, mm.mmul(spec, p_ev, p_plus_w)))


def q3_eval(spec: FieldSpec, a_ev, val_nmr_big, val_dnm_big, skips: int):
    """Q3 = A*val_dnm - A_prev*val_nmr (utils.rs:344-376)."""
    a_prev = jnp.roll(a_ev, skips, axis=1)
    return mm.msub(
        spec, mm.mmul(spec, a_ev, val_dnm_big), mm.mmul(spec, a_prev, val_nmr_big)
    )


def horner_eval(spec: FieldSpec, coeffs_mont, xs_full):
    """Evaluate a low-degree polynomial (host-interpolated boundary
    interpolant) on the whole domain. coeffs_mont: (L, deg+1)."""
    out = jnp.zeros_like(xs_full)
    for i in range(coeffs_mont.shape[1] - 1, -1, -1):
        c = jnp.broadcast_to(coeffs_mont[:, i : i + 1], xs_full.shape)
        out = mm.madd(spec, mm.mmul(spec, out, xs_full), c)
    return out


def vanishing_eval(spec: FieldSpec, xs_full, points_mont):
    """Zb(x) = prod_i (x - x_i). points_mont: (L, n_points)."""
    acc = jnp.broadcast_to(mm.mont_one(spec), xs_full.shape)
    for i in range(points_mont.shape[1]):
        xi = jnp.broadcast_to(points_mont[:, i : i + 1], xs_full.shape)
        acc = mm.mmul(spec, acc, mm.msub(spec, xs_full, xi))
    return acc


def linear_combination(
    spec: FieldSpec, k_mont, x_to_steps, p_ev, a_ev, s_ev, d1, d2, d3, b2, b3,
):
    """L = k0*D1 + k1*D2 + k2*D3 + k3*P + k4*P*x^steps + k5*B2 + k6*B2*x^steps
         + k7*B3 + k8*B3*x^steps + k9*A + k10*S  (prove.rs:293-322).

    k_mont: (L, 11) Montgomery Fiat-Shamir coefficients. x_to_steps may be
    the full (L, N) table or its (L, skips) periodic base (large domains;
    see `mul_periodic`)."""
    if x_to_steps.shape[1] != s_ev.shape[1]:
        mulx = lambda col: mul_periodic(spec, col, x_to_steps)
    else:
        mulx = lambda col: mm.mmul(spec, col, x_to_steps)
    shape = s_ev.shape
    km = [jnp.broadcast_to(k_mont[:, i : i + 1], shape) for i in range(11)]
    terms = [
        mm.mmul(spec, km[0], d1),
        mm.mmul(spec, km[1], d2),
        mm.mmul(spec, km[2], d3),
        mm.mmul(spec, km[3], p_ev),
        mm.mmul(spec, km[4], mulx(p_ev)),
        mm.mmul(spec, km[5], b2),
        mm.mmul(spec, km[6], mulx(b2)),
        mm.mmul(spec, km[7], b3),
        mm.mmul(spec, km[8], mulx(b3)),
        mm.mmul(spec, km[9], a_ev),
        mm.mmul(spec, km[10], s_ev),
    ]
    out = terms[0]
    for t in terms[1:]:
        out = mm.madd(spec, out, t)
    return out
