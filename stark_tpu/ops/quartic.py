"""Batched degree-4 Lagrange interpolation and evaluation (FRI row ops).

Device version of the reference's quartic fast path
(`/root/reference/packages/fri/src/poly_utils.rs:442-511`): `multi_interp_4`
interpolates Q independent 4-point sets with one shared batched inversion;
`eval_quartic4` evaluates the resulting cubics. Arrays are limbs-first
Montgomery: xsets/ysets are (L, Q, 4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import modmath as mm


@functools.partial(jax.jit, static_argnums=0)
def eval_quartic_batch(spec: FieldSpec, polys, x):
    """polys: (L, Q, 4); x: (L, Q) or (L, 1) broadcastable. Returns (L, Q)."""
    if x.ndim == 2 and x.shape[1] == 1:
        x = jnp.broadcast_to(x, (x.shape[0], polys.shape[1]))
    xsq = mm.mmul(spec, x, x)
    xcb = mm.mmul(spec, xsq, x)
    acc = polys[:, :, 0]
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 1], x))
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 2], xsq))
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 3], xcb))
    return acc


@functools.partial(jax.jit, static_argnums=0)
def multi_interp_4(spec: FieldSpec, xsets, ysets):
    """Batched 4-point Lagrange interpolation, (L, Q, 4) -> (L, Q, 4).

    Same closed form as the reference (`poly_utils.rs:449-511`): per set,
    build the four cubics eq_i vanishing at the other three xs, evaluate each
    at its own x, batch-invert all 4Q denominators at once, and combine.
    """
    L, Q, _ = xsets.shape
    x = [xsets[:, :, j] for j in range(4)]
    y = [ysets[:, :, j] for j in range(4)]
    mul = lambda a, b: mm.mmul(spec, a, b)
    add = lambda a, b: mm.madd(spec, a, b)
    zero = jnp.zeros((L, Q), jnp.uint32)
    neg = lambda a: mm.msub(spec, zero, a)
    one = jnp.broadcast_to(mm.mont_one(spec).reshape(L, 1), (L, Q))

    x01 = mul(x[0], x[1])
    x02 = mul(x[0], x[2])
    x03 = mul(x[0], x[3])
    x12 = mul(x[1], x[2])
    x13 = mul(x[1], x[3])
    x23 = mul(x[2], x[3])

    def eq(xab, xac, xbc, xa, xb, xc, xd_prod):
        # cubic with roots {xa, xb, xc}: [-xa*xb*xc, xa*xb+xa*xc+xb*xc,
        #                                 -(xa+xb+xc), 1]
        c0 = neg(xd_prod)
        c1 = add(add(xab, xac), xbc)
        c2 = neg(add(add(xa, xb), xc))
        return jnp.stack([c0, c1, c2, one], axis=-1)  # (L, Q, 4)

    eq0 = eq(x12, x13, x23, x[1], x[2], x[3], mul(x12, x[3]))
    eq1 = eq(x02, x03, x23, x[0], x[2], x[3], mul(x02, x[3]))
    eq2 = eq(x01, x03, x13, x[0], x[1], x[3], mul(x01, x[3]))
    eq3 = eq(x01, x02, x12, x[0], x[1], x[2], mul(x01, x[2]))

    e0 = eval_quartic_batch(spec, eq0, x[0])
    e1 = eval_quartic_batch(spec, eq1, x[1])
    e2 = eval_quartic_batch(spec, eq2, x[2])
    e3 = eval_quartic_batch(spec, eq3, x[3])

    # one shared batched inversion of all 4Q denominators
    denoms = jnp.stack([e0, e1, e2, e3], axis=-1).reshape(L, 4 * Q)
    invs = mm.multi_inv(spec, denoms).reshape(L, Q, 4)

    out = jnp.zeros((L, Q, 4), jnp.uint32)
    for j, eqj in enumerate([eq0, eq1, eq2, eq3]):
        w = mul(y[j], invs[:, :, j])  # (L, Q)
        w4 = jnp.broadcast_to(w[:, :, None], eqj.shape)
        out = mm.madd(spec, out, mm.mmul(spec, eqj, w4))
    return out
