"""Vectorized modular bigint arithmetic on device (uint32 16-bit-limb planes).

Device replacement for the reference's `ff_derive` 4xu64 Montgomery
arithmetic (`/root/reference/packages/ff_utils/src/fp.rs:8-12`). Field
elements are decomposed into L limbs of 16 bits held in uint32 lanes:
16x16-bit limb products are exact in uint32 and deferred-carry column sums
stay below 2^22, so the whole multiply+reduce runs as plain element-wise
integer ops that XLA fuses.

Layout: **limbs-first** `(L, ...batch)` uint32, little-endian limb order,
each limb < 2^16. Limbs-first keeps the trailing axis as the big batch axis,
so every limb plane is one long contiguous run.

Values on device are kept in **Montgomery form** (x*R mod p, R = 2^(16L));
`to_mont`/`from_mont` convert at the host/hash boundaries.

Compile-time discipline (XLA chokes on huge unrolled elementwise graphs):
limb loops run inside `lax.fori_loop`/`lax.while_loop` bodies that compile
once, multiplication uses full REDC (3 schoolbook products, each a small
fori_loop) instead of a word-interleaved CIOS unroll, and carry/borrow
normalization is a data-dependent while_loop (typically 2 passes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs

U32 = jnp.uint32
_MASK = np.uint32(LIMB_MASK)
_SHIFT = LIMB_BITS


# ---------------------------------------------------------------------------
# host <-> limb conversion (numpy, canonical form, limbs-first)
# ---------------------------------------------------------------------------

def ints_to_limbs_np(values, spec: FieldSpec) -> np.ndarray:
    """Iterable of python ints -> (L, N) uint32 canonical limbs.

    Bulk path: one `int.to_bytes` per value + a vectorized byte->limb
    recombine (the per-limb python loop cost ~19 s at 2^17 values)."""
    vals = [int(v) % spec.p for v in values]
    L = spec.num_limbs
    nbytes = L * LIMB_BITS // 8
    if not vals:
        return np.empty((L, 0), dtype=np.uint32)
    buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    by = np.frombuffer(buf, np.uint8).reshape(len(vals), nbytes).T
    bpl = LIMB_BITS // 8  # bytes per limb
    out = np.zeros((L, len(vals)), dtype=np.uint32)
    for b in range(bpl):
        out |= by[b::bpl].astype(np.uint32) << (8 * b)
    return np.ascontiguousarray(out)


def limbs_to_ints_np(arr, spec: FieldSpec) -> list[int]:
    a = np.asarray(arr)
    L = spec.num_limbs
    flat = a.reshape(L, -1)
    return [
        sum(int(flat[i, n]) << (LIMB_BITS * i) for i in range(L))
        for n in range(flat.shape[1])
    ]


def bytes_le_to_limbs_np(data: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """(N, nbytes<=2L) uint8 little-endian canonical bytes -> (L, N) uint32."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    nb = spec.num_limbs * 2
    buf = np.zeros((n, nb), dtype=np.uint8)
    w = min(nb, data.shape[1])
    buf[:, :w] = data[:, :w]
    pairs = buf.reshape(n, spec.num_limbs, 2).astype(np.uint32)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 8)).T.copy()


def bytes_le_to_limbs(spec: FieldSpec, data):
    """Device twin of `bytes_le_to_limbs_np`: (N, 2L) uint8 canonical
    little-endian byte rows -> (L, N) uint32 limb planes. Lets the host
    transfer half the bytes (u8 rows, the native arithmetizer's output
    format) and unpack on device."""
    import jax.numpy as jnp

    pairs = data.reshape(data.shape[0], spec.num_limbs, 2).astype(jnp.uint32)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 8)).T


def limbs_to_bytes_le_np(arr, spec: FieldSpec) -> np.ndarray:
    """(L, N) uint32 canonical -> (N, repr_bytes) uint8 little-endian."""
    a = np.asarray(arr, dtype=np.uint32).reshape(spec.num_limbs, -1).T  # (N, L)
    n = a.shape[0]
    lo = (a & 0xFF).astype(np.uint8)
    hi = ((a >> 8) & 0xFF).astype(np.uint8)
    inter = np.stack([lo, hi], axis=-1).reshape(n, spec.num_limbs * 2)
    out = np.zeros((n, spec.repr_bytes), dtype=np.uint8)
    w = min(spec.repr_bytes, spec.num_limbs * 2)
    out[:, :w] = inter[:, :w]
    return out


def _const_col(limbs, ndim: int):
    """Tuple of limb ints -> (L, 1, ..., 1) uint32 broadcastable constant."""
    return jnp.asarray(limbs, dtype=U32).reshape((len(limbs),) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# carry normalization (device)
# ---------------------------------------------------------------------------

def _normalize(cols):
    """(K, ...) uint32 deferred-carry columns -> exact 16-bit limbs.

    The caller must size K so the total value fits in K limbs (carries out of
    the top column are dropped). Runs one static pass then a while_loop for
    residual ripple (worst case K passes, typically 1-2)."""

    def step(c):
        lo = c & _MASK
        hi = c >> _SHIFT
        return lo.at[1:].add(hi[:-1])

    c = step(cols)
    return jax.lax.while_loop(lambda c: jnp.any((c >> _SHIFT) != 0), step, c)


# ---------------------------------------------------------------------------
# schoolbook product (deferred-carry columns) via fori_loop
# ---------------------------------------------------------------------------

def _bigmul_cols(a, b):
    """Columns of the product a*b: out[k] = sum_{i+j=k} a_i*b_j (lo/hi split).

    a: (L, ...) exact 16-bit limbs; b: (Lb, ...) exact 16-bit limbs.
    Returns (L+Lb+1, ...) uint32 deferred-carry columns, each < 2^22.
    Runs as a fori_loop over a's limbs; the accumulator is updated in place.
    (The accumulator always has full width so the dynamic update slices never
    clamp at the boundary.)
    """
    L = a.shape[0]
    Lb = b.shape[0]
    batch = a.shape[1:]
    acc = jnp.zeros((L + Lb + 1,) + batch, U32)
    zrow = jnp.zeros((1,) + batch, U32)

    def body(i, acc):
        ai = jax.lax.dynamic_index_in_dim(a, i, axis=0, keepdims=False)
        pp = ai[None] * b  # (Lb, ...) exact 16x16 products
        contrib = jnp.concatenate([pp & _MASK, zrow], axis=0)
        contrib = contrib.at[1:].add(pp >> _SHIFT)  # (Lb+1, ...)
        cur = jax.lax.dynamic_slice_in_dim(acc, i, Lb + 1, axis=0)
        return jax.lax.dynamic_update_slice_in_dim(acc, cur + contrib, i, axis=0)

    return jax.lax.fori_loop(0, L, body, acc)


# ---------------------------------------------------------------------------
# conditional subtract / add-sub
# ---------------------------------------------------------------------------

def _cond_sub_p(spec: FieldSpec, limbs, top):
    """Value = top*2^(16L) + limbs (< 2p): subtract p where value >= p.

    limbs: (L, ...) exact 16-bit; top: (...) in {0,1}."""
    L = spec.num_limbs
    pbar = _const_col(int_to_limbs((1 << spec.r_bits) - spec.p, L), limbs.ndim)
    s = jnp.concatenate([limbs + pbar, top[None]], axis=0)  # (L+1, ...)
    s = _normalize(s)
    ge_p = s[L] > 0  # v + (2^16L - p) overflowed 16L bits -> v >= p
    return jnp.where(ge_p[None], s[:L], limbs)


@functools.partial(jax.jit, static_argnums=0)
def madd(spec: FieldSpec, a, b):
    """(a + b) mod p; valid in both canonical and Montgomery form."""
    L = spec.num_limbs
    zrow = jnp.zeros((1,) + a.shape[1:], U32)
    s = _normalize(jnp.concatenate([a + b, zrow], axis=0))
    return _cond_sub_p(spec, s[:L], s[L])


@functools.partial(jax.jit, static_argnums=0)
def msub(spec: FieldSpec, a, b):
    """(a - b) mod p via complement-add: a + (2^(16L)-1-b) + 1."""
    L = spec.num_limbs
    batch = a.shape[1:]
    comp = _MASK - b
    s = a + comp
    s = s.at[0].add(1)
    s = _normalize(jnp.concatenate([s, jnp.zeros((1,) + batch, U32)], axis=0))
    a_ge_b = s[L] > 0
    p_col = _const_col(spec.p_limbs, a.ndim)
    fixed = _normalize(
        jnp.concatenate([s[:L] + p_col, jnp.zeros((1,) + batch, U32)], axis=0)
    )[:L]
    return jnp.where(a_ge_b[None], s[:L], fixed)


# ---------------------------------------------------------------------------
# Montgomery multiply (full REDC: t = a*b; m = (t mod R)*n' mod R; (t+m*p)/R)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=0)
def mmul(spec: FieldSpec, a, b):
    """Montgomery product (a * b * R^{-1}) mod p. a, b: (L, ...) < p."""
    L = spec.num_limbs
    ndim = a.ndim
    n_prime = int_to_limbs((-pow(spec.p, -1, 1 << spec.r_bits)) % (1 << spec.r_bits), L)
    n_prime_col = jnp.broadcast_to(_const_col(n_prime, ndim), a.shape)
    p_col = jnp.broadcast_to(_const_col(spec.p_limbs, ndim), a.shape)

    t = _normalize(_bigmul_cols(a, b))[: 2 * L + 1]  # (2L+1, ...) exact
    m = _normalize(_bigmul_cols(t[:L], n_prime_col))[:L]  # mod 2^(16L)
    u = _bigmul_cols(m, p_col)[: 2 * L + 1]
    s = _normalize(u + t)  # low L limbs are 0 by construction of m
    return _cond_sub_p(spec, s[L : 2 * L], s[2 * L])


# ---------------------------------------------------------------------------
# Montgomery-form conversions and constants
# ---------------------------------------------------------------------------

def mont_const(spec: FieldSpec, x: int):
    """Host int -> Montgomery-form (L, 1) device constant."""
    limbs = int_to_limbs((int(x) % spec.p) * spec.r_mod_p % spec.p, spec.num_limbs)
    return jnp.asarray(limbs, dtype=U32).reshape(spec.num_limbs, 1)


def mont_one(spec: FieldSpec):
    return mont_const(spec, 1)


def mont_consts(spec: FieldSpec, xs):
    """Host ints -> Montgomery-form (L, N) device array."""
    return jnp.asarray(
        ints_to_limbs_np([(int(x) % spec.p) * spec.r_mod_p % spec.p for x in xs], spec)
    )


@functools.partial(jax.jit, static_argnums=0)
def to_mont(spec: FieldSpec, a):
    r2 = jnp.broadcast_to(
        _const_col(int_to_limbs(spec.r2_mod_p, spec.num_limbs), a.ndim), a.shape
    )
    return mmul(spec, a, r2)


@functools.partial(jax.jit, static_argnums=0)
def from_mont(spec: FieldSpec, a):
    one = jnp.zeros_like(a).at[0].set(1)
    return mmul(spec, a, one)


# ---------------------------------------------------------------------------
# pow / inverse
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 2))
def mpow(spec: FieldSpec, a, e: int):
    """a^e elementwise (Montgomery in/out), static exponent; MSB-first
    square-and-multiply inside a fori_loop so the graph stays small."""
    nbits = max(e.bit_length(), 1)
    bits = jnp.asarray([(e >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=U32)
    one = jnp.broadcast_to(
        mont_one(spec).reshape((spec.num_limbs,) + (1,) * (a.ndim - 1)), a.shape
    )

    def body(i, acc):
        acc = mmul(spec, acc, acc)
        mul = mmul(spec, acc, a)
        return jnp.where(bits[i] > 0, mul, acc)

    return jax.lax.fori_loop(0, nbits, body, one)


@functools.partial(jax.jit, static_argnums=0)
def minv(spec: FieldSpec, a):
    """Elementwise inverse via Fermat (a^(p-2)). Montgomery in/out; 0 -> 0."""
    return mpow(spec, a, spec.p - 2)


# ---------------------------------------------------------------------------
# prefix products and batched inversion
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 2))
def prefix_prod(spec: FieldSpec, v, reverse: bool = False):
    """Inclusive prefix product along axis 1 of a (L, N) Montgomery array
    (suffix products with `reverse`).

    A log-depth `lax.associative_scan` with `mmul` as the operator: each
    level is one wide multiply. A sequential blocked scan measured 20x
    slower on the GPU (per-step launches; PERF.md). Field products are
    exact, so the result does not depend on the association order.
    """
    return jax.lax.associative_scan(
        lambda a, b: mmul(spec, a, b), v, reverse=reverse, axis=1
    )


@functools.partial(jax.jit, static_argnums=0)
def multi_inv(spec: FieldSpec, a):
    """Batched inversion along axis 1 of (L, N), zero-skipping like the
    reference (`fri/src/poly_utils.rs:38-70`): zeros map to 0.

    inv(a_i) = total_inv * prefix_exc_i * suffix_exc_i with ONE Fermat
    inversion of the running total."""
    L, n = a.shape
    one = jnp.broadcast_to(mont_one(spec), (L, n))
    z = jnp.all(a == 0, axis=0)[None]
    v = jnp.where(z, one, a)

    # both scans use reverse=False so the nested-jit jaxpr cache shares ONE
    # trace of prefix_prod per (spec, shape)
    pre_inc = prefix_prod(spec, v)
    suf_inc = prefix_prod(spec, v[:, ::-1])[:, ::-1]
    total_inv = minv(spec, pre_inc[:, -1:])
    pre_exc = jnp.concatenate([one[:, :1], pre_inc[:, :-1]], axis=1)
    suf_exc = jnp.concatenate([suf_inc[:, 1:], one[:, :1]], axis=1)
    out = mmul(
        spec, mmul(spec, jnp.broadcast_to(total_inv, (L, n)), pre_exc), suf_exc
    )
    return jnp.where(z, jnp.zeros_like(a), out)


# ---------------------------------------------------------------------------
# power tables
# ---------------------------------------------------------------------------

def power_table(spec: FieldSpec, g: int, n: int):
    """[1, g, ..., g^(n-1)] Montgomery form, (L, n), n a power of two.

    Log-depth doubling on device; replaces the reference's sequential
    `expand_root_of_unity` (`fri/src/fft.rs:5-14`) without the O(n) host loop.
    """
    assert n & (n - 1) == 0 and n >= 1
    table = mont_one(spec)
    cur = mont_const(spec, g)  # g^(table width)
    while table.shape[1] < n:
        table = _pt_step(spec, table, cur)
        cur = mmul(spec, cur, cur)
    return table


@functools.partial(jax.jit, static_argnums=0)
def _pt_step(spec: FieldSpec, table, cur):
    return jnp.concatenate(
        [table, mmul(spec, table, jnp.broadcast_to(cur, table.shape))], axis=1
    )
