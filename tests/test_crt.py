"""CRT modular matmul: exactness against python bigints.

Covers the riskiest machinery of stark_tpu.ops.crt: the redundant-lane wrap
count, balanced-digit reconstruction, banded REDC matmuls, and the
Montgomery-preserving pre-scaling (f32 dots are exact for the digit
magnitudes by construction, given full-precision matmuls)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import crt

P = spec.p
R256 = 1 << 256


def limbs_np(vals):
    a = np.zeros((16, len(vals)), np.uint32)
    for t, v in enumerate(vals):
        for i in range(16):
            a[i, t] = (v >> (16 * i)) & 0xFFFF
    return a


def ints_of(arr):
    return [
        sum(int(arr[i, t]) << (16 * i) for i in range(16))
        for t in range(arr.shape[1])
    ]


def rand_field(rng, n):
    return [int(rng.integers(0, 1 << 62)) ** 5 % P for _ in range(n)]


@pytest.fixture(scope="module")
def basis():
    # bound for K=8 matmul with pre-table: 8 * p^3 < 2^766
    return crt.CrtBasis(spec, 770)


def test_reduce_in_exact(basis):
    rng = np.random.default_rng(0)
    vals = rand_field(rng, 9)
    r = np.asarray(basis.reduce_in(jnp.asarray(limbs_np(vals))))
    for i, q in enumerate(basis.qs_host):
        assert (r[i] == np.array([v % q for v in vals])).all()


def test_reconstruct_exact(basis):
    rng = np.random.default_rng(1)
    vals = rand_field(rng, 7)
    qs = np.array(basis.qs_host, np.int64)[:, None]
    res = np.array(
        [[v % q for v in vals] for q in basis.qs_host], np.int64
    )
    s = res.copy()
    ts = np.array(basis.t_host + [1], np.int64)[:, None]
    s = (s * ts) % qs
    out = np.asarray(basis.reconstruct(jnp.asarray(s.astype(np.uint32))))
    rinv = pow(R256, -1, P)
    got = ints_of(out)
    for g, v in zip(got, vals):
        assert g == v * rinv % P


def test_crt_matmul_exact(basis):
    rng = np.random.default_rng(2)
    kout, k, b = 5, 8, 6
    w = [rand_field(rng, k) for _ in range(kout)]
    plan = crt.CrtMatmulPlan(basis, w)
    xs = [rand_field(rng, b) for _ in range(k)]
    x = np.zeros((16, k, b), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np(xs[j])
    out = np.asarray(crt.crt_matmul(basis, plan, jnp.asarray(x)))
    for kk in range(kout):
        got = ints_of(out[:, kk, :])
        for bb in range(b):
            want = sum(w[kk][j] * xs[j][bb] for j in range(k)) % P
            assert got[bb] == want


def test_crt_matmul_with_pre_table(basis):
    rng = np.random.default_rng(3)
    kout, k, b = 4, 8, 3
    w = [rand_field(rng, k) for _ in range(kout)]
    tvals = [rand_field(rng, b) for _ in range(k)]
    plan = crt.CrtMatmulPlan(basis, w)
    pre = np.array(
        [[[t % q for t in row] for row in tvals] for q in basis.qs_host],
        np.uint32,
    )
    xs = [rand_field(rng, b) for _ in range(k)]
    x = np.zeros((16, k, b), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np(xs[j])
    out = np.asarray(
        crt.crt_matmul(basis, plan, jnp.asarray(x), pre=jnp.asarray(pre))
    )
    for kk in range(kout):
        got = ints_of(out[:, kk, :])
        for bb in range(b):
            want = sum(w[kk][j] * tvals[j][bb] * xs[j][bb] for j in range(k)) % P
            assert got[bb] == want


def test_crt_matmul_jit_pytree(basis):
    """Basis and plan pass through jit as pytree arguments."""
    rng = np.random.default_rng(4)
    k = 4
    w = [rand_field(rng, k) for _ in range(k)]
    plan = crt.CrtMatmulPlan(basis, w)
    xs = [rand_field(rng, 2) for _ in range(k)]
    x = np.zeros((16, k, 2), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np(xs[j])
    f = jax.jit(lambda bs, pl, xx: crt.crt_matmul(bs, pl, xx))
    out = np.asarray(f(basis, plan, jnp.asarray(x)))
    for kk in range(k):
        got = ints_of(out[:, kk, :])
        for bb in range(2):
            want = sum(w[kk][j] * xs[j][bb] for j in range(k)) % P
            assert got[bb] == want


def test_montgomery_domain_preserved(basis):
    """Montgomery-form inputs yield Montgomery-form outputs."""
    rng = np.random.default_rng(5)
    k = 4
    w = [rand_field(rng, k) for _ in range(k)]
    plan = crt.CrtMatmulPlan(basis, w)
    xs = rand_field(rng, k)
    xm = [v * (R256 % P) % P for v in xs]  # Montgomery form (R = 2^256)
    x = np.zeros((16, k, 1), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np([xm[j]])
    out = np.asarray(crt.crt_matmul(basis, plan, jnp.asarray(x)))
    for kk in range(k):
        got = ints_of(out[:, kk, :])[0]
        want = sum(w[kk][j] * xs[j] for j in range(k)) % P
        assert got == want * (R256 % P) % P


def test_crt_matmul_edge_values(basis):
    """Extremes (0, 1, p-1, dense-limb patterns) stress the fold bounds,
    chunk boundaries, and the wrap-count recovery."""
    k = 8
    edge = [0, 1, P - 1, P - 2, (1 << 254) % P, int("f" * 63, 16) % P,
            0x8000800080008000800080008000800080008000800080008000800080008000 % P,
            P // 2]
    w = [[edge[(i + j) % len(edge)] for j in range(k)] for i in range(k)]
    plan = crt.CrtMatmulPlan(basis, w)
    xs = [[edge[(3 * i + b) % len(edge)] for b in range(4)] for i in range(k)]
    x = np.zeros((16, k, 4), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np(xs[j])
    out = np.asarray(crt.crt_matmul(basis, plan, jnp.asarray(x)))
    for kk in range(k):
        got = ints_of(out[:, kk, :])
        for bb in range(4):
            want = sum(w[kk][j] * xs[j][bb] for j in range(k)) % P
            assert got[bb] == want, (kk, bb)


def test_crt_matmul_pre_edge_values(basis):
    """Pre-table at q-1 extremes with near-p data."""
    k, b = 4, 4
    w = [[P - 1 - i * 7 - j for j in range(k)] for i in range(k)]
    plan = crt.CrtMatmulPlan(basis, w)
    tvals = [[P - 1 - 13 * t - i for t in range(b)] for i in range(k)]
    pre = np.array(
        [[[t % q for t in row] for row in tvals] for q in basis.qs_host],
        np.uint32,
    )
    xs = [[P - 1 - 29 * t - 3 * i for t in range(b)] for i in range(k)]
    x = np.zeros((16, k, b), np.uint32)
    for j in range(k):
        x[:, j, :] = limbs_np(xs[j])
    out = np.asarray(
        crt.crt_matmul(basis, plan, jnp.asarray(x), pre=jnp.asarray(pre))
    )
    for kk in range(k):
        got = ints_of(out[:, kk, :])
        for bb in range(b):
            want = sum(w[kk][j] * tvals[j][bb] * xs[j][bb] for j in range(k)) % P
            assert got[bb] == want, (kk, bb)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                sub = getattr(sub, "jaxpr", sub)  # ClosedJaxpr -> Jaxpr
                if hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("entry", ["reduce_in", "reconstruct", "crt_matmul"])
def test_crt_dots_use_highest_precision(basis, entry):
    """Every dot of the engine runs at Precision.HIGHEST: a reduced-precision
    float matmul (TF32 on GPU tensor cores) would round the digit products."""
    rng = np.random.default_rng(3)
    if entry == "reduce_in":
        fn = lambda x: basis.reduce_in(x)
        arg = jnp.asarray(rng.integers(0, 1 << 16, (16, 8)).astype(np.uint32))
    elif entry == "reconstruct":
        fn = lambda s: basis.reconstruct(s)
        arg = jnp.asarray(
            rng.integers(0, 15000, (basis.P + 1, 8)).astype(np.uint32)
        )
    else:
        w = [[int(rng.integers(0, 1 << 62)) % P for _ in range(4)] for _ in range(4)]
        plan = crt.CrtMatmulPlan(basis, w)
        fn = lambda x: crt.crt_matmul(basis, plan, x)
        arg = jnp.asarray(rng.integers(0, 1 << 16, (16, 4, 2)).astype(np.uint32))
    precs = _dot_precisions(jax.make_jaxpr(fn)(arg).jaxpr)
    assert precs, "no dot_general found"
    highest = jax.lax.Precision.HIGHEST
    assert all(p in (highest, (highest, highest)) for p in precs), precs
