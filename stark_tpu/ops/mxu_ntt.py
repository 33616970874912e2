"""Four-step NTT as CRT modular matmuls (the matrix engine).

``DFT_n`` with ``n = n1*n2`` (j = j1*n2 + j2, k = k1 + n1*k2):

    A1[k1, j2] = sum_j1 W1[k1, j1] * x[j1, j2]      W1 = (w^n2)^(k1*j1)
    A2[k1, j2] = A1[k1, j2] * T[k1, j2]             T  = w^(k1*j2)
    X[k1, k2]  = sum_j2 W2[k2, j2] * A2[k1, j2]     W2 = (w^n1)^(k2*j2)

Both sums are :func:`stark_tpu.ops.crt.crt_matmul` calls (step B takes T as
a residue-space pre-table); the output laid out as (k2, k1) reshapes
directly to the natural-order flat DFT — no bit reversals anywhere.

Compared to the butterfly path (`stark_tpu/ops/ntt.py`), whose cost is the
16-limb Montgomery multiply, the O(n^1.5) DFT matmuls run as exact f32
contractions. This mirrors the role of
the reference's `parallel_fft` (`/root/reference/packages/fri/src/fft.rs:
195-251`) as the "big transform" engine.

The LDE (`inv_best_fft` -> zero-pad -> `best_fft`, `prove.rs:100-169`)
becomes: small four-step iNTT (scale n^-1 folded into its W2) -> natural-
order coefficients -> reshape (nz1, n2) of the zero-padded vector is just
the coefficient array itself -> big NTT whose step A contracts only the
nz1 = steps/n2 nonzero rows.
"""

from __future__ import annotations

import warnings

import numpy as np
import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import crt

import jax as _jax


def _tw_dtype():
    """u16 twiddle storage halves device memory; STARK_TPU_CRT_TW32=1
    stores u32 (debug toggle)."""
    import os

    return np.uint32 if os.environ.get("STARK_TPU_CRT_TW32", "0") == "1" else np.uint16


def _pow_matrix(base: int, rows: int, cols: int, p: int, scale: int = 1):
    """[[scale * base^(r*c) mod p]] as a list of row lists (python ints)."""
    out = []
    cur_row_base = 1  # base^r
    for _ in range(rows):
        row = []
        v = scale % p
        for _ in range(cols):
            row.append(v)
            v = v * cur_row_base % p
        out.append(row)
        cur_row_base = cur_row_base * base % p
    return out


def _twiddle_residues(w: int, n1: int, n2: int, p: int, qs) -> np.ndarray:
    """T[k1, j2] = w^(k1*j2) laid out as (P+1, j2, k1) residues u16 (the
    step-B pre-table: data arrives transposed as (n2, n1))."""
    flat = []
    wk1 = 1
    for _ in range(n1):
        v = 1
        row = []
        for _ in range(n2):
            row.append(v)
            v = v * wk1 % p
        flat.extend(row)
        wk1 = wk1 * w % p
    by = crt.ints_to_bytes_np(flat)
    res = crt.residues_of_ints_np(by, qs)  # (P+1, n1*n2)
    res = res.reshape(len(qs), n1, n2).transpose(0, 2, 1)
    return np.ascontiguousarray(res.astype(_tw_dtype()))


class MxuNttPlan:
    """Tables for one (root, n, n1, n2[, scale, nz1]) transform. Pytree."""

    def __init__(
        self,
        spec: FieldSpec,
        root: int,
        n: int,
        n1: int | None = None,
        n2: int | None = None,
        scale: int = 1,
        nz1: int | None = None,
        stepa_pre: bool = False,
    ):
        p = spec.p
        if n1 is None:
            logn = n.bit_length() - 1
            n1 = 1 << ((logn + 1) // 2)
            n2 = n // n1
        assert n1 * n2 == n and max(n1, n2) <= 1024, (
            "f32 accumulation is exact only for contractions <= 1024"
        )
        self.n, self.n1, self.n2 = n, n1, n2
        self.nz1 = nz1 if nz1 is not None else n1
        assert self.nz1 <= n1
        w1 = pow(root, n2, p)
        w2 = pow(root, n1, p)
        # a step-A pre-table (three-level mid twiddle) adds a factor p
        bits_a = (
            (self.nz1 - 1).bit_length()
            + (3 if stepa_pre else 2) * p.bit_length() + 2
        )
        bits_b = (n2 - 1).bit_length() + 3 * p.bit_length() + 2
        self.basis_a = crt.CrtBasis(spec, bits_a)
        self.basis_b = crt.CrtBasis(spec, bits_b)
        wa = _pow_matrix(w1, n1, self.nz1, p)  # W1[k1, j1], j1 < nz1
        self.plan_a = crt.CrtMatmulPlan(self.basis_a, wa)
        wb = _pow_matrix(w2, n2, n2, p, scale=scale)  # W2[k2, j2] * scale
        self.plan_b = crt.CrtMatmulPlan(self.basis_b, wb)
        self.twiddle = jnp.asarray(
            _twiddle_residues(root, n1, n2, p, self.basis_b.qs_host)
        )


def _mxuplan_flatten(pl: MxuNttPlan):
    return (
        (pl.basis_a, pl.basis_b, pl.plan_a, pl.plan_b, pl.twiddle),
        (pl.n, pl.n1, pl.n2, pl.nz1),
    )


def _mxuplan_unflatten(aux, leaves):
    pl = object.__new__(MxuNttPlan)
    pl.basis_a, pl.basis_b, pl.plan_a, pl.plan_b, pl.twiddle = leaves
    pl.n, pl.n1, pl.n2, pl.nz1 = aux
    return pl


_jax.tree_util.register_pytree_node(MxuNttPlan, _mxuplan_flatten, _mxuplan_unflatten)


def ntt_mxu(plan: MxuNttPlan, x):
    """Natural-order DFT of (L, m) canonical/Montgomery limb planes, where
    m = nz1*n2 (m = n without zero-padding structure). Returns (L, n)."""
    L = x.shape[0]
    xv = x.reshape(L, plan.nz1, plan.n2)
    a1 = crt.crt_matmul(plan.basis_a, plan.plan_a, xv)  # (L, n1, n2)
    a1t = jnp.swapaxes(a1, 1, 2)  # (L, n2, n1)
    out = crt.crt_matmul(
        plan.basis_b, plan.plan_b, a1t, pre=plan.twiddle.astype(jnp.uint32)
    )  # (L, n2out, n1) = X[k2, k1]
    return out.reshape(L, plan.n)


class MxuNttPlan3:
    """Three-level four-step plan for n = n1 * m (m = inner n up to 2^20,
    n1 <= 1024): step A contracts n1, a full-size twiddle scales, and the
    inner transform is a batched two-level `MxuNttPlan` applied across the
    n1 rows. Extends the matrix engine to n up to 2^30 (table memory caps it
    in practice around 2^24). Pytree."""

    def __init__(
        self, spec: FieldSpec, root: int, n: int, scale: int = 1,
        n1: int | None = None,
    ):
        p = spec.p
        logn = n.bit_length() - 1
        if n1 is None:
            assert logn > 20, "use MxuNttPlan for n <= 2^20"
            n1 = 1 << (logn - 20)
        assert n1 <= 1024, "n too large for the three-level split"
        m = n // n1
        assert n1 * m == n
        self.n, self.n1, self.m = n, n1, m
        w1 = pow(root, m, p)  # order n1
        bits_a = (n1 - 1).bit_length() + 2 * p.bit_length() + 2
        self.basis_a = crt.CrtBasis(spec, bits_a)
        self.plan_a = crt.CrtMatmulPlan(self.basis_a, _pow_matrix(w1, n1, n1, p))
        # mid twiddle W[k1, j23] = root^(k1*j23) as residues of the INNER
        # plan's step-A basis (applied as its pre-table); the inner plan's
        # own twiddle then applies inside as usual.
        self.inner = make_ntt_plan_cached(
            spec, pow(root, n1, p), m, scale=scale, stepa_pre=True
        )
        qa = self.inner.basis_a.qs_host
        self.mid = jnp.asarray(
            _twiddle_mid_residues(root, n1, m, self.inner.n2, p, qa)
        )

    def _aux(self):
        return (self.n, self.n1, self.m)


def _twiddle_mid_residues(w, n1, m, inner_n2, p, qs) -> np.ndarray:
    """T[k1, j23] = w^(k1*j23) shaped for the inner step-A pre-table:
    (P+1, inner_nz1(=inner_n1 here), inner_n2) per k1 row, laid out as
    (P+1, n1, m) viewed later as (P+1, n1*inner_n1, inner_n2)."""
    flat = []
    wk1 = 1
    for _ in range(n1):
        v = 1
        row = []
        for _ in range(m):
            row.append(v)
            v = v * wk1 % p
        flat.extend(row)
        wk1 = wk1 * w % p
    by = crt.ints_to_bytes_np(flat)
    res = crt.residues_of_ints_np(by, qs)  # (P+1, n1*m)
    return np.ascontiguousarray(res.astype(_tw_dtype()))


def _plan3_flatten(pl: MxuNttPlan3):
    return (
        (pl.basis_a, pl.plan_a, pl.inner, pl.mid),
        (pl.n, pl.n1, pl.m),
    )


def _plan3_unflatten(aux, leaves):
    pl = object.__new__(MxuNttPlan3)
    pl.basis_a, pl.plan_a, pl.inner, pl.mid = leaves
    pl.n, pl.n1, pl.m = aux
    return pl


_jax.tree_util.register_pytree_node(MxuNttPlan3, _plan3_flatten, _plan3_unflatten)


def ntt_mxu3(plan: MxuNttPlan3, x):
    """Natural-order DFT for n > 2^20 via the three-level plan. The n1
    outer rows ride the B (batch) axis of the inner plan's two matmuls."""
    L = x.shape[0]
    n1 = plan.n1
    inner = plan.inner
    in1, in2 = inner.n1, inner.n2
    xv = x.reshape(L, n1, plan.m)
    a1 = crt.crt_matmul(plan.basis_a, plan.plan_a, xv)  # (L, n1, m)
    # inner step A across all n1 rows: contraction over j2 (= inner rows),
    # mid twiddle w^(k1*j23) folded in as the pre-table
    av = a1.reshape(L, n1, in1, in2)
    av = jnp.swapaxes(av, 1, 2).reshape(L, in1, n1 * in2)
    pre = plan.mid.astype(jnp.uint32).reshape(-1, n1, in1, in2)
    pre = jnp.swapaxes(pre, 1, 2).reshape(pre.shape[0], in1, n1 * in2)
    b1 = crt.crt_matmul(inner.basis_a, inner.plan_a, av, pre=pre)
    # b1: (L, in1out, n1*in2); inner step B: contraction over j3
    bv = b1.reshape(L, in1, n1, in2)
    bv = jnp.transpose(bv, (0, 3, 2, 1)).reshape(L, in2, n1 * in1)
    pre2 = inner.twiddle.astype(jnp.uint32)  # (P, in2, in1)
    pre2 = jnp.broadcast_to(
        pre2[:, :, None, :], (pre2.shape[0], in2, n1, in1)
    ).reshape(pre2.shape[0], in2, n1 * in1)
    out = crt.crt_matmul(inner.basis_b, inner.plan_b, bv, pre=pre2)
    # out: (L, in2out=k2', n1*in1) with trailing dims (k1, k1'); overall
    # flat k = k1 + n1*(k1' + in1*k2')
    ov = out.reshape(L, in2, n1, in1)
    ov = jnp.transpose(ov, (0, 1, 3, 2))  # (L, k2', k1', k1)
    return ov.reshape(L, plan.n)


def _plan_cache_path(spec, root, n, n1, n2, scale, nz1):
    import hashlib
    import os

    key = f"v1:{spec.p}:{root}:{n}:{n1}:{n2}:{scale}:{nz1}:{_tw_dtype().__name__}"
    h = hashlib.sha256(key.encode()).hexdigest()[:24]
    d = os.path.expanduser(
        os.environ.get("STARK_TPU_PLANS_CACHE", "~/.cache/stark_tpu_plans")
    )
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"ntt_{h}.npz")


def make_ntt_plan_cached(
    spec, root, n, n1=None, n2=None, scale=1, nz1=None, stepa_pre=False
):
    """MxuNttPlan with an on-disk table cache (host build is ~10-25s at
    2^20; the cached load is ~1s)."""
    import numpy as _np

    if n1 is None:
        logn = n.bit_length() - 1
        n1 = 1 << ((logn + 1) // 2)
        n2 = n // n1
    path = _plan_cache_path(spec, root, n, n1, n2, scale, (nz1, stepa_pre))
    try:
        data = _np.load(path)
    except Exception:
        data = None
    if data is not None:
        plan = object.__new__(MxuNttPlan)
        plan.n, plan.n1, plan.n2 = n, n1, n2
        plan.nz1 = nz1 if nz1 is not None else n1
        ba_bits, bb_bits = int(data["bits_a"]), int(data["bits_b"])
        plan.basis_a = crt.CrtBasis(spec, ba_bits)
        plan.basis_b = crt.CrtBasis(spec, bb_bits)
        pa = object.__new__(crt.CrtMatmulPlan)
        pa.W0 = jnp.asarray(data["aw0"]).astype(crt._DT)
        pa.W1 = jnp.asarray(data["aw1"]).astype(crt._DT)
        pa.kout, pa.k = n1, plan.nz1
        pb = object.__new__(crt.CrtMatmulPlan)
        pb.W0 = jnp.asarray(data["bw0"]).astype(crt._DT)
        pb.W1 = jnp.asarray(data["bw1"]).astype(crt._DT)
        pb.kout, pb.k = n2, n2
        plan.plan_a, plan.plan_b = pa, pb
        plan.twiddle = jnp.asarray(data["tw"])
        return plan
    plan = MxuNttPlan(
        spec, root, n, n1=n1, n2=n2, scale=scale, nz1=nz1, stepa_pre=stepa_pre
    )
    try:
        _np.savez(
            path,
            count=0,
            bits_a=plan.basis_a.bound_bits,
            bits_b=plan.basis_b.bound_bits,
            aw0=_np.asarray(plan.plan_a.W0.astype(jnp.float32)),
            aw1=_np.asarray(plan.plan_a.W1.astype(jnp.float32)),
            bw0=_np.asarray(plan.plan_b.W0.astype(jnp.float32)),
            bw1=_np.asarray(plan.plan_b.W1.astype(jnp.float32)),
            tw=_np.asarray(plan.twiddle),
        )
    except OSError as e:
        # best-effort plan cache: a read-only/full disk must not break the
        # prover, but anything else (shape/dtype bugs) should surface
        warnings.warn(f"mxu plan cache write failed: {e}")
    return plan


def make_lde_plans(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int):
    """(iNTT plan at g1^-1 with n^-1 scale, big NTT plan at g2 with
    zero-structure) mirroring `prove.rs:100-169`'s LDE pairs.

    precision <= 2^20 fits the two-level plan (both contractions <= 1024,
    the f32-exactness bound); above that the big transform gets the
    three-level `MxuNttPlan3` (outer n1 = precision/2^20 rides the batch
    axis; inner contractions stay 1024)."""
    p = spec.p
    inv_plan = make_ntt_plan_cached(
        spec, pow(spec.inv(g1), 1, p), steps, scale=spec.inv(steps)
    )
    logp = precision.bit_length() - 1
    if precision > 1 << 20:
        big_plan = MxuNttPlan3(spec, g2, precision, n1=precision >> 20)
        return inv_plan, big_plan
    n1 = 1 << ((logp + 1) // 2)
    n2 = precision // n1
    big_plan = make_ntt_plan_cached(
        spec, g2, precision, n1=n1, n2=n2, nz1=steps // n2
    )
    return inv_plan, big_plan


def lde_mxu(inv_plan: MxuNttPlan, big_plan, trace):
    """(L, steps) -> (L, precision) low-degree extension, all as matmuls.
    With a two-level big plan the zero-pad between the transforms is a pure
    reshape (natural-order coefficients ARE the nonzero rows of the padded
    (n1, n2) view); the three-level plan (precision > 2^20) takes the
    explicitly padded coefficient vector."""
    coeffs = ntt_mxu(inv_plan, trace)  # natural-order coefficients * n^-1
    if isinstance(big_plan, MxuNttPlan3):
        L = coeffs.shape[0]
        pad = big_plan.n - coeffs.shape[1]
        coeffs = jnp.concatenate(
            [coeffs, jnp.zeros((L, pad), jnp.uint32)], axis=1
        )
        return ntt_mxu3(big_plan, coeffs)
    return ntt_mxu(big_plan, coeffs)


@_jax.jit
def _lde_mxu_j(inv_plan, big_plan, trace):
    """Nested-jit wrapper: when traced inside an outer jit, the jaxpr cache
    keys on (plans-as-pytree avals, trace aval), so N same-shaped columns
    trace the CRT chain ONCE instead of N times (~30 s of host lowering at
    9 columns; cold-start cost)."""
    return lde_mxu(inv_plan, big_plan, trace)


def lde_mxu_many(inv_plan: MxuNttPlan, big_plan: MxuNttPlan, traces):
    """LDE a list of (L, steps) columns inside one traced computation (one
    dispatch; XLA schedules the columns sequentially, so peak memory stays
    at the single-column working set)."""
    return [_lde_mxu_j(inv_plan, big_plan, t) for t in traces]


def lde_mxu_sharded(mesh, inv_plan: MxuNttPlan, big_plan: MxuNttPlan, trace):
    """Mesh-sharded CRT LDE: the matmul batch axes are sharded over the
    mesh's "d" axis and the DFT matrices are replicated, so step A/B run
    locally per device; the only cross-device traffic is the all-to-all
    XLA inserts for the mid-pipeline (n1, n2) transpose -- the same
    communication shape as the classic four-step NTT over the mesh
    (SURVEY.md section 2.9 / `fft.rs:195-251`'s thread axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as Pp

    shard_cols = NamedSharding(mesh, Pp(None, "d"))

    def body(t):
        coeffs = ntt_mxu(inv_plan, t)
        coeffs = _jax.lax.with_sharding_constraint(
            coeffs, NamedSharding(mesh, Pp(None, "d"))
        )
        return ntt_mxu(big_plan, coeffs)

    fn = _jax.jit(
        body,
        in_shardings=shard_cols,
        out_shardings=NamedSharding(mesh, Pp(None, "d")),
    )
    return fn(trace)
