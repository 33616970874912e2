"""Number-theoretic transform (radix-2) over limb fields, on device.

Replaces the reference's `serial_fft`/`parallel_fft`/`best_fft`
(`/root/reference/packages/fri/src/fft.rs:150-379`) with a batched device
NTT. Semantics are the standard DFT: X[k] = sum_j x[j] * w^(jk) with w the
given root of unity, matching the reference exactly (verified against its F7
known-answer tests).

Design notes (XLA):

* **No dynamic gathers in the butterflies.** Each stage views the
  array as `(L, m, 2, l)` by *reshape only* and combines the two middle-axis
  halves -- pure elementwise adds/muls with broadcast twiddles:

  - `_dif_core` (decimation in frequency flavor): natural order in,
    bit-reversed order out; stage twiddles are per-group `w^(rev(j)*l)`,
    gathered once per stage from the power table with *static* indices
    (total gathered elements over all stages = n-1).
  - `_dit_core`: bit-reversed order in, natural order out; stage twiddles
    are per-position `w^(k*m)` = a static strided slice of the table.

* **The LDE never materializes a bit reversal.** `lde` = DIF-iNTT on the
  trace (bitrev-ordered coefficients) -> scale by n^{-1} -> *interleaved*
  zero-pad (because rev_precision(j) = rev_steps(j) * blowup for j < steps,
  padding bitrev coefficients to the big domain is just inserting blowup-1
  zeros after every coefficient -- a reshape) -> DIT-NTT on the big domain.

* Twiddles come from a precomputed `(L, N/2)` power table of the root
  (`power_table`, log-depth doubling on device) -- no O(N) host loop like
  the reference's `expand_root_of_unity` (`fft.rs:5-14`).
* The iNTT multiplies by n^{-1} like `inv_best_fft` (`fft.rs:284-309`).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import modmath as mm


def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for _ in range(logn):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def forward_table(spec: FieldSpec, root: int, n: int):
    """(L, n/2) powers [1, w, ..., w^(n/2-1)] for an order-n NTT."""
    return mm.power_table(spec, root, max(n // 2, 1))


def inverse_table(spec: FieldSpec, root: int, n: int):
    """Same for w^{-1} (used by the iNTT)."""
    return mm.power_table(spec, spec.inv(root), max(n // 2, 1))


def _butterfly(spec: FieldSpec, a, tw, m: int, l: int):
    """One reshape-only stage: a viewed as (L, m, 2, l[, B]); returns the
    combined array in the same flat layout. tw broadcasts against x1."""
    L = a.shape[0]
    batched = a.ndim == 3
    shape = (L, m, 2, l, a.shape[2]) if batched else (L, m, 2, l)
    v = a.reshape(shape)
    x0 = v[:, :, 0]
    x1 = v[:, :, 1]
    prod = mm.mmul(spec, jnp.broadcast_to(tw, x1.shape), x1)
    y0 = mm.madd(spec, x0, prod)
    y1 = mm.msub(spec, x0, prod)
    out = jnp.stack([y0, y1], axis=2)
    return out.reshape(a.shape)


def _dif_core(spec: FieldSpec, a, w_half):
    """Natural-order input -> bit-reversed-order DFT. a: (L, n) or
    (L, n, B); w_half: (L, n/2) Montgomery powers of the root."""
    n = a.shape[1]
    logn = n.bit_length() - 1
    batched = a.ndim == 3
    l, m = n // 2, 1
    for _ in range(logn):
        # per-group twiddles w^(rev_m(j) * l), j in [m]: static-index gather
        if m == 1:
            idx = np.zeros(1, dtype=np.int32)
        else:
            idx = (_bitrev_perm(m).astype(np.int64) * l).astype(np.int32)
        tw = w_half[:, idx]  # (L, m)
        tw = tw[:, :, None, None] if batched else tw[:, :, None]
        a = _butterfly(spec, a, tw, m, l)
        l //= 2
        m *= 2
    return a


def _dit_core(spec: FieldSpec, a, w_half):
    """Bit-reversed-order input -> natural-order DFT. Twiddles are static
    strided slices (no gather at all)."""
    n = a.shape[1]
    logn = n.bit_length() - 1
    batched = a.ndim == 3
    l, m = 1, n // 2
    for _ in range(logn):
        # per-position twiddles w^(k * m), k in [l]: stride-m slice
        tw = w_half[:, :: m][:, :l] if l > 1 else w_half[:, :1]
        tw = tw[:, None, :, None] if batched else tw[:, None, :]
        a = _butterfly(spec, a, tw, m, l)
        l *= 2
        m //= 2
    return a


def _ntt_core(spec: FieldSpec, a, w_half):
    """Natural in -> natural out (compat shim for callers that need DFT
    order, e.g. the sharded four-step): DIF + one static bitrev gather."""
    n = a.shape[1]
    out = _dif_core(spec, a, w_half)
    return out[:, _bitrev_perm(n)]


# ---------------------------------------------------------------------------
# two-level (Cooley-Tukey n = n1*n2) plans: keeps every butterfly stage on a
# large trailing batch axis (long contiguous elementwise runs). Composition of
# bit-reversals is exact: rev_n(i*n2 + i2) = rev_n2(i2)*n1 + rev_n1(i), so
#   DIF(n) = DIF_axis1(n1, root w^n2) -> twiddle w^(rev_n1(i)*j2)
#            -> DIF_axis2(n2, root w^n1)
# yields the flat bitrev-ordered DFT with no inter-phase permutation, and the
# mirrored DIT pipeline consumes bitrev order and emits natural order. The
# axis-2 transform runs as transpose -> axis-1 core -> transpose (lane-axis
# mixing is confined to two XLA transposes per transform).
# ---------------------------------------------------------------------------

_SMALL_NTT = 1 << 9  # direct single-level core below this size


def _power_table_batched(spec: FieldSpec, bases, n: int):
    """bases (L, B) Montgomery -> (L, B, n) with T[:, b, j] = bases_b^j."""
    L, B = bases.shape
    table = jnp.broadcast_to(mm.mont_one(spec)[:, :, None], (L, B, 1))
    cur = bases[:, :, None]
    while table.shape[2] < n:
        table = jnp.concatenate(
            [table, mm.mmul(spec, table, jnp.broadcast_to(cur, table.shape))],
            axis=2,
        )
        cur = mm.mmul(spec, cur, cur)
    return table


class NttPlan:
    """Device twiddle tables for one (root, n, direction). direction "dif":
    natural -> bitrev; "dit": bitrev -> natural. Build once; registered as
    a jax pytree so plans pass through `jit` as runtime arguments (baking
    the multi-MB tables in as module constants blows up compile payloads).
    Small transforms run one direct core; larger ones the two-level
    pipeline."""

    def __init__(self, spec: FieldSpec, root: int, n: int, direction: str):
        assert direction in ("dif", "dit")
        assert n & (n - 1) == 0
        self.n = n
        self.direction = direction
        p = spec.p
        if n <= _SMALL_NTT:
            self.small = True
            self.w_half = mm.power_table(spec, root, max(n // 2, 1))
            return
        self.small = False
        logn = n.bit_length() - 1
        n1 = 1 << ((logn + 1) // 2)
        n2 = n // n1
        self.n1, self.n2 = n1, n2
        # axis-1 transform: order n1 at root w^n2; axis-2: order n2 at w^n1
        self.w_axis1 = mm.power_table(spec, pow(root, n2, p), n1 // 2)
        self.w_axis2 = mm.power_table(spec, pow(root, n1, p), n2 // 2)
        # mid twiddle T[i, j2] = w^(rev_n1(i) * j2): geometric rows
        base_full = mm.power_table(spec, root, n1)  # (L, n1) powers of w
        bases = base_full[:, _bitrev_perm(n1)]  # (L, n1): w^rev(i)
        self.mid_tw = _power_table_batched(spec, bases, n2)  # (L, n1, n2)


def _dif_fast(spec: FieldSpec, a, plan: NttPlan):
    """(L, n) natural -> (L, n) bitrev DFT via the two-level pipeline."""
    if plan.small:
        return _dif_core(spec, a, plan.w_half)
    L = a.shape[0]
    n1, n2 = plan.n1, plan.n2
    a3 = a.reshape(L, n1, n2)
    a3 = _dif_core(spec, a3, plan.w_axis1)  # over axis 1, batched on n2
    a3 = mm.mmul(spec, a3, plan.mid_tw)
    a3 = jnp.swapaxes(a3, 1, 2)  # (L, n2, n1)
    a3 = _dif_core(spec, a3, plan.w_axis2)  # over (former) axis 2
    a3 = jnp.swapaxes(a3, 1, 2)
    return a3.reshape(L, plan.n)


def _dit_fast(spec: FieldSpec, a, plan: NttPlan):
    """(L, n) bitrev -> (L, n) natural DFT (mirror of `_dif_fast`)."""
    if plan.small:
        return _dit_core(spec, a, plan.w_half)
    L = a.shape[0]
    n1, n2 = plan.n1, plan.n2
    a3 = a.reshape(L, n1, n2)
    a3 = jnp.swapaxes(a3, 1, 2)  # (L, n2, n1)
    a3 = _dit_core(spec, a3, plan.w_axis2)  # DFT over j2 (size n2)
    a3 = jnp.swapaxes(a3, 1, 2)  # (L, n1, n2): rows i, natural k2
    a3 = mm.mmul(spec, a3, plan.mid_tw)  # w^(rev_n1(i) * k2)
    a3 = _dit_core(spec, a3, plan.w_axis1)  # DFT over j1 -> natural k1
    return a3.reshape(L, plan.n)


def ntt(spec: FieldSpec, values, w_half):
    """DFT of (L, N) Montgomery values; N a power of two.

    Matches `best_fft` (`fft.rs:327-357`): callers pad inputs with zeros to
    the domain order before calling (see `lde`)."""
    n = values.shape[1]
    assert n & (n - 1) == 0
    if n == 1:
        return values
    assert w_half.shape[1] == n // 2
    return _ntt_core(spec, values, w_half)


def intt(spec: FieldSpec, values, w_inv_half):
    """Inverse DFT (evaluations -> coefficients), like `inv_best_fft`
    (`fft.rs:359-379`): forward NTT at w^{-1}, then scale by n^{-1}."""
    n = values.shape[1]
    out = ntt(spec, values, w_inv_half)
    n_inv = mm.mont_const(spec, spec.inv(n))
    return mm.mmul(spec, out, jnp.broadcast_to(n_inv, out.shape))


def zero_pad(values, n: int):
    """Pad (L, m) to (L, n) with zeros (coefficients of higher degrees)."""
    L, m = values.shape
    if m == n:
        return values
    return jnp.concatenate([values, jnp.zeros((L, n - m), values.dtype)], axis=1)


def _nttplan_flatten(p: "NttPlan"):
    if p.small:
        return (p.w_half,), ("small", p.n, p.direction)
    return (
        (p.w_axis1, p.w_axis2, p.mid_tw),
        ("two_level", p.n, p.direction, p.n1, p.n2),
    )


def _nttplan_unflatten(aux, children):
    p = object.__new__(NttPlan)
    kind = aux[0]
    p.n, p.direction = aux[1], aux[2]
    if kind == "small":
        p.small = True
        p.w_half = children[0]
        return p
    p.small = False
    p.w_axis1, p.w_axis2, p.mid_tw = children
    p.n1, p.n2 = aux[3], aux[4]
    return p


import jax as _jax  # noqa: E402

_jax.tree_util.register_pytree_node(NttPlan, _nttplan_flatten, _nttplan_unflatten)


class LdePlan:
    """Twiddle plans for one (g1, g2, steps, precision) LDE shape."""

    def __init__(self, spec: FieldSpec, g1: int, g2: int, steps: int, precision: int):
        self.steps = steps
        self.precision = precision
        self.small_dif = NttPlan(spec, spec.inv(g1), steps, "dif")
        self.big_dit = NttPlan(spec, g2, precision, "dit")
        self.n_inv = mm.mont_const(spec, spec.inv(steps))


def _ldeplan_flatten(p: LdePlan):
    return (p.small_dif, p.big_dit, p.n_inv), (p.steps, p.precision)


def _ldeplan_unflatten(aux, children):
    p = object.__new__(LdePlan)
    p.steps, p.precision = aux
    p.small_dif, p.big_dit, p.n_inv = children
    return p


_jax.tree_util.register_pytree_node(LdePlan, _ldeplan_flatten, _ldeplan_unflatten)


def make_lde_plan(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int):
    return LdePlan(spec, g1, g2, steps, precision)


def use_mxu_lde(steps: int, precision: int) -> bool:
    """Route LDEs to the CRT matmul engine (ops/mxu_ntt)?

    Off by default: the butterfly engine is the one path measured on the
    GPU. STARK_TPU_MXU=1 enables the matmul engine for steps >= 2^12;
    =force drops the size floor (tests)."""
    env = os.environ.get("STARK_TPU_MXU", "0")
    if precision > 1 << 24:
        return False  # three-level twiddle tables outgrow device memory
    if env == "force":
        return True
    return env == "1" and steps >= 1 << 12


def make_best_lde(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int):
    """Returns (lde_fn, plans...) with the backend chosen by `use_mxu_lde`:
    lde_fn(trace (L, steps)) -> (L, precision), jit-compatible."""
    if use_mxu_lde(steps, precision):
        from stark_tpu.ops import mxu_ntt

        inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision)
        import jax

        base = jax.jit(lambda t, ip, bp: mxu_ntt.lde_mxu(ip, bp, t))
        return lambda t: base(t, inv_plan, big_plan)
    plan = make_lde_plan(spec, g1, g2, steps, precision)
    import jax

    base = jax.jit(lambda t, pl: lde(spec, t, pl))
    return lambda t: base(t, plan)


def lde(spec: FieldSpec, trace, plan: LdePlan):
    """Low-degree extension: interpolate (L, steps) trace on the g1 domain,
    re-evaluate on the g2 domain of size `precision`.

    Mirrors the prover's `inv_best_fft(g1)` / `best_fft(g2)` pairs
    (`prove.rs:100-169`), fused so no bit-reversal is materialized:
    bitrev_precision(j) = bitrev_steps(j) * blowup for j < steps, so the
    bitrev-ordered small coefficients interleave-pad straight into the
    bitrev-ordered big coefficient vector."""
    L, steps = trace.shape
    precision = plan.precision
    assert steps == plan.steps and precision % steps == 0
    ratio = precision // steps
    if steps == 1:
        coeffs_rev = trace
    else:
        coeffs_rev = _dif_fast(spec, trace, plan.small_dif)
    n_inv_b = jnp.broadcast_to(plan.n_inv, coeffs_rev.shape)
    coeffs_rev = mm.mmul(spec, coeffs_rev, n_inv_b)
    if ratio == 1:
        padded = coeffs_rev
    else:
        # interleaved zero-pad as a concat (scatter-free)
        padded = jnp.concatenate(
            [
                coeffs_rev[:, :, None],
                jnp.zeros((L, steps, ratio - 1), coeffs_rev.dtype),
            ],
            axis=2,
        ).reshape(L, precision)
    return _dit_fast(spec, padded, plan.big_dit)
