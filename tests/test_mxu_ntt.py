"""MXU four-step NTT vs the established NTT/LDE paths (CPU, small sizes)."""

import numpy as np
import jax.numpy as jnp
import pytest

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as mm
from stark_tpu.ops import mxu_ntt
from stark_tpu.ops import ntt as nttm

P = spec.p


def rand_mont(rng, n):
    vals = [int(rng.integers(0, 1 << 62)) ** 5 % P for _ in range(n)]
    return vals, mm.to_mont(spec, mm.ints_to_limbs_np(vals, spec))


def from_mont_ints(x):
    lim = np.asarray(mm.from_mont(spec, x))
    return [
        sum(int(lim[i, t]) << (16 * i) for i in range(lim.shape[0]))
        for t in range(lim.shape[1])
    ]


def test_ntt_mxu_matches_reference_dft():
    rng = np.random.default_rng(0)
    n = 64
    root = spec.root_of_unity(n)
    vals, x = rand_mont(rng, n)
    plan = mxu_ntt.MxuNttPlan(spec, root, n)
    out = from_mont_ints(mxu_ntt.ntt_mxu(plan, x))
    w_half = nttm.forward_table(spec, root, n)
    want = from_mont_ints(nttm.ntt(spec, x, w_half))
    assert out == want


def test_ntt_mxu_uneven_split():
    rng = np.random.default_rng(1)
    n = 128  # n1=16, n2=8
    root = spec.root_of_unity(n)
    vals, x = rand_mont(rng, n)
    plan = mxu_ntt.MxuNttPlan(spec, root, n, n1=16, n2=8)
    out = from_mont_ints(mxu_ntt.ntt_mxu(plan, x))
    w_half = nttm.forward_table(spec, root, n)
    want = from_mont_ints(nttm.ntt(spec, x, w_half))
    assert out == want


def test_lde_mxu_matches_lde():
    rng = np.random.default_rng(2)
    steps, precision = 64, 512
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, P)
    vals, tr = rand_mont(rng, steps)
    inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision)
    out = from_mont_ints(mxu_ntt.lde_mxu(inv_plan, big_plan, tr))
    ref_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)
    want = from_mont_ints(nttm.lde(spec, tr, ref_plan))
    assert out == want


def test_ntt_mxu3_three_level():
    """Three-level plan (outer matmul + mid twiddle + batched inner
    four-step) matches the reference DFT."""
    rng = np.random.default_rng(4)
    n = 1 << 12  # n1=4, inner 1024 = 32x32
    root = spec.root_of_unity(n)
    vals, x = rand_mont(rng, n)
    plan = mxu_ntt.MxuNttPlan3(spec, root, n, n1=4)
    out = from_mont_ints(mxu_ntt.ntt_mxu3(plan, x))
    w_half = nttm.forward_table(spec, root, n)
    want = from_mont_ints(nttm.ntt(spec, x, w_half))
    assert out == want


def test_lde_mxu_matches_lde_mid_scale():
    """2^11 -> 2^14 LDE equality (bigger shapes exercise the lane-blocked
    wide dots and multi-fold chains that tiny tests miss)."""
    rng = np.random.default_rng(5)
    steps, precision = 1 << 11, 1 << 14
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, 8, P)
    vals, tr = rand_mont(rng, steps)
    inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision)
    out = from_mont_ints(mxu_ntt.lde_mxu(inv_plan, big_plan, tr))
    ref_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)
    want = from_mont_ints(nttm.lde(spec, tr, ref_plan))
    assert out == want


def test_lde_mxu3_matches_lde():
    """LDE through the three-level big plan (the precision > 2^20 route,
    built here at a small size) matches the butterfly LDE."""
    rng = np.random.default_rng(6)
    steps, precision = 1 << 9, 1 << 12
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, P)
    inv_plan = mxu_ntt.make_ntt_plan_cached(
        spec, pow(spec.inv(g1), 1, P), steps, scale=spec.inv(steps)
    )
    big3 = mxu_ntt.MxuNttPlan3(spec, g2, precision, n1=4)
    vals, tr = rand_mont(rng, steps)
    out = from_mont_ints(mxu_ntt.lde_mxu(inv_plan, big3, tr))
    ref_plan = nttm.make_lde_plan(spec, g1, g2, steps, precision)
    want = from_mont_ints(nttm.lde(spec, tr, ref_plan))
    assert out == want
