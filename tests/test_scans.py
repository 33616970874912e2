"""Prefix products and batched inversion against sequential Python ints,
in both directions, at sizes that span several levels of the scan."""

import numpy as np
import jax.numpy as jnp
import pytest

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as mm

P = spec.p
R = spec.r_mod_p
R_INV = pow(R, -1, P)


def _rand_mont(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    a[15] = rng.integers(0, 0x3000, size=n, dtype=np.uint32)  # < p
    return a


def _ints(arr):
    return mm.limbs_to_ints_np(np.asarray(arr), spec)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("n", [256, 2048])
def test_prefix_prod_matches_sequential(n, reverse):
    v = _rand_mont(n, n + reverse)
    vals = _ints(v)
    order = range(n - 1, -1, -1) if reverse else range(n)
    want, acc = [0] * n, R  # Montgomery one
    for i in order:
        acc = acc * vals[i] % P * R_INV % P
        want[i] = acc
    assert _ints(mm.prefix_prod(spec, jnp.asarray(v), reverse)) == want


@pytest.mark.parametrize("n", [256, 2048])
def test_multi_inv_matches_sequential(n):
    v = _rand_mont(n, 7 * n)
    v[:, [0, n // 3, n - 1]] = 0  # zeros map to zero, like the reference
    vals = _ints(v)
    got = _ints(mm.multi_inv(spec, jnp.asarray(v)))
    r2 = R * R % P  # inv(x)_mont * x_mont = (x^-1 R)(x R)
    for x, y in zip(vals, got):
        assert (y == 0) if x == 0 else (x * y % P == r2)
