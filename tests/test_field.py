"""Field codec KATs (pinned to the reference's `fp.rs`/`f7.rs` tests) and
property tests of the device limb arithmetic against python ints."""

import random

import numpy as np
import pytest

from stark_tpu.fields.field import BLS12_381_FR, BN254_FR, F7
from stark_tpu.ops import modmath as mm

pytestmark = pytest.mark.quick


def test_fp_to_hex():
    # fp.rs:27-33
    assert BN254_FR.encode_hex(31) == format(31, "064x")


def test_fp_to_bytes():
    # fp.rs:46-68
    assert BN254_FR.to_bytes_be(31) == bytes([0] * 31 + [31])
    assert BN254_FR.to_bytes_le(31) == bytes([31] + [0] * 31)
    assert len(BN254_FR.to_bytes_be(31)) == 32


def test_f7_to_bytes():
    # f7.rs:45-55
    assert F7.to_bytes_be(1) == bytes([0] * 7 + [1])
    assert F7.to_bytes_le(1) == bytes([1] + [0] * 7)


def test_from_bytes_reduces_mod_p():
    # from_bytes goes through a decimal walk in the field, so values >= p
    # wrap (fp.rs:70-77)
    big = BN254_FR.p + 123
    assert BN254_FR.from_bytes_le(big.to_bytes(33, "little")) == 123
    assert BN254_FR.from_bytes_be(big.to_bytes(33, "big")) == 123
    # variable-width inputs (witness reader emits minimal-length bytes)
    assert BN254_FR.from_bytes_le(bytes([17])) == 17


def test_two_adicity():
    # max_precision = 2^28 for BN254 Fr (r1cs-stark/src/utils.rs:138-162)
    assert BN254_FR.two_adicity == 28
    assert F7.two_adicity == 1
    assert BLS12_381_FR.two_adicity == 32


@pytest.mark.parametrize("spec", [BN254_FR, F7], ids=lambda s: s.name)
def test_device_arithmetic_matches_python(spec):
    rng = random.Random(1234)
    n = 64
    xs = [rng.randrange(spec.p) for _ in range(n)]
    ys = [rng.randrange(spec.p) for _ in range(n)]
    xm = mm.to_mont(spec, mm.ints_to_limbs_np(xs, spec))
    ym = mm.to_mont(spec, mm.ints_to_limbs_np(ys, spec))

    def dec(arr):
        return mm.limbs_to_ints_np(mm.from_mont(spec, arr), spec)

    assert dec(mm.madd(spec, xm, ym)) == [(a + b) % spec.p for a, b in zip(xs, ys)]
    assert dec(mm.msub(spec, xm, ym)) == [(a - b) % spec.p for a, b in zip(xs, ys)]
    assert dec(mm.mmul(spec, xm, ym)) == [(a * b) % spec.p for a, b in zip(xs, ys)]


@pytest.mark.parametrize("spec", [BN254_FR, F7], ids=lambda s: s.name)
def test_device_edge_cases(spec):
    es = [0, 1, spec.p - 1, spec.p - 1, 0, 1, 2, 3]
    em = mm.to_mont(spec, mm.ints_to_limbs_np(es, spec))
    ones = mm.to_mont(spec, mm.ints_to_limbs_np([1] * len(es), spec))

    def dec(arr):
        return mm.limbs_to_ints_np(mm.from_mont(spec, arr), spec)

    assert dec(mm.mmul(spec, em, em)) == [a * a % spec.p for a in es]
    assert dec(mm.madd(spec, em, em)) == [2 * a % spec.p for a in es]
    assert dec(mm.msub(spec, em, ones)) == [(a - 1) % spec.p for a in es]


def test_minv_and_multi_inv():
    spec = BN254_FR
    rng = random.Random(7)
    xs = [rng.randrange(spec.p) for _ in range(32)]
    xs[3] = 0
    xs[20] = 0
    xm = mm.to_mont(spec, mm.ints_to_limbs_np(xs, spec))
    expect = [0 if a == 0 else pow(a, spec.p - 2, spec.p) for a in xs]

    def dec(arr):
        return mm.limbs_to_ints_np(mm.from_mont(spec, arr), spec)

    assert dec(mm.minv(spec, xm)) == expect
    assert dec(mm.multi_inv(spec, xm)) == expect


def test_multi_inv_matches_reference_kat():
    # fri/src/poly_utils.rs:72-91 (F7 known answers)
    vals = [1, 3, 2, 6, 4, 5, 0, 0]  # padded to a power of two
    vm = mm.to_mont(F7, mm.ints_to_limbs_np(vals, F7))
    out = mm.limbs_to_ints_np(mm.from_mont(F7, mm.multi_inv(F7, vm)), F7)
    assert out == [1, 5, 4, 6, 2, 3, 0, 0]


def test_prefix_prod():
    spec = BN254_FR
    rng = random.Random(5)
    xs = [rng.randrange(spec.p) for _ in range(128)]
    xm = mm.to_mont(spec, mm.ints_to_limbs_np(xs, spec))
    fwd = mm.limbs_to_ints_np(mm.from_mont(spec, mm.prefix_prod(spec, xm)), spec)
    acc, exp = 1, []
    for a in xs:
        acc = acc * a % spec.p
        exp.append(acc)
    assert fwd == exp


def test_power_table():
    for spec in (BN254_FR, F7):
        g = spec.generator
        pt = mm.limbs_to_ints_np(
            mm.from_mont(spec, mm.power_table(spec, g, 32)), spec
        )
        assert pt == [pow(g, k, spec.p) for k in range(32)]


def test_bytes_roundtrip_np():
    spec = BN254_FR
    rng = random.Random(9)
    xs = [rng.randrange(spec.p) for _ in range(16)]
    raw = np.stack(
        [np.frombuffer(spec.to_bytes_le(x), dtype=np.uint8) for x in xs]
    )
    limbs = mm.bytes_le_to_limbs_np(raw, spec)
    assert mm.limbs_to_ints_np(limbs, spec) == xs
    back = mm.limbs_to_bytes_le_np(limbs, spec)
    assert np.array_equal(back, raw)
