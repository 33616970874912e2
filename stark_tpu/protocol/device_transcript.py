"""Device-side Fiat-Shamir transcript (byte-exact with the host path).

The host transcript (`protocol/transcript.py`) forces a device->host
round trip at every challenge derivation, and the prover has ~30 of them
(a-tree seed, k coefficients, spot-check positions, two per FRI round),
each of which drains the device queue. This module
derives every challenge ON DEVICE from the (8,) uint32 digest words of
the committed roots, so the whole prover becomes an async dispatch chain
with a single materializing sync at the end.

Byte-exactness notes (asserted against the host path by
`tests/test_device_transcript.py` and by the oracle golden proofs):

* `get_pseudorandom_indices` (commitment/utils.rs:82-109) reads the
  blake chain as BIG-endian u32s; device digests are LE words, so each
  sampled word is byte-swapped.
* `mk_seed` -> `Fp::from_str` (r1cs-stark/utils.rs:51-57) renders the
  digest as a decimal string and re-parses it with field arithmetic --
  mathematically just "digest as BE integer, reduced mod p".
* `get_random_ff_values` (utils.rs:272-290) packs 8 BE u32s and reads
  the 32 bytes LITTLE-endian mod p.
* FRI's `special_x` (fri.rs:135) reads the root bytes LE mod p.

Montgomery embedding of a possibly >= p value X < 2^256 uses
mmul(X, R^2) = REDC(X*R^2) = X*R mod p, valid since X*R^2 < R*p.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec, int_to_limbs
from stark_tpu.ops import blake2s as b2
from stark_tpu.ops import modmath as mm

U32 = jnp.uint32


def bswap32(x):
    return (
        ((x & np.uint32(0xFF)) << np.uint32(24))
        | ((x & np.uint32(0xFF00)) << np.uint32(8))
        | ((x >> np.uint32(8)) & np.uint32(0xFF00))
        | (x >> np.uint32(24))
    )


def chain_words(seed_words8, count: int):
    """The sampler's blake chain: data = seed; while short, extend with
    blake(last 32 bytes). Returns the first `count` u32 data words
    (LE-word order, i.e. raw bytes)."""
    out = [seed_words8]
    have = 8
    state = seed_words8
    while have < count:
        state = b2.blake2s_words(_pad32(state), 32)[:, 0]
        out.append(state)
        have += 8
    return jnp.concatenate(out)[:count]


def _pad32(words8):
    """(8,) message words -> (16, 1) padded block."""
    return jnp.concatenate([words8, jnp.zeros(8, U32)]).reshape(16, 1)


def pseudorandom_indices(
    seed_words8, modulus: int, count: int, exclude_multiples_of: int = 0
):
    """Device `get_pseudorandom_indices`: (count,) uint32 indices."""
    assert modulus < 2**24
    data = chain_words(seed_words8, count)
    vals = bswap32(data)
    if exclude_multiples_of == 0:
        return vals % np.uint32(modulus)
    real_modulus = modulus * (exclude_multiples_of - 1) // exclude_multiples_of
    v = vals % np.uint32(real_modulus)
    return v + np.uint32(1) + v // np.uint32(exclude_multiples_of - 1)


def _le_bytes_to_mont(spec: FieldSpec, le_bytes32):
    """(32,) uint32 byte values (little-endian order) -> (L, 1) Montgomery
    of the value mod p."""
    L = spec.num_limbs
    limbs = jnp.stack(
        [le_bytes32[2 * j] + (le_bytes32[2 * j + 1] << np.uint32(8)) for j in range(L)]
    ).reshape(L, 1)
    r2 = jnp.asarray(
        np.array(int_to_limbs(spec.r2_mod_p, spec.num_limbs), np.uint32)
    ).reshape(L, 1)
    return mm.mmul(spec, limbs, r2)


def _words_to_le_bytes(words, order: str):
    """(W,) u32 words -> (4W,) byte values. order='le': word k holds bytes
    4k..4k+3 LE (device digests); order='be': BE within each word."""
    sh = [0, 8, 16, 24] if order == "le" else [24, 16, 8, 0]
    return jnp.stack(
        [(words >> np.uint32(s)) & np.uint32(0xFF) for s in sh], axis=1
    ).reshape(-1)


def digest_le_int_mont(spec: FieldSpec, digest_words8):
    """FRI special_x: digest bytes read LITTLE-endian, mod p, Montgomery."""
    return _le_bytes_to_mont(spec, _words_to_le_bytes(digest_words8, "le"))


def digest_be_int_mont(spec: FieldSpec, digest_words8):
    """mk_seed -> from_str: digest bytes read BIG-endian, mod p, Montgomery."""
    le = _words_to_le_bytes(digest_words8, "le")[::-1]  # reverse = BE int LE bytes
    return _le_bytes_to_mont(spec, le)


def random_ff_mont(
    spec: FieldSpec, seed_words8, modulus: int, size: int, exclude_multiples_of: int = 0
):
    """Device `get_random_ff_values`: (L, size) Montgomery values."""
    idx = pseudorandom_indices(seed_words8, modulus, size * 8, exclude_multiples_of)
    cols = []
    for c in range(size):
        chunk = idx[8 * c : 8 * c + 8]
        # pack as BE bytes then read the 32-byte string little-endian
        le_bytes = _words_to_le_bytes(chunk, "be")
        cols.append(_le_bytes_to_mont(spec, le_bytes))
    return jnp.concatenate(cols, axis=1)  # (L, size)


def k_coeffs_mont(spec: FieldSpec, m_root_words8):
    """k0..k10 (prove.rs:274-283): k0 = 1, k_i = from_str(mk_seed(
    m_root || i)) for one-byte big-endian i."""
    # ten 33-byte messages: m_root bytes || [i]
    msgs = []
    for i in range(1, 11):
        w = jnp.concatenate(
            [m_root_words8, jnp.asarray([i], U32), jnp.zeros(7, U32)]
        )
        msgs.append(w)
    block = jnp.stack(msgs, axis=1)  # (16, 10)
    digests = b2.blake2s_words(block, 33)  # (8, 10)
    cols = [mm.mont_consts(spec, [1])] + [
        digest_be_int_mont(spec, digests[:, i]) for i in range(10)
    ]
    return jnp.concatenate(cols, axis=1)  # (L, 11)
