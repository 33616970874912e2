"""Batched Blake2s-256 on device (pure uint32 elementwise ops).

The reference hashes every Merkle leaf/node serially with the `blake2` crate
(`/root/reference/packages/commitment/src/utils.rs:5-10`, `blake.rs:28-32`);
here whole layers are hashed at once, vectorized over N messages.

Kernel structure (XLA-friendly):
* state as a (4, 4, N) "rows" tensor so each G step processes all four
  column (or diagonal) mixes at once -- the classic SIMD formulation;
* the 10 rounds run in a `lax.fori_loop` with the SIGMA schedule as a device
  constant, keeping the compiled graph ~2 G bodies instead of 80.

Standard unkeyed Blake2s-256 parameters (h[0] ^= 0x01010020), identical to
python's `hashlib.blake2s` and pinned by the reference's KATs
(`utils.rs:12-24`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

_IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

_SIGMA = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
        [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
        [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
        [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
        [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
        [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
        [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
        [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
        [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    ],
    dtype=np.int32,
)


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g(a, b, c, d, x, y):
    a = a + b + x
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 12)
    a = a + b + y
    d = _rotr(d ^ a, 8)
    c = c + d
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(h, m, t: int, last: bool):
    """h: (8, N) uint32 state; m: (16, N) uint32 message words."""
    n = h.shape[1]
    iv = jnp.broadcast_to(jnp.asarray(_IV, U32)[:, None], (8, n))
    v = jnp.concatenate([h, iv], axis=0)
    v = v.at[12].set(v[12] ^ np.uint32(t & 0xFFFFFFFF))
    v = v.at[13].set(v[13] ^ np.uint32((t >> 32) & 0xFFFFFFFF))
    if last:
        v = v.at[14].set(v[14] ^ np.uint32(0xFFFFFFFF))
    rows = v.reshape(4, 4, n)
    sigma = jnp.asarray(_SIGMA)

    def round_body(r, rows):
        s = sigma[r]
        a, b, c, d = rows[0], rows[1], rows[2], rows[3]
        # column step: G on (v0,v4,v8,v12)..(v3,v7,v11,v15), lanes = columns
        x = m[s[0:8:2]]
        y = m[s[1:8:2]]
        a, b, c, d = _g(a, b, c, d, x, y)
        # diagonal step: rotate rows so diagonals align into columns
        b = jnp.roll(b, -1, axis=0)
        c = jnp.roll(c, -2, axis=0)
        d = jnp.roll(d, -3, axis=0)
        x = m[s[8:16:2]]
        y = m[s[9:16:2]]
        a, b, c, d = _g(a, b, c, d, x, y)
        b = jnp.roll(b, 1, axis=0)
        c = jnp.roll(c, 2, axis=0)
        d = jnp.roll(d, 3, axis=0)
        return jnp.stack([a, b, c, d])

    rows = jax.lax.fori_loop(0, 10, round_body, rows)
    v = rows.reshape(16, n)
    return h ^ v[:8] ^ v[8:]


@functools.partial(jax.jit, static_argnums=1)
def blake2s_words(msgs, msg_len: int):
    """Hash N equal-length messages.

    msgs: (W, N) uint32 little-endian message words, W = ceil(msg_len/4)
    rounded up to a multiple of 16 (callers zero-pad). Returns (8, N) uint32
    digest words (LE byte order within each word).
    """
    W, n = msgs.shape
    nblocks = max(1, (msg_len + 63) // 64)
    assert W == nblocks * 16, (W, msg_len)
    h = jnp.broadcast_to(jnp.asarray(_IV, U32)[:, None], (8, n))
    h = h.at[0].set(h[0] ^ np.uint32(0x01010020))  # depth=1, fanout=1, len=32
    for blk in range(nblocks):
        last = blk == nblocks - 1
        t = msg_len if last else (blk + 1) * 64
        h = _compress(h, msgs[blk * 16 : blk * 16 + 16], t, last)
    return h


def digest_words_to_bytes_np(words) -> np.ndarray:
    """(8, N) uint32 digest words -> (N, 32) uint8."""
    w = np.asarray(words).astype("<u4").T.copy()  # (N, 8) little-endian
    return w.view(np.uint8).reshape(w.shape[0], 32)


def bytes_to_words_np(data: np.ndarray, msg_len: int) -> np.ndarray:
    """(N, msg_len) uint8 -> (W, N) uint32 words, zero-padded to blocks."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    nblocks = max(1, (msg_len + 63) // 64)
    buf = np.zeros((n, nblocks * 64), dtype=np.uint8)
    buf[:, :msg_len] = data
    return np.ascontiguousarray(buf.view("<u4").T)
