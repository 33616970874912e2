"""CRT modular linear algebra: ``(W @ x) mod p`` as float matmuls.

Every big *linear* op in the prover (the four-step NTT's DFT steps,
multi-point evaluation) is a matmul against a constant mod-p matrix. This
module maps that arithmetic onto matrix products of small integers:

1. **Reduce-in** — 16-bit limb planes are split into byte planes and reduced
   modulo a set of ~14-bit pairwise-coprime primes ``q_i`` with ONE
   matmul against the (P, 32) matrix of ``256^l mod q_i`` digit rows, plus a
   short per-prime fold chain (``2^14 = delta_i (mod q_i)``).
2. **Main matmul** — per prime, the constant matrix's residues are split
   into two balanced 7-bit digit planes and the data residues into two
   unsigned 7-bit planes; four prime-batched f32 matmuls compute the exact
   integer chunk products (all sums < 2^24, so f32 accumulation is exact).
   Every dot runs at ``Precision.HIGHEST``: a reduced-precision float
   matmul (TF32 on tensor cores) would round the 7-bit digit products.
3. **Recombine** — chunk sums are recombined mod ``q_i``.
4. **Reconstruct** — the wrap count ``k`` of the CRT sum is recovered
   exactly through a redundant modulus lane; the mod-p value is assembled by
   a digit matmul against ``(M/q_i) mod p``, and the final division by
   ``R = 2^256`` runs as Montgomery REDC whose two big products are banded
   byte matmuls (base-256 digits align with R). One conditional subtract
   yields canonical limbs.

Montgomery-compatibility: constant matrices are pre-scaled by ``R mod p`` so
the REDC's ``R^{-1}`` cancels — Montgomery-form inputs produce
Montgomery-form outputs.

Replaces the compute path of the reference's FFT butterflies
(`/root/reference/packages/fri/src/fft.rs:150-251`) for large transforms;
the number theory is validated against plain python bigints in
``tests/test_crt.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec

_DT = jnp.float32  # matmul operand type; every digit is exact in it
_HIGHEST = jax.lax.Precision.HIGHEST
QBITS = 14
QBASE = 1 << QBITS
CHUNK = 7  # residue chunk bits for the main matmuls
R256 = 1 << 256
ND = 35  # base-256 digits in the reconstruction sum (bound < 2^(8*35))


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def select_primes(bound_bits: int, qmax: int = 16128):
    """Descending primes <= qmax whose product exceeds 2^bound_bits, plus
    one extra as the redundant reconstruction lane (last entry)."""
    qs, bits, q = [], 0.0, qmax
    while bits <= bound_bits:
        if _is_prime(q):
            qs.append(q)
            bits += np.log2(q)
        q -= 1
    while not _is_prime(q):
        q -= 1
    qs.append(q)  # redundant lane
    return qs


def _balanced_digits(v: int, base: int, n: int):
    out = []
    for _ in range(n):
        d = v % base
        if d >= base // 2:
            d -= base
        out.append(d)
        v = (v - d) // base
    assert v == 0, "digit overflow in balanced recoding"
    return out


def _fold_count(bound_bits: int, dmax_bits: int = 10) -> int:
    """Folds of x -> (x>>14)*delta + (x & (2^14-1)) to get below 2^16.

    The two conditional subtracts after the fold chain can only
    canonicalize values below ~3q, so a chain that fails to converge must
    fail loudly here (at basis-construction time), not produce silently
    wrong residues downstream."""
    b, c = bound_bits, 0
    while b >= 16:
        nb = max(b - QBITS + dmax_bits, QBITS) + 1
        if nb >= b:
            raise ValueError(
                f"CRT fold chain does not converge: bound 2^{bound_bits} "
                f"stuck at 2^{b} after {c} folds (dmax_bits={dmax_bits})"
            )
        b, c = nb, c + 1
    return c


# Byte-plane order in `reduce_in` is [lo0..lo15, hi0..hi15]; the C matrix
# rows are for bytes [b0 of limb0, b1 of limb0, ...] = interleaved. This
# permutation maps between them; it is instance-independent.
_BYTE_PERM = np.concatenate([np.arange(0, 32, 2), np.arange(1, 32, 2)])


class CrtBasis:
    """CRT basis for one (field, magnitude-bound) pair. Registered pytree."""

    def __init__(self, spec: FieldSpec, bound_bits: int):
        p = spec.p
        qs_all = select_primes(bound_bits)
        self.p = p
        self.bound_bits = bound_bits
        self.P = len(qs_all) - 1
        self.qr = qs_all[-1]
        qs = qs_all[:-1]
        self.qs_host = qs_all
        M = 1
        for q in qs:
            M *= q
        assert M > 1 << bound_bits
        self.M = M
        t = [pow(M // q, -1, q) for q in qs]
        self.t_host = t
        gp = [(M // q) % p for q in qs]
        grr = [(M // q) % self.qr for q in qs]
        self.minv_qr = pow(M % self.qr, -1, self.qr)
        self.delta_r = QBASE - self.qr

        qa = np.array(qs_all, np.int32)[:, None]
        self.qs = jnp.asarray(qa)
        self.deltas = jnp.asarray(QBASE - qa)
        self.dmax_bits = int(np.ceil(np.log2(max(1, int((QBASE - qa).max())))))

        # reduce-in rows: balanced 7-bit digit pair of (256^l mod q)
        C = np.array(
            [[pow(256, l, q) for l in range(32)] for q in qs_all], np.int64
        )
        Cb = np.where(C > qa // 2, C - qa, C)
        c0 = ((Cb + 64) % 128) - 64
        c1 = (Cb - c0) >> 7
        assert np.abs(c1).max() < 64
        self.C0 = jnp.asarray(c0.astype(np.float32))
        self.C1 = jnp.asarray(c1.astype(np.float32))

        # reconstruction: G rows = balanced base-256 digits of gp_i;
        # two extra rows = balanced 7-bit digit pair of grr_i (for k)
        G = np.zeros((ND + 2, self.P), np.int64)
        for i, g in enumerate(gp):
            G[:ND, i] = _balanced_digits(g, 256, ND)
        grr_b = [x - self.qr if x > self.qr // 2 else x for x in grr]
        for i, g in enumerate(grr_b):
            d0 = ((g + 64) % 128) - 64
            G[ND, i] = d0
            G[ND + 1, i] = (g - d0) >> 7
        assert np.abs(G[ND + 1]).max() < 64
        self.G = jnp.asarray(G.astype(np.float32))
        negM = (-M) % p
        self.negM_dig = jnp.asarray(
            np.array(_balanced_digits(negM, 256, ND), np.float32)[:, None]
        )

        # REDC bands: N' = -p^-1 mod R, p; balanced base-256 digits
        npi = (-pow(p, -1, R256)) % R256
        nd = _balanced_digits(npi, 256, 33)[:32]  # mod R: low 32 digits
        pd = _balanced_digits(p, 256, 33)
        NB = np.zeros((32, 32), np.int64)
        for c in range(32):
            for a in range(c + 1):
                NB[c, a] = nd[c - a]
        PB = np.zeros((65, 32), np.int64)
        for c in range(65):
            for a in range(32):
                if 0 <= c - a < 33:
                    PB[c, a] = pd[c - a]
        self.NB = jnp.asarray(NB.astype(np.float32))
        self.PB = jnp.asarray(PB.astype(np.float32))
        self.p_limbs16 = tuple((p >> (16 * i)) & 0xFFFF for i in range(16))

    # -- residue helpers ---------------------------------------------------

    def fold(self, v_u32, bound_bits: int):
        """v (Pp1, N) u32 in [0, 2^bound_bits) -> [0, q). Per-prime fold
        chain + two conditional subtracts."""
        x = v_u32
        d = self.deltas.astype(jnp.uint32)
        q = self.qs.astype(jnp.uint32)
        for _ in range(_fold_count(bound_bits, self.dmax_bits)):
            x = (x >> QBITS) * d + (x & (QBASE - 1))
        for _ in range(2):
            x = jnp.where(x >= q, x - q, x)
        return x

    def fold_signed(self, v_i32, bound_bits: int):
        """Signed variant: add a multiple of q first (u32 arithmetic; the
        true sum lands in [0, 2^32) so mod-2^32 wraparound is exact).
        |v| < 2^bound_bits, bound_bits <= 31."""
        shift = bound_bits - QBITS + 1
        off_q = self.qs.astype(jnp.uint32) << shift  # 2^shift * q >= 2^bound
        x = v_i32.astype(jnp.uint32) + off_q
        return self.fold(x, min(bound_bits + 2, 32))

    def reduce_in(self, limbs):
        """(L, N) u32 16-bit limb planes -> (P+1, N) u32 residues."""
        b0 = (limbs & 0xFF).astype(_DT)
        b1 = (limbs >> 8).astype(_DT)
        by = jnp.concatenate([b0, b1], axis=0)  # byte order: lo limbs, hi
        D0 = _dot(self.C0_perm(), by)
        D1 = _dot(self.C1_perm(), by)
        raw = D0.astype(jnp.int32) + (D1.astype(jnp.int32) << 7)
        return self.fold_signed(raw, 27)

    def C0_perm(self):
        return self.C0[:, _BYTE_PERM]

    def C1_perm(self):
        return self.C1[:, _BYTE_PERM]

    def chunk(self, r_u32):
        """Residues [0, q) -> two unsigned 7-bit float planes (exact)."""
        c0 = (r_u32 & 127).astype(_DT)
        c1 = (r_u32 >> 7).astype(_DT)
        return c0, c1

    def reconstruct(self, s_u32):
        """(P+1, N) residues of X (< M; last row plain mod q_r) ->
        (16, N) u32 canonical limbs of X * R^-1 mod p."""
        return _reconstruct_math(
            self._consts(), self.G, self.negM_dig, self.NB, self.PB, s_u32
        )

    def _consts(self):
        return (
            self.P, self.qr, self.delta_r, self.minv_qr, self.dmax_bits,
            self.p_limbs16,
        )


def _fold_r_free(x_u32, bound_bits, qr_i, delta_r_i, dmax_bits):
    dr = np.uint32(delta_r_i)
    qr = np.uint32(qr_i)
    b = bound_bits
    while b >= 16:
        x_u32 = (x_u32 >> QBITS) * dr + (x_u32 & (QBASE - 1))
        b = max(b - QBITS + dmax_bits, QBITS) + 1
    for _ in range(2):
        x_u32 = jnp.where(x_u32 >= qr, x_u32 - qr, x_u32)
    return x_u32


def _reconstruct_math(consts, G, negM_dig, NB, PB, s_u32):
    """Reconstruction body. s_u32: (P+1, T); returns (16, T) canonical
    limbs of X*R^-1 mod p."""
    P, qr_i, delta_r_i, minv_qr_i, dmax_bits, p_limbs16 = consts

    def to_dt(x):
        return x.astype(jnp.int32).astype(_DT)  # exact: digits < 2^8

    s0 = to_dt(s_u32 & 127)
    s1 = to_dt(s_u32 >> 7)
    D0 = _dot(G, s0[:P])  # (ND+2, T) f32, exact
    D1 = _dot(G, s1[:P])
    # wrap count k via the redundant lane
    g0s0 = D0[ND].astype(jnp.int32)
    g1s0 = D0[ND + 1].astype(jnp.int32)
    g0s1 = D1[ND].astype(jnp.int32)
    g1s1 = D1[ND + 1].astype(jnp.int32)
    ssum = g0s0 + ((g1s0 + g0s1) << 7) + delta_r_i * g1s1
    kr = ssum - s_u32[P].astype(jnp.int32)
    kraw = (kr + (1 << 16) * qr_i).astype(jnp.uint32)
    kred = _fold_r_free(kraw, 31, qr_i, delta_r_i, dmax_bits)
    k = _fold_r_free(
        kred * np.uint32(minv_qr_i), 28, qr_i, delta_r_i, dmax_bits
    )
    # digit sum: cols = G@s0 + 128*(G@s1) + k*digits(-M mod p)
    Dk = negM_dig.astype(jnp.int32) * k.astype(jnp.int32)[None, :]
    cols = (
        D0[:ND].astype(jnp.int32) + (D1[:ND].astype(jnp.int32) << 7) + Dk
    )
    y = _carry_digits(cols, ND + 1)  # (ND+1, T) bytes of Y >= 0
    # REDC: m = (Y mod R)*N' mod R; u = (Y + m*p) / R
    m_cols = _dot(NB, to_dt(y[:32])).astype(jnp.int32)
    m = _carry_digits(m_cols, 32, trunc=True)
    u_pb = _dot(PB, to_dt(m)).astype(jnp.int32)
    y_pad = jnp.concatenate(
        [
            y.astype(jnp.int32),
            jnp.zeros((u_pb.shape[0] - (ND + 1), y.shape[1]), jnp.int32),
        ],
        axis=0,
    )
    u = _carry_digits(u_pb + y_pad, 66)
    limbs = jnp.stack(
        [
            u[32 + 2 * i].astype(jnp.uint32)
            + (u[33 + 2 * i].astype(jnp.uint32) << 8)
            for i in range(16)
        ],
        axis=0,
    )
    return _cond_sub_p(limbs, p_limbs16)


def _dot(a, b):
    """(m, K) @ (K, N) -> (m, N) f32, exact."""
    return jax.lax.dot_general(
        a.astype(_DT), b, (((1,), (0,)), ((), ())),
        precision=_HIGHEST, preferred_element_type=jnp.float32,
    )


def _carry_digits(cols_i32, n_out: int, trunc: bool = False):
    """Signed base-256 digit columns -> canonical bytes (n_out, N).
    If trunc, carries past the last row are dropped (mod 256^n_out)."""
    outs = []
    carry = None
    k = cols_i32.shape[0]
    for c in range(n_out):
        v = cols_i32[c] if c < k else jnp.zeros_like(cols_i32[0])
        if carry is not None:
            v = v + carry
        outs.append(v & 255)
        carry = v >> 8  # arithmetic shift: floor division for negatives
    del trunc  # (carry is dropped either way; kept for call-site clarity)
    return jnp.stack(outs, axis=0)


def _cond_sub_p(limbs_u32, p_limbs):
    L = limbs_u32.shape[0]
    diff = []
    c = jnp.ones_like(limbs_u32[0])
    for i in range(L):
        v = limbs_u32[i] + np.uint32(0xFFFF - p_limbs[i]) + c
        diff.append(v & 0xFFFF)
        c = v >> 16
    ge = c > 0
    return jnp.stack(
        [jnp.where(ge, diff[i], limbs_u32[i]) for i in range(L)], axis=0
    )


def _basis_flatten(b: CrtBasis):
    leaves = (b.qs, b.deltas, b.C0, b.C1, b.G, b.negM_dig, b.NB, b.PB)
    aux = (
        b.p, b.bound_bits, b.P, b.qr, tuple(b.qs_host), tuple(b.t_host),
        b.M, b.minv_qr, b.delta_r, b.dmax_bits, b.p_limbs16,
    )
    return leaves, aux


def _basis_unflatten(aux, leaves):
    b = object.__new__(CrtBasis)
    (b.qs, b.deltas, b.C0, b.C1, b.G, b.negM_dig, b.NB, b.PB) = leaves
    (
        b.p, b.bound_bits, b.P, b.qr, qs_host, t_host, b.M, b.minv_qr,
        b.delta_r, b.dmax_bits, b.p_limbs16,
    ) = aux
    b.qs_host = list(qs_host)
    b.t_host = list(t_host)
    return b


jax.tree_util.register_pytree_node(CrtBasis, _basis_flatten, _basis_unflatten)


# ---------------------------------------------------------------------------
# constant-matrix plans
# ---------------------------------------------------------------------------

def residues_of_ints_np(vals_bytes: np.ndarray, qs) -> np.ndarray:
    """(32, N) u8 byte array (LE) -> (len(qs), N) residues, via one i64
    matmul (host-side table building)."""
    qa = np.asarray(qs, np.int64)[:, None]
    pow256 = np.array(
        [[pow(256, l, int(q)) for l in range(32)] for q in np.asarray(qs)],
        np.int64,
    )
    # f64 matmul hits BLAS (int64 matmul does not) and is exact here:
    # values <= 32 * 255 * 2^14 < 2^27 << 2^53; the mod runs as exact f64
    # floor-division (i64 elementwise % is several seconds at 2^20)
    acc = pow256.astype(np.float64) @ vals_bytes.astype(np.float64)
    qf = qa.astype(np.float64)
    acc -= np.floor(acc / qf) * qf
    return acc.astype(np.int64)


def ints_to_bytes_np(vals) -> np.ndarray:
    """list of N ints (< 2^256) -> (32, N) u8."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, np.uint8).reshape(-1, 32).T.copy()


class CrtMatmulPlan:
    """Chunked residue tables of one constant matrix W (mod p). With
    mont_fix, W is pre-scaled by R so reconstruct's R^-1 cancels and the
    call computes exactly (W @ x) mod p, Montgomery-domain preserving.
    The last basis lane (redundant) uses t = 1."""

    def __init__(self, basis: CrtBasis, w_ints, mont_fix: bool = True):
        p = basis.p
        Kout, K = len(w_ints), len(w_ints[0])
        scale = (R256 % p) if mont_fix else 1
        flat = [int(w) * scale % p for row in w_ints for w in row]
        by = ints_to_bytes_np(flat)
        res = residues_of_ints_np(by, basis.qs_host)  # (P+1, Kout*K)
        # t-scale + balance + chunk in exact f64 / i32 (i64 elementwise is
        # the table-build bottleneck at 2^20 matrix entries)
        ts = np.array(basis.t_host + [1], np.float64)[:, None]
        qf = np.array(basis.qs_host, np.float64)[:, None]
        rf = res.astype(np.float64) * ts  # < 2^28, exact
        rf -= np.floor(rf / qf) * qf
        rb = np.where(rf > qf // 2, rf - qf, rf).astype(np.int32)
        c0 = ((rb + 64) & 127) - 64
        c1 = (rb - c0) >> 7
        assert np.abs(c1).max() < 64
        sh = (len(basis.qs_host), Kout, K)
        self.W0 = jnp.asarray(c0.astype(np.float32).reshape(sh))
        self.W1 = jnp.asarray(c1.astype(np.float32).reshape(sh))
        self.kout, self.k = Kout, K


def _plan_flatten(pl: CrtMatmulPlan):
    return (pl.W0, pl.W1), (pl.kout, pl.k)


def _plan_unflatten(aux, leaves):
    pl = object.__new__(CrtMatmulPlan)
    pl.W0, pl.W1 = leaves
    pl.kout, pl.k = aux
    return pl


jax.tree_util.register_pytree_node(CrtMatmulPlan, _plan_flatten, _plan_unflatten)


def _bdot(a, b):
    """(P, m, k) @ (P, k, n) -> (P, m, n) f32, prime-batched.

    STARK_TPU_CRT_SPLITK=1 splits the contraction in half and adds the
    partial products in i32 (defensive mode: halves the worst-case f32
    accumulator magnitude if a backend's accumulation turns out inexact
    near 2^23)."""
    import os

    dims = (((2,), (1,)), ((0,), (0,)))
    dot = lambda x, y: jax.lax.dot_general(
        x.astype(_DT), y, dims, precision=_HIGHEST,
        preferred_element_type=jnp.float32,
    )
    k = a.shape[2]
    if os.environ.get("STARK_TPU_CRT_SPLITK", "0") == "1" and k > 128:
        h = k // 2
        lo = dot(a[:, :, :h], b[:, :h])
        hi = dot(a[:, :, h:], b[:, h:])
        return (lo.astype(jnp.int32) + hi.astype(jnp.int32)).astype(jnp.float32)
    return dot(a, b)


def crt_matmul(basis: CrtBasis, plan: CrtMatmulPlan, x_limbs, pre=None):
    """(W @ x) mod p. x_limbs: (16, K, B) u32 canonical 16-bit limb planes;
    pre: optional (P+1, K, B) u32 residue table multiplied in pointwise
    before the matmul (implied integer < p). Returns (16, Kout, B) u32.

    The batch axis is per-lane independent (only K is contracted), so when
    the four f32 chunk-product buffers would exceed STARK_TPU_CRT_TEMP_BYTES
    (default 2 GB, sized for a 16 GB device) the call runs as a lax.map over
    contiguous B-chunks, bounding the execution-time temp arena of one
    column's LDE at precision 2^23."""
    import os

    L, K, B = x_limbs.shape
    assert K == plan.k
    P1 = len(basis.qs_host)
    budget = int(os.environ.get("STARK_TPU_CRT_TEMP_BYTES", 2 << 30))
    est = 4 * P1 * plan.kout * B * 4  # the four bdot f32 outputs
    if est > budget and B > 1:
        nc = 1
        while est // nc > budget and nc * 2 <= B and B % (nc * 2) == 0:
            nc *= 2
        if nc > 1:
            Bc = B // nc

            def body(c):
                xs = jax.lax.dynamic_slice_in_dim(x_limbs, c * Bc, Bc, 2)
                ps = (
                    None
                    if pre is None
                    else jax.lax.dynamic_slice_in_dim(pre, c * Bc, Bc, 2)
                )
                return _crt_matmul_body(basis, plan, xs, ps)

            out = jax.lax.map(body, jnp.arange(nc))  # (nc, L, kout, Bc)
            return jnp.moveaxis(out, 0, 2).reshape(L, plan.kout, B)
    return _crt_matmul_body(basis, plan, x_limbs, pre)


def _crt_matmul_body(basis: CrtBasis, plan: CrtMatmulPlan, x_limbs, pre=None):
    L, K, B = x_limbs.shape
    r = basis.reduce_in(x_limbs.reshape(L, K * B)).reshape(-1, K, B)
    if pre is not None:
        prod = r * pre  # < 2^28
        r = basis.fold(prod.reshape(prod.shape[0], -1), 28).reshape(r.shape)
    x0, x1 = basis.chunk(r)
    S00 = _bdot(plan.W0, x0)
    S01 = _bdot(plan.W0, x1)
    S10 = _bdot(plan.W1, x0)
    S11 = _bdot(plan.W1, x1)
    d3 = basis.deltas[:, :, None]
    s11 = S11.astype(jnp.int32)  # |.| <= K*64*127 < 2^23
    s11 = (s11 >> QBITS) * d3 + (s11 & (QBASE - 1))  # ~2^20, = S11 mod q
    sm = (S01 + S10).astype(jnp.int32)  # |.| <= 2^24
    sm = (sm >> QBITS) * d3 + (sm & (QBASE - 1))  # ~2^20
    raw = S00.astype(jnp.int32) + (sm << 7) + d3 * s11  # |.| < 2^30
    s = basis.fold_signed(raw.reshape(raw.shape[0], -1), 30)
    out = basis.reconstruct(s)
    return out.reshape(L, plan.kout, B)
