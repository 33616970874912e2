"""FRI low-degree proofs (4x folding, 40 queries/round, direct check <= 16).

Device re-expression of the reference's recursive FRI
(`/root/reference/packages/fri/src/fri.rs`): the host drives the shrinking
round loop (XLA needs static shapes, so each round is its own compiled
kernel size), while all O(domain) math per round -- quartic row
interpolation, column evaluation, leaf hashing -- runs batched on device.
The Fiat-Shamir path (roots -> special_x, roots -> query indices) is
byte-exact with the reference.

Proof layout mirrors `FriProof` (`fri.rs:17-26`): a list of Middle rounds
{root2, column_branches, poly_branches} terminated by one Last {last}.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import FieldSpec
from stark_tpu.merkle import tree as mt
from stark_tpu.ops import modmath as mm
from stark_tpu.ops import quartic
from stark_tpu.protocol import transcript as ts
from stark_tpu.utils import poly_host as ph

MIN_DEG_DIRECT_CHECKING = 16  # fri.rs:14
QUERIES_PER_ROUND = 40  # fri.rs:184


@dataclass
class FriLast:
    last: list[bytes]  # 32-byte LE field elements (all values of the domain)


@dataclass
class FriMiddle:
    root2: bytes
    column_branches: list[mt.MerkleProof]
    poly_branches: list[mt.MerkleProof]


def _canonical_bytes(spec: FieldSpec, values_mont) -> np.ndarray:
    return mm.limbs_to_bytes_le_np(np.asarray(mm.from_mont(spec, values_mont)), spec)


def _value_words(spec: FieldSpec, values_mont):
    """Montgomery (L, n) -> (16, n) device words of the canonical 32-byte
    little-endian encodings (zero block padding), all on device."""
    from stark_tpu.parallel.prove_sharded import _leaves_to_words

    return _leaves_to_words(spec, [values_mont])


def _fold_xsets(arr, quarter: int):
    """(L, N) -> (L, quarter, 4) with [:, i, j] = arr[:, i + quarter*j]."""
    L = arr.shape[0]
    return jnp.moveaxis(arr.reshape(L, 4, quarter), 1, 2)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _commit_j(spec: FieldSpec, values_mont, digest="blake2s"):
    """One dispatch: canonical leaf words + every tree layer."""
    words = _value_words(spec, values_mont)
    return words, mt.build_layers_digest(words, 32, digest)


@functools.partial(jax.jit, static_argnums=0)
def _sx_j(spec: FieldSpec, root_words8):
    """special_x from the value-tree root, ON DEVICE (fri.rs:135)."""
    from stark_tpu.protocol import device_transcript as dt

    return dt.digest_le_int_mont(spec, root_words8)[:, :, None]  # (L, 1, 1)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _ys_j(root2_words8, quarter: int, exclude: int):
    """Query indices + the 4-per-query row positions, ON DEVICE."""
    from stark_tpu.protocol import device_transcript as dt

    ys = dt.pseudorandom_indices(root2_words8, quarter, QUERIES_PER_ROUND, exclude)
    poly_positions = (
        ys[:, None] + jnp.uint32(quarter) * jnp.arange(4, dtype=jnp.uint32)[None, :]
    ).reshape(-1)
    return ys, poly_positions


def materialize_u32(arrs):
    """Move many device uint32 arrays to host in ONE transfer.

    Multi-process (`jax.distributed`) jobs hold globally-sharded arrays no
    single process can address; `process_allgather` assembles the full
    value on every host (the proof bytes must be identical everywhere)."""
    flat = [a.reshape(-1) for a in arrs]
    cat = jnp.concatenate(flat)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        big = np.asarray(multihost_utils.process_allgather(cat, tiled=True))
        big = big.astype("<u4")
    else:
        big = np.asarray(cat).astype("<u4")
    out, off = [], 0
    for a in arrs:
        size = int(np.prod(a.shape))
        out.append(big[off : off + size].reshape(a.shape))
        off += size
    return out


def _commit_tree(spec: FieldSpec, values_mont) -> mt.DeviceMerkleTree:
    words, layers = _commit_j(spec, values_mont)
    return mt.DeviceMerkleTree(words, 32, list(layers))


@functools.partial(jax.jit, static_argnums=0)
def _fold_j(spec: FieldSpec, values, xs, sx):
    """One dispatch: the whole 4x quartic fold at special_x.

    The row points are a coset of the 4th roots of unity -- x_j = x*I^j
    with I = g^(n/4) (fri.rs:141-152) -- so the degree-3 interpolation is
    an exact radix-4 inverse DFT instead of general Lagrange:

        p(sx) = (1/4) * sum_k u_k t^k,  u_k = sum_j v_j I^(-jk),
        t = sx * x^(-1)

    where the u_k butterfly costs one constant mul (I) + 8 add/subs and
    x^(-1) is a REVERSAL-GATHER of the round's own power table
    (x_i^(-1) = g^(n-i) = xs[(n-i) mod n]) -- no batch inversion, no
    prefix scan. ~6 modmuls/row vs ~30 + a multi_inv for the Lagrange
    route. Identical field values by algebra; asserted equal to
    multi_interp_4 by tests (STARK_TPU_FRI_LAGRANGE=1 restores the old
    path for A/B)."""
    import os

    n = values.shape[1]
    quarter = n // 4
    L = values.shape[0]
    if os.environ.get("STARK_TPU_FRI_LAGRANGE", "0") == "1":
        xsets = _fold_xsets(xs, quarter)
        ysets = _fold_xsets(values, quarter)
        polys = quartic.multi_interp_4(spec, xsets, ysets)
        return quartic.eval_quartic_batch(
            spec, polys, jnp.broadcast_to(sx[:, :, 0], (L, quarter))
        )

    ys4 = values.reshape(L, 4, quarter)
    v0, v1, v2, v3 = (ys4[:, j] for j in range(4))
    i_root = xs[:, quarter][:, None]  # I = g^(n/4), the round's 4th root
    mul = lambda a, b: mm.mmul(spec, a, b)
    a = mm.madd(spec, v0, v2)
    b = mm.madd(spec, v1, v3)
    c = mm.msub(spec, v0, v2)
    e = mul(jnp.broadcast_to(i_root, c.shape), mm.msub(spec, v3, v1))
    u0 = mm.madd(spec, a, b)
    u2 = mm.msub(spec, a, b)
    u1 = mm.madd(spec, c, e)
    u3 = mm.msub(spec, c, e)
    # x_i^(-1) for i < quarter: xs[0]=1 self-inverse, else xs[n-i]
    xinv = jnp.concatenate(
        [xs[:, :1], xs[:, : n - quarter : -1]], axis=1
    )
    t = mul(jnp.broadcast_to(sx[:, :, 0], (L, quarter)), xinv)
    acc = mm.madd(spec, mul(u3, t), u2)
    acc = mm.madd(spec, mul(acc, t), u1)
    acc = mm.madd(spec, mul(acc, t), u0)
    inv4 = mm.mont_const(spec, pow(4, spec.p - 2, spec.p))
    return mul(jnp.broadcast_to(inv4, acc.shape), acc)


def prove_low_degree(
    spec: FieldSpec,
    values_mont,
    xs_full,
    max_deg_plus_1: int,
    exclude_multiples_of: int = 0,
    deg_direct_checking: int = MIN_DEG_DIRECT_CHECKING,
    first_tree: mt.DeviceMerkleTree | None = None,
    digest: str = "blake2s",
):
    """Prove the (L, N) Montgomery evaluations have degree < max_deg_plus_1.

    xs_full: (L, N) Montgomery power table of the domain root (the full `xs`
    of this level; recursion strides it by 4 per round, replacing the
    reference's per-round `expand_root_of_unity`, `fri.rs:84`).
    Follows `prove_low_degree_rec` (`fri.rs:64-224`).

    `first_tree`: the caller's committed tree over the SAME values with
    32-byte leaves, if it has one (the prover's l_tree; the reference
    recommits identical content at `fri.rs:128-131`, producing the same
    root, so reusing it changes no byte of the proof).

    The transcript loop only does the commits and folds (two tiny
    root transfers per round); branch gathering is deferred to one batch
    at the end -- queries depend only on the already-derived roots.
    """
    pending = prove_low_degree_pending(
        spec,
        values_mont,
        xs_full,
        max_deg_plus_1,
        exclude_multiples_of,
        deg_direct_checking,
        first_tree,
        digest,
    )
    flats = materialize_u32(pending["device_arrays"])
    return assemble_fri(spec, pending, flats)


def _n_rounds(max_deg_plus_1: int, cutoff: int) -> int:
    r = 0
    while max_deg_plus_1 > cutoff:
        r += 1
        max_deg_plus_1 //= 4
    return r


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _fri_chain_j(
    spec: FieldSpec, n_rounds: int, exclude: int, digest,
    values, xs, first_words, first_layers,
):
    """The ENTIRE FRI recursion as one traced computation.

    Every round's shapes are static (each is the previous quarter), and
    every challenge is device-derived, so nothing forces per-round
    dispatches: fusing the ~6 dispatches x ~7 rounds into ONE removes
    ~35 host->device enqueues per prove. The per-round jits remain for
    the no-first-tree path and tests. Outputs are ordered exactly as
    `assemble_fri` consumes them: per round (root2, col_flat, val_flat),
    then the direct-check `last` words."""
    from stark_tpu.protocol import device_transcript as dt

    words, layers = first_words, first_layers
    outs = []
    for _ in range(n_rounds):
        n = values.shape[1]
        quarter = n // 4
        val_root_w = layers[-1][:, 0]
        sx = dt.digest_le_int_mont(spec, val_root_w)[:, :, None]
        column = _fold_j(spec, values, xs, sx)
        c_words = _value_words(spec, column)
        c_layers = mt.build_layers_digest(c_words, 32, digest)
        root2_w = c_layers[-1][:, 0]
        ys = dt.pseudorandom_indices(
            root2_w, quarter, QUERIES_PER_ROUND, exclude
        )
        poly_positions = (
            ys[:, None]
            + jnp.uint32(quarter) * jnp.arange(4, dtype=jnp.uint32)[None, :]
        ).reshape(-1)
        val_flat = mt._gather_flat_j(
            words, tuple(layers[:-1]), poly_positions.astype(jnp.int32)
        )
        col_flat = mt._gather_flat_j(
            c_words, tuple(c_layers[:-1]), ys.astype(jnp.int32)
        )
        outs.extend([root2_w, col_flat, val_flat])
        values, words, layers = column, c_words, tuple(c_layers)
        xs = xs[:, ::4]
    outs.append(_value_words(spec, values)[:8])
    return tuple(outs)


def prove_low_degree_pending(
    spec: FieldSpec,
    values_mont,
    xs_full,
    max_deg_plus_1: int,
    exclude_multiples_of: int = 0,
    deg_direct_checking: int = MIN_DEG_DIRECT_CHECKING,
    first_tree: mt.DeviceMerkleTree | None = None,
    digest: str = "blake2s",
):
    """Fully-async FRI: every challenge (special_x, query indices) is
    derived ON DEVICE (`protocol/device_transcript`), so the whole
    recursion enqueues without a single host sync. Returns a pending
    record whose `device_arrays` the caller materializes in one transfer
    (together with the rest of the proof) and feeds to `assemble_fri`.

    With a caller-committed `first_tree` (the prover's l_tree) the whole
    recursion runs as ONE fused dispatch (`_fri_chain_j`);
    STARK_TPU_FRI_FUSED=0 restores the per-round dispatch loop."""
    import os

    assert deg_direct_checking >= MIN_DEG_DIRECT_CHECKING
    values = values_mont
    xs = xs_full
    if (
        first_tree is not None
        and os.environ.get("STARK_TPU_FRI_FUSED", "1") != "0"
    ):
        n_rounds = _n_rounds(max_deg_plus_1, deg_direct_checking)
        outs = _fri_chain_j(
            spec, n_rounds, exclude_multiples_of, digest,
            values, xs, first_tree.leaf_words, tuple(first_tree.layers),
        )
        return {"device_arrays": list(outs), "n_rounds": n_rounds}
    rounds = []  # (root2_words, val_flat, col_flat) device triples
    while True:
        n = values.shape[1]
        if max_deg_plus_1 <= deg_direct_checking:
            last_words = _value_words(spec, values)[:8]  # (8, n)
            break

        # this round's value tree: round 0 can reuse the caller's l_tree,
        # every later round's values ARE the previous round's column, whose
        # tree (m2) is already committed -- same leaves, same root
        if first_tree is not None:
            m_tree = first_tree
            first_tree = None
        else:
            words, layers = _commit_j(spec, values, digest)
            m_tree = mt.DeviceMerkleTree(words, 32, list(layers))
        val_root_w = m_tree.layers[-1][:, 0]
        sx = _sx_j(spec, val_root_w)

        quarter = n // 4
        column = _fold_j(spec, values, xs, sx)

        c_words, c_layers = _commit_j(spec, column, digest)
        m2_tree = mt.DeviceMerkleTree(c_words, 32, list(c_layers))
        root2_w = c_layers[-1][:, 0]
        ys, poly_positions = _ys_j(root2_w, quarter, exclude_multiples_of)
        val_flat = m_tree._gather_device(poly_positions)
        col_flat = m2_tree._gather_device(ys)
        rounds.append((root2_w, val_flat, col_flat))

        values = column
        first_tree = m2_tree  # next round's value tree, already committed
        xs = xs[:, ::4]
        max_deg_plus_1 //= 4

    device_arrays = []
    for (root2_w, val_flat, col_flat) in rounds:
        device_arrays.extend([root2_w, col_flat, val_flat])
    device_arrays.append(last_words)
    return {"device_arrays": device_arrays, "n_rounds": len(rounds)}


def _branches_from_flat(flat: np.ndarray, leaf_bytes: int, k: int):
    W = (leaf_bytes + 3) // 4
    W = ((W + 15) // 16) * 16  # block padding of the leaf words
    depth = (flat.shape[0] - W) // 8
    proofs = []
    for j in range(k):
        leaf = flat[:W, j].tobytes()[:leaf_bytes]
        nodes = [
            flat[W + 8 * d : W + 8 * (d + 1), j].tobytes() for d in range(depth)
        ]
        proofs.append(mt.MerkleProof(leaf, nodes))
    return proofs


def assemble_fri(spec: FieldSpec, pending, flats) -> list:
    """Host-side formatting of the materialized FRI arrays."""
    proof: list[FriMiddle | FriLast] = []
    i = 0
    for _ in range(pending["n_rounds"]):
        root2_w, col_flat, val_flat = flats[i], flats[i + 1], flats[i + 2]
        i += 3
        proof.append(
            FriMiddle(
                root2_w.astype("<u4").tobytes(),
                _branches_from_flat(col_flat, 32, QUERIES_PER_ROUND),
                _branches_from_flat(val_flat, 32, 4 * QUERIES_PER_ROUND),
            )
        )
    last_words = flats[i]
    n = last_words.shape[1]
    proof.append(
        FriLast([last_words[:, j].astype("<u4").tobytes() for j in range(n)])
    )
    return proof


def verify_low_degree_proof(
    spec: FieldSpec,
    merkle_root: bytes,
    root_of_unity: int,
    proof,
    max_deg_plus_1: int,
    exclude_multiples_of: int = 0,
    digest: str = "blake2s",
) -> bool:
    """Host-side FRI verification (`fri.rs:226-404`); raises on failure.
    `digest` must match the prover's tree digest (`H: Digest` parity)."""
    p = spec.p
    # infer domain order by repeated squaring (fri.rs:253-258)
    rou_deg = 1
    test_val = root_of_unity
    while test_val != 1:
        rou_deg *= 2
        test_val = test_val * test_val % p

    quartic_roots = [
        1,
        pow(root_of_unity, rou_deg // 4, p),
        pow(root_of_unity, rou_deg // 2, p),
        pow(root_of_unity, rou_deg * 3 // 4, p),
    ]

    for prf in proof[:-1]:
        if not isinstance(prf, FriMiddle):
            raise ValueError("FRI proofs must be Middle except the last element")
        special_x = spec.from_bytes_le(merkle_root)
        ys = ts.get_pseudorandom_indices(
            prf.root2, rou_deg // 4, QUERIES_PER_ROUND, exclude_multiples_of
        )
        poly_positions = [j * (rou_deg // 4) + y for y in ys for j in range(4)]

        column_values = mt.verify_multi_branch(
            prf.root2, ys, prf.column_branches, digest
        )
        poly_values = mt.verify_multi_branch(
            merkle_root, poly_positions, prf.poly_branches, digest
        )

        for i, y in enumerate(ys):
            x1 = pow(root_of_unity, y, p)
            xs4 = [q * x1 % p for q in quartic_roots]
            row = [spec.from_bytes_le(poly_values[i * 4 + j]) for j in range(4)]
            col = spec.from_bytes_le(column_values[i])
            poly = ph.lagrange_interp(spec, xs4, row)
            if ph.eval_quartic(spec, poly, special_x) != col:
                raise ValueError("FRI row/column mismatch")

        merkle_root = prf.root2
        root_of_unity = pow(root_of_unity, 4, p)
        max_deg_plus_1 //= 4
        rou_deg //= 4
        quartic_roots = [
            1,
            pow(root_of_unity, rou_deg // 4, p),
            pow(root_of_unity, rou_deg // 2, p),
            pow(root_of_unity, rou_deg * 3 // 4, p),
        ]

    if max_deg_plus_1 < MIN_DEG_DIRECT_CHECKING // 2:
        raise ValueError("the degree of direct checking is too low")
    last = proof[-1]
    if not isinstance(last, FriLast):
        raise ValueError("the last element of FRI proofs must be Last")
    data = last.last
    if len(data) <= max_deg_plus_1:
        raise ValueError("last data too short")

    decoded = [spec.from_bytes_le(v) for v in data]
    # Merkle root of the raw last data must match (fri.rs:373-381)
    if mt.commit(list(data), digest).root != merkle_root:
        raise ValueError("FRI last-round root mismatch")

    # direct low-degree check (fri.rs:384-400)
    xs = [pow(root_of_unity, i, p) for i in range(len(data))]
    if exclude_multiples_of:
        pts = [i for i in range(len(data)) if i % exclude_multiples_of != 0]
    else:
        pts = list(range(len(data)))
    head, rest = pts[:max_deg_plus_1], pts[max_deg_plus_1:]
    poly = ph.lagrange_interp(spec, [xs[i] for i in head], [decoded[i] for i in head])
    for pos in rest:
        if ph.eval_poly_at(spec, poly, xs[pos]) != decoded[pos]:
            raise ValueError("FRI direct check failed")
    return True
