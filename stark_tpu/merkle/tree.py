"""Blake2s Merkle commitment: device leaf hashing + log-depth fold.

One builder replaces the reference's three tree variants
(`SerialMerkleTree`, `ParallelMerkleTree`, `MerkleProofInPlace` --
`/root/reference/packages/commitment/src/{serial_merkle_tree.rs,
pallarel_merkle_tree.rs,merkle_proof_in_place.rs}`): all three produce the
same root/proofs (their own differential test,
`merkle_proof_in_place.rs:208-261`, asserts it), so the TPU build hashes
every layer as one batched kernel and keeps the layers for proof assembly.

Tree shape (power-of-two leaf count, as the prover always commits
power-of-two domains):
  layer0[i] = blake2s(leaf_i); layer_{k+1}[i] = blake2s(layer_k[2i] ||
  layer_k[2i+1]); root = last layer[0].
Proofs are bottom-up sibling lists validated by the index-parity walk
(`merkle_tree.rs:25-43`).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from stark_tpu.ops import blake2s as b2
from stark_tpu.protocol.transcript import blake


@dataclass
class MerkleProof:
    """= reference `Proof { leaf, nodes }` (`merkle_tree.rs:14-18`)."""

    leaf: bytes
    nodes: list[bytes]


class MerkleTree:
    """Committed tree with all digest layers held on host for proof gen."""

    def __init__(
        self,
        leaves_np: np.ndarray,
        layers: list[np.ndarray],
        digest: str = "blake2s",
    ):
        self.leaves = leaves_np  # (N, leaf_bytes) uint8
        self.layers = layers  # each (n_i, 32) uint8
        self.digest = digest

    @property
    def width(self) -> int:
        return self.leaves.shape[0]

    @property
    def root(self) -> bytes:
        return self.layers[-1][0].tobytes()

    def gen_proofs(self, indices) -> list[MerkleProof]:
        proofs = []
        for idx in indices:
            idx = int(idx)
            nodes = []
            t = idx
            for layer in self.layers[:-1]:
                if (t ^ 1) >= layer.shape[0]:
                    # lone node on an odd-width layer: the reference's
                    # sibling walk panics here (serial_merkle_tree.rs:29)
                    raise ValueError(
                        f"index {idx}: no sibling on a width-"
                        f"{layer.shape[0]} layer (odd-width trees have no "
                        "well-defined branches; parity with the reference)"
                    )
                nodes.append(layer[t ^ 1].tobytes())
                t //= 2
            proofs.append(MerkleProof(self.leaves[idx].tobytes(), nodes))
        return proofs


def commit_np(leaves_np: np.ndarray, digest: str = "blake2s") -> MerkleTree:
    """Build the tree on device from (N, leaf_bytes) uint8 leaves.

    `digest` picks the hash, like the reference's `H: Digest` type parameter
    (`merkle_tree.rs:60-73`): "blake2s" (the production hash) or "poseidon"
    (leaves must be <=64 bytes, as `poseidon.rs:33` enforces).

    Non-power-of-two widths follow `serial_merkle_tree.rs:62-83`: layers
    fold with `chunks(2)`, so a lone trailing node hashes ALONE (a 32-byte
    message). Note the reference's own `gen_proof`/`validate`
    (`serial_merkle_tree.rs:25-38`, `merkle_tree.rs:25-43`) cannot produce
    or check a branch that walks through such a node (the sibling lookup
    `row[tmp ^ 1]` panics); `gen_proofs` here raises a clean ValueError in
    that case instead. The protocol itself only commits power-of-two
    domains."""
    n, leaf_bytes = leaves_np.shape
    if digest == "blake2s":
        words = jnp.asarray(b2.bytes_to_words_np(leaves_np, leaf_bytes))
        digests = b2.blake2s_words(words, leaf_bytes)  # (8, N)
        layers = [b2.digest_words_to_bytes_np(digests)]
        cur = digests
        while cur.shape[1] > 1:
            # pair (2i, 2i+1): message = 16 words (left digest || right digest)
            m = cur.shape[1] // 2
            pairs = cur[:, : 2 * m].reshape(8, m, 2)
            msg = jnp.concatenate(
                [pairs[:, :, 0], pairs[:, :, 1]], axis=0
            )  # (16, m)
            nxt = b2.blake2s_words(msg, 64)
            if cur.shape[1] % 2:  # lone tail node: hash the 32-byte digest
                tail = jnp.concatenate(
                    [cur[:, -1:], jnp.zeros((8, 1), jnp.uint32)], axis=0
                )
                nxt = jnp.concatenate(
                    [nxt, b2.blake2s_words(tail, 32)], axis=1
                )
            cur = nxt
            layers.append(b2.digest_words_to_bytes_np(cur))
    elif digest == "poseidon":
        from stark_tpu.fields.field import BLS12_381_FR
        from stark_tpu.ops import modmath as mm
        from stark_tpu.ops import poseidon as pos

        layers = [pos.poseidon_hash_leaves_np(leaves_np)]
        while layers[-1].shape[0] > 1:
            cur = layers[-1]
            m = cur.shape[0] // 2
            limbs = mm.bytes_le_to_limbs_np(cur[: 2 * m], BLS12_381_FR)
            left, right = limbs[:, 0::2], limbs[:, 1::2]
            folded = pos.poseidon_hash_pairs(
                BLS12_381_FR, jnp.asarray(left), jnp.asarray(right)
            )
            nxt = mm.limbs_to_bytes_le_np(np.asarray(folded), BLS12_381_FR)
            if cur.shape[0] % 2:
                nxt = np.concatenate(
                    [nxt, pos.poseidon_hash_leaves_np(cur[-1:])], axis=0
                )
            layers.append(nxt)
    else:
        raise ValueError(f"unknown digest {digest!r}")
    return MerkleTree(leaves_np, layers, digest)


def commit(leaves: list[bytes], digest: str = "blake2s") -> MerkleTree:
    arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(
        len(leaves), len(leaves[0])
    )
    return commit_np(arr, digest)


class DeviceMerkleTree:
    """Blake2s tree whose leaves and digest layers stay ON DEVICE.

    The host only ever sees the 32-byte root (one tiny transfer per commit)
    and, at proof time, the few hundred queried leaves/siblings via device
    gathers."""

    def __init__(self, leaf_words, leaf_bytes: int, layers,
                 leaf_word_count: int | None = None):
        """leaf_words may be None (big-domain streamed m-tree: leaves are
        never materialized and branch leaf words are packed on the fly by
        `core.m_gather_j`); pass leaf_word_count so `_proofs_from_flat`
        still knows the flat layout."""
        self.leaf_words = leaf_words  # (W, N) uint32 LE words of the leaves
        self.leaf_bytes = leaf_bytes
        self.layers = layers  # device (8, n_i) digest words, n_i halving
        self._root = None
        self._W = (
            int(leaf_words.shape[0]) if leaf_words is not None
            else int(leaf_word_count)
        )

    def release_device(self):
        """Drop the device arrays once every gather against this tree has
        been DISPATCHED (pending executions hold their own references, so
        the buffers free as soon as those gathers run -- at precision 2^23
        the m-tree words alone are 2.1 GB). `_proofs_from_flat` keeps
        working: it only needs leaf_bytes and the leaf word count."""
        self.leaf_words = None
        self.layers = None

    @property
    def width(self) -> int:
        return self.leaf_words.shape[1]

    @property
    def root(self) -> bytes:
        if self._root is None:
            self._root = (
                np.asarray(self.layers[-1][:, 0]).astype("<u4").tobytes()
            )
        return self._root

    def _gather_device(self, indices):
        """Device-side gather of (leaves || sibling path) for `indices`;
        returns the flat (W + 8*depth, k) device array (no host sync).
        `indices` may be host ints or a device uint32/int32 array (one
        compiled dispatch either way)."""
        if isinstance(indices, (jnp.ndarray, jax.Array)):
            idx = indices.astype(jnp.int32)
        else:
            idx = jnp.asarray(
                np.asarray([int(i) for i in indices], dtype=np.int32)
            )
        return _gather_flat_j(self.leaf_words, tuple(self.layers[:-1]), idx)

    def _proofs_from_flat(self, flat: np.ndarray, k: int) -> list[MerkleProof]:
        W = self._W
        depth = (flat.shape[0] - W) // 8
        leaf_cols = flat[:W]
        proofs = []
        for j in range(k):
            leaf = leaf_cols[:, j].tobytes()[: self.leaf_bytes]
            nodes = [
                flat[W + 8 * d : W + 8 * (d + 1), j].tobytes() for d in range(depth)
            ]
            proofs.append(MerkleProof(leaf, nodes))
        return proofs

    def gen_proofs(self, indices) -> list[MerkleProof]:
        """Sibling walk per index; all gathers on device, ONE host
        transfer total (leaves and sibling layers concatenated row-wise)."""
        flat = np.asarray(self._gather_device(indices)).astype("<u4")
        return self._proofs_from_flat(flat, len(list(indices)))


@jax.jit
def _gather_flat_j(leaf_words, layers, idx):
    gathered = [leaf_words[:, idx]]
    t = idx
    for layer in layers:
        gathered.append(layer[:, t ^ 1])
        t = t // 2
    return jnp.concatenate(gathered, axis=0)


def gen_proofs_many(requests) -> list[list[MerkleProof]]:
    """Batch branch generation: `requests` is a list of (tree, indices).
    All gathers are enqueued on device and moved to the host in a SINGLE
    transfer."""
    flats = [tree._gather_device(idx) for (tree, idx) in requests]
    big = np.asarray(
        jnp.concatenate([f.reshape(1, -1) for f in flats], axis=1)
    ).astype("<u4")
    out = []
    off = 0
    for (tree, idx), f in zip(requests, flats):
        size = f.shape[0] * f.shape[1]
        flat = big[0, off : off + size].reshape(f.shape)
        off += size
        out.append(tree._proofs_from_flat(flat, len(list(idx))))
    return out


def _build_layers(leaf_words, leaf_bytes: int):
    h = b2.blake2s_words(leaf_words, leaf_bytes)  # (8, N)
    layers = [h]
    while h.shape[1] > 1:
        m = h.shape[1] // 2
        pair = h.reshape(8, m, 2)
        msg = jnp.concatenate([pair[:, :, 0], pair[:, :, 1]], axis=0)
        h = b2.blake2s_words(msg, 64)
        layers.append(h)
    return tuple(layers)


def _build_layers_poseidon(leaf_words):
    """Device Poseidon tree layers over (W, N) u32 LE words of 32-byte
    value leaves (the l-tree / FRI-tree leaf shape). Returns (8, n_i) u32
    digest-word layers — the same layout `_build_layers` produces, so
    `DeviceMerkleTree` gathers/branches work unchanged.

    Digest semantics = the reference's `PoseidonDigest`
    (`commitment/src/poseidon.rs:30-63`): leaf hash = Poseidon(tag, v, 0)
    over BLS12-381 Fr, fold = Poseidon(tag, left, right). The 32-byte
    leaves here are canonical BN254 Fr encodings, and BN254 r < BLS12-381
    Fr p, so every chunk is canonical by construction (the reference
    panics otherwise — that case cannot arise for these trees)."""
    from stark_tpu.fields.field import BLS12_381_FR as B
    from stark_tpu.ops import poseidon as pos

    w = leaf_words[:8]  # (8, N): the 32-byte value; rest is block padding
    lo, hi = w & jnp.uint32(0xFFFF), w >> jnp.uint32(16)
    limbs = jnp.stack([lo, hi], axis=1).reshape(16, w.shape[1])
    cur = pos.poseidon_hash_pairs(B, limbs, jnp.zeros_like(limbs))
    pack = lambda c: c[0::2] | (c[1::2] << jnp.uint32(16))
    layers = [pack(cur)]
    while cur.shape[1] > 1:
        cur = pos.poseidon_hash_pairs(B, cur[:, 0::2], cur[:, 1::2])
        layers.append(pack(cur))
    return tuple(layers)


def build_layers_digest(leaf_words, leaf_bytes: int, digest="blake2s"):
    """Digest-parameterized device layer builder (the reference's
    `H: Digest` type parameter, `merkle_tree.rs:60-73`, over device trees).
    Poseidon requires 32-byte value leaves (see `_build_layers_poseidon`)."""
    if digest == "blake2s":
        return _build_layers(leaf_words, leaf_bytes)
    if digest == "poseidon":
        assert leaf_bytes == 32, (
            "device poseidon trees need 32-byte canonical value leaves; "
            f"got {leaf_bytes} (the reference's PoseidonDigest caps input "
            "at 64 bytes and panics on non-canonical chunks, poseidon.rs:33)"
        )
        return _build_layers_poseidon(leaf_words)
    raise ValueError(f"unknown digest {digest!r}")


def commit_words(leaf_words, leaf_bytes: int) -> DeviceMerkleTree:
    """Build a blake2s tree from (W, N) device leaf words (W = 16*nblocks,
    zero-padded), keeping every layer on device."""
    n = leaf_words.shape[1]
    assert n & (n - 1) == 0, "power-of-two leaf count required"
    return DeviceMerkleTree(
        leaf_words, leaf_bytes, list(_build_layers(leaf_words, leaf_bytes))
    )


def commit_words_jit(leaf_words, leaf_bytes: int) -> DeviceMerkleTree:
    """`commit_words` with the whole layer fold in ONE compiled dispatch
    (the eager variant pays a dispatch per tree level). Per-shape cached
    executables via jit."""
    import jax

    n = leaf_words.shape[1]
    assert n & (n - 1) == 0, "power-of-two leaf count required"
    layers = jax.jit(_build_layers, static_argnums=1)(leaf_words, leaf_bytes)
    return DeviceMerkleTree(leaf_words, leaf_bytes, list(layers))


def _host_digest(digest: str):
    if digest == "blake2s":
        return blake
    if digest == "poseidon":
        from stark_tpu.ops.poseidon import poseidon_digest

        return poseidon_digest
    raise ValueError(f"unknown digest {digest!r}")


def validate_proof(
    proof: MerkleProof, root: bytes, index: int, digest: str = "blake2s"
) -> bytes:
    """Index-parity sibling walk (`merkle_tree.rs:25-43`); raises on failure."""
    h = _host_digest(digest)
    current = h(proof.leaf)
    t = index
    for node in proof.nodes:
        if t % 2 == 0:
            current = h(current + node)
        else:
            current = h(node + current)
        t //= 2
    if current != root:
        raise ValueError("merkle proof validation failed")
    return proof.leaf


def verify_multi_branch(
    root: bytes, indices, proofs: list[MerkleProof], digest: str = "blake2s"
) -> list[bytes]:
    # merkle_tree.rs:46-58
    return [validate_proof(p, root, int(i), digest) for i, p in zip(indices, proofs)]
