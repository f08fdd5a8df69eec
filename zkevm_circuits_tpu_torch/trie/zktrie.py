"""Sparse Poseidon-Merkle trie (zktrie), port of
zkevm_circuits_tpu/trie/zktrie.py: its pure-Python backend only.

Equivalent of the reference's `zktrie` wrapper crate over Scroll's Go
zktrie library (reference zktrie/src/state.rs:16-156): the
Poseidon-hashed sparse binary Merkle trie holding account/storage state,
producing the MPT update witness.

Scheme: empty = 0; leaf = H_1(key, value); branch = H_2(left, right) where
H_d = permute([d, a, b])[0]; path bits are the little-endian bits of the
key field element; the trie is compressed (leaves sit at the first
divergence depth).

This backend differs from the JAX package's Python backend in speed only:
each node caches its hash, and an update clears the caches along the
path it walks, so `root()` and `prove()` rehash only that path instead of
the whole trie; and `hash2_domain` remembers its last 2^18 results,
since the MPT witness and circuit hash each node of a path several times
(trie, Poseidon events, circuit rows).  Roots, proofs and siblings are
the same integers.  The JAX package also binds a C++ trie through ctypes;
the port loads no native library, so `ZkTrie(use_native=True)` raises.
"""

from __future__ import annotations

import dataclasses
import functools

from ..crypto.params import FR_MODULUS as P
from ..crypto.poseidon import permute

DOM_LEAF = 1
DOM_BRANCH = 2
MAX_DEPTH = 256


@functools.lru_cache(maxsize=1 << 18)
def hash2_domain(domain: int, a: int, b: int) -> int:
    return permute([domain, a, b])[0]


@dataclasses.dataclass
class Proof:
    """Merkle path for `key` from the root: `siblings` top-down, plus the
    terminal leaf (absent => non-inclusion at an empty slot)."""

    key: int
    depth: int
    siblings: list[int]
    found: bool
    leaf_key: int
    leaf_value: int


class _PyNode:
    __slots__ = ("kind", "key", "value", "left", "right", "cached")

    def __init__(self):
        self.kind = 0  # 0 empty, 1 leaf, 2 branch
        self.key = 0
        self.value = 0
        self.left = None
        self.right = None
        self.cached = None  # this node's hash, None until computed

    def hash(self) -> int:
        if self.cached is None:
            if self.kind == 0:
                self.cached = 0
            elif self.kind == 1:
                self.cached = hash2_domain(DOM_LEAF, self.key, self.value)
            else:
                l = self.left.hash() if self.left else 0  # noqa: E741
                r = self.right.hash() if self.right else 0
                self.cached = hash2_domain(DOM_BRANCH, l, r)
        return self.cached


class ZkTrie:
    """update(key, value) / root() / prove(key) over int field elements."""

    def __init__(self, use_native: bool | None = None):
        if use_native:
            raise ValueError(
                "the port loads no native library: use ZkTrie() (Python backend)"
            )
        self._root = _PyNode()

    # ------------------------------------------------------------------
    def update(self, key: int, value: int):
        key %= P
        value %= P
        self._insert(self._root, key, value, 0)

    def _insert(self, node: _PyNode, key: int, value: int, depth: int):
        node.cached = None  # on the updated path
        if node.kind == 0:
            node.kind = 1
            node.key, node.value = key, value
            return
        if node.kind == 1:
            if node.key == key:
                node.value = value
                return
            old = _PyNode()
            old.kind, old.key, old.value = 1, node.key, node.value
            node.kind = 2
            node.left, node.right = _PyNode(), _PyNode()
            if (old.key >> depth) & 1:
                node.right = old
            else:
                node.left = old
            nxt = node.right if (key >> depth) & 1 else node.left
            self._insert(nxt, key, value, depth + 1)
            return
        nxt = node.right if (key >> depth) & 1 else node.left
        self._insert(nxt, key, value, depth + 1)

    def root(self) -> int:
        return self._root.hash()

    def prove(self, key: int) -> Proof:
        key %= P
        node, d, sibs = self._root, 0, []
        while node.kind == 2 and d < MAX_DEPTH:
            if (key >> d) & 1:
                sibs.append(node.left.hash() if node.left else 0)
                node = node.right
            else:
                sibs.append(node.right.hash() if node.right else 0)
                node = node.left
            d += 1
        if node.kind == 1:
            return Proof(key, d, sibs, True, node.key, node.value)
        return Proof(key, d, sibs, False, 0, 0)


def verify_proof(root: int, proof: Proof) -> bool:
    """Recompute the root from the proof.  Inclusion: leaf_key must equal
    the queried key; non-inclusion: empty slot or a DIFFERENT leaf whose
    path prefix collides (proves the queried key is absent)."""
    if proof.found:
        acc = hash2_domain(DOM_LEAF, proof.leaf_key, proof.leaf_value)
    else:
        acc = 0
    for d in reversed(range(proof.depth)):
        sib = proof.siblings[d]
        if (proof.key >> d) & 1:
            acc = hash2_domain(DOM_BRANCH, sib, acc)
        else:
            acc = hash2_domain(DOM_BRANCH, acc, sib)
    return acc == root
