"""RFC 6962 Merkle trees (reference: crypto/merkle/{tree,hash,proof}.go).

The port's own copy of the JAX package's ``crypto/merkle.py``: host only,
the oracle of the SHA-256 tree kernel (``ops/sha256_tree.py``).

Leaf hash = SHA-256(0x00 || leaf); inner hash = SHA-256(0x01 || left || right).
Empty tree hashes to SHA-256("").  The split point for n leaves is the largest
power of two strictly less than n.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Sequence

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + leaf).digest()


def _inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(INNER_PREFIX + left + right).digest()


def _split_point(n: int) -> int:
    """Largest power of two < n."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root of a list of byte slices (reference: crypto/merkle/tree.go:11).

    Iterative bottom-up construction equivalent to the recursive RFC 6962
    definition (the reference optimizes the same way, tree.go:68)."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    level = [_leaf_hash(it) for it in items]
    # Reduce respecting the split-point structure: recursion on sizes.
    def reduce(lo: int, hi: int) -> bytes:
        cnt = hi - lo
        if cnt == 1:
            return level[lo]
        k = _split_point(cnt)
        return _inner_hash(reduce(lo, lo + k), reduce(lo + k, hi))

    return reduce(0, n)


@dataclass
class Proof:
    """Merkle inclusion proof (reference: crypto/merkle/proof.go)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if _leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = _compute_root(self.leaf_hash, self.index, self.total, self.aunts)
        return computed == root


def _compute_root(leaf_hash: bytes, index: int, total: int, aunts: list[bytes]):
    if total == 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf_hash
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_root(leaf_hash, index, k, aunts[:-1])
        if left is None:
            return None
        return _inner_hash(left, aunts[-1])
    right = _compute_root(leaf_hash, index - k, total - k, aunts[:-1])
    if right is None:
        return None
    return _inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]) -> tuple[bytes, list[Proof]]:
    """Root plus an inclusion proof per item."""
    n = len(items)
    leaves = [_leaf_hash(it) for it in items]
    if n == 0:
        return hashlib.sha256(b"").digest(), []

    proofs: list[list[bytes]] = [[] for _ in range(n)]

    def build(lo: int, hi: int) -> bytes:
        cnt = hi - lo
        if cnt == 1:
            return leaves[lo]
        k = _split_point(cnt)
        left = build(lo, lo + k)
        right = build(lo + k, hi)
        for i in range(lo, lo + k):
            proofs[i].append(right)
        for i in range(lo + k, hi):
            proofs[i].append(left)
        return _inner_hash(left, right)

    root = build(0, n)
    # aunts are accumulated leaf-level-first; _compute_root consumes the
    # root-level aunt from the tail, so the order is already correct.
    return root, [
        Proof(total=n, index=i, leaf_hash=leaves[i], aunts=proofs[i])
        for i in range(n)
    ]
