"""The port's copy of ``crypto/merkle`` against the JAX package's.

Roots, inclusion proofs and ``Proof.verify`` round trips, byte for byte,
at every leaf count from 0 to 129 and at the SHA-256 block-edge leaf
lengths (54-56, 63-65, 118-120 bytes, where the 0x00-prefixed padded
message grows a block).  The leaves come from a numpy seed.
"""

import numpy as np
import pytest

from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu_torch.crypto import merkle as tmerkle

EDGE_LENS = (0, 1, 31, 32, 54, 55, 56, 63, 64, 65, 118, 119, 120)


def leaves(n: int, seed: int = 7, lens=EDGE_LENS) -> "list[bytes]":
    rng = np.random.default_rng(seed + n)
    return [rng.bytes(lens[i % len(lens)]) for i in range(n)]


def _proof_fields(p):
    return (p.total, p.index, p.leaf_hash, list(p.aunts))


@pytest.mark.parametrize("n", range(130))
def test_root_and_proofs_equal_jax(n):
    items = leaves(n)
    root = tmerkle.hash_from_byte_slices(items)
    assert root == jmerkle.hash_from_byte_slices(items)
    troot, tproofs = tmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert troot == jroot == root
    assert [_proof_fields(p) for p in tproofs] == [_proof_fields(p) for p in jproofs]
    for i in {0, n // 2, n - 1} if n else ():
        assert tproofs[i].verify(root, items[i])
        assert not tproofs[i].verify(root, items[i] + b"\x00")


@pytest.mark.parametrize("length", EDGE_LENS)
def test_block_edge_leaf_lengths(length):
    items = leaves(5, seed=length, lens=(length,))
    assert tmerkle._leaf_hash(items[0]) == jmerkle._leaf_hash(items[0])
    assert tmerkle.hash_from_byte_slices(items) == jmerkle.hash_from_byte_slices(items)


def test_split_point_and_inner_hash():
    for n in range(2, 300):
        assert tmerkle._split_point(n) == jmerkle._split_point(n)
    a, b = b"\x01" * 32, b"\x02" * 32
    assert tmerkle._inner_hash(a, b) == jmerkle._inner_hash(a, b)
