"""The hand-written SHA-256 Merkle tree kernels
(cometbft_tpu_torch/csrc/sha256_tree.cu).

Without a card the kernels cannot run, but the source also builds for the
host (no ``__CUDACC__``): one leaf, then one parent, after another.  So
its compression, its in-kernel padding (the block-edge leaf lengths) and
its odd-tail promotion are held here against ``hashlib`` and
``crypto/merkle``, and ``-DSHA256_TALLY`` counts the sm_90 integer
instructions of its compressions (one per helper: SHF, LOP3, IADD3, IADD)
for the roofline bound.  The tests marked ``cuda`` run the
kernels against their plain PyTorch version and skip where there is no
card.
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import cuda_sha256 as tcs
from cometbft_tpu_torch.ops import sha256_tree as ttree

from test_torch_cuda_verify import host_build
from test_torch_merkle import EDGE_LENS, leaves

SRC = _build.CSRC_DIR / "sha256_tree.cu"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = host_build(tmp_path_factory, SRC, "-DSHA256_TALLY")
    lib.sha256_leaf_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.sha256_layer_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.sha256_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    return lib


def _tally(lib):
    c, o = ctypes.c_longlong(), ctypes.c_longlong()
    lib.sha256_tally(ctypes.byref(c), ctypes.byref(o))
    return c.value, o.value


def oracle_levels(items):
    """Every level of the tree from ``crypto/merkle``'s leaf and inner
    hashes: adjacent pairs, the odd tail promoted."""
    level = [tmerkle._leaf_hash(it) for it in items]
    levels = [level]
    while len(level) > 1:
        nxt = [tmerkle._inner_hash(level[j], level[j + 1])
               for j in range(0, len(level) - 1, 2)]
        level = nxt + level[len(nxt) * 2:]
        levels.append(level)
    return levels


def levels_of(words, n):
    """The digests of a tree's words (every level, leaves first) as bytes."""
    raw = words.cpu().numpy().astype(np.uint32).astype(">u4").tobytes()
    levels, o = [], 0
    for k in ttree.level_sizes(n):
        levels.append([raw[32 * i : 32 * i + 32] for i in range(o, o + k)])
        o += k
    return levels


def _host_levels(lib, items):
    """Every level of the tree as the host build computes it, as bytes."""
    data, offs = (t.numpy() for t in ttree.pack_leaves(items))
    data = np.ascontiguousarray(data) if data.size else np.zeros(1, np.uint8)
    level = np.zeros((len(items), 8), np.uint32)
    lib.sha256_leaf_host(data.ctypes.data, offs.ctypes.data, len(items),
                         level.ctypes.data)
    levels = [level]
    while len(level) > 1:
        up = np.zeros(((len(level) + 1) // 2, 8), np.uint32)
        lib.sha256_layer_host(np.ascontiguousarray(level).ctypes.data, len(level),
                              up.ctypes.data)
        level = up
        levels.append(level)
    return [[row.astype(">u4").tobytes() for row in lv] for lv in levels]


@pytest.mark.parametrize("length", EDGE_LENS + (200, 1000))
def test_leaf_padding_and_compression_match_hashlib(host_lib, length):
    items = leaves(3, seed=length, lens=(length,))
    _tally(host_lib)
    got = _host_levels(host_lib, items)[0]
    assert got == [hashlib.sha256(b"\x00" + it).digest() for it in items]


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 31, 32, 33, 63, 65, 127, 129])
def test_levels_match_merkle_and_the_tally(host_lib, n):
    """Every level, odd tails promoted, equals the host oracle; the
    operations counted are the wrapper's compressions times its per-
    compression constant (the roofline bound's work)."""
    items = leaves(n)
    _tally(host_lib)
    levels = _host_levels(host_lib, items)
    assert levels == oracle_levels(items)
    assert levels[-1][0] == tmerkle.hash_from_byte_slices(items)
    comps, ops = _tally(host_lib)
    assert comps == tcs.compressions([len(it) for it in items])
    assert ops == comps * tcs.OPS_PER_COMPRESSION


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    items = leaves(20)
    before = tcs.launches
    words = tcs.tree_words(*ttree.pack_leaves(items))
    assert tcs.launches == before  # no kernel on the CPU
    assert torch.equal(words, ttree.tree_words_plain(*ttree.pack_leaves(items)))
    with pytest.raises(ValueError):
        tcs.tree_words(torch.zeros(3, dtype=torch.int32), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tcs.tree_words(torch.zeros(3, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 31, 32, 33, 63, 65, 127, 129, 1000])
def test_kernel_matches_plain_and_merkle(card, n):
    items = leaves(n)
    data, offs = ttree.pack_leaves(items, card)
    before = tcs.launches
    kern = tcs.tree_words(data, offs)
    torch.cuda.synchronize()
    assert tcs.launches - before == len(ttree.level_sizes(n))
    assert torch.equal(kern, ttree.tree_words_plain(data, offs))
    levels = levels_of(kern, n)
    assert levels == oracle_levels(items)
    assert levels[-1][0] == tmerkle.hash_from_byte_slices(items)


@pytest.mark.cuda
@pytest.mark.parametrize("length", EDGE_LENS)
def test_kernel_block_edge_lengths(card, length):
    items = leaves(9, seed=length, lens=(length,))
    assert ttree.device_root(items, card) == tmerkle.hash_from_byte_slices(items)
    assert levels_of(tcs.tree_words(*ttree.pack_leaves(items, card)), 9) == \
        oracle_levels(items)


@pytest.mark.cuda
def test_kernel_rejects_malformed_inputs(card):
    data, offs = ttree.pack_leaves(leaves(4), card)
    with pytest.raises(ValueError):
        tcs.tree_words(data.int(), offs)
    with pytest.raises(ValueError):
        tcs.tree_words(data, offs.int())
    with pytest.raises(ValueError):
        tcs.tree_words(data, offs.cpu())
