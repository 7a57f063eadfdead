"""The hand-written SHA-256 Merkle tree kernel
(cometbft_tpu_torch/csrc/sha256_tree.cu).

Without a card the kernel cannot run, but the source also builds for the
host (no ``__CUDACC__``), running the kernel's block schedule in turn:
each chunk of C leaves, its levels, then the last block's pass over the
chunk roots.  So its compression, its in-kernel padding (the block-edge
leaf lengths), its odd-tail promotion, its chunk edges and its ticket are
held here against ``hashlib`` and ``crypto/merkle``, level by level, and
``-DSHA256_TALLY`` counts the sm_90 integer instructions of its
compressions (one per helper: SHF, LOP3, IADD3, IADD) for the roofline
bound.  A second build with C = 8 gives the last block more chunk roots
than threads.  The tests marked ``cuda`` run the kernel against its plain
PyTorch version and skip where there is no card.
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

# Leaf counts at the edges of the kernel's chunks, as functions of C
CHUNK_EDGES = {
    "1": lambda c: 1,
    "C-1": lambda c: c - 1,
    "C": lambda c: c,
    "C+1": lambda c: c + 1,
    "2C+1": lambda c: 2 * c + 1,
    "4C-1": lambda c: 4 * c - 1,
    "16384": lambda c: 16384,
}


def _bind(lib):
    lib.sha256_tree_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.sha256_tree_host.restype = ctypes.c_int
    lib.sha256_tree_chunk.restype = ctypes.c_int
    lib.sha256_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _bind(host_build(tmp_path_factory, SRC, "-DSHA256_TALLY"))


@pytest.fixture(scope="module")
def host_lib8(tmp_path_factory):
    return _bind(host_build(tmp_path_factory, SRC, "-DSHA256_TALLY",
                            "-DSHA256_CHUNK=8"))


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
    """Every level of the tree as the host build's block schedule computes
    it, as bytes; the ticket is back at 0 after it."""
    data, offs = (t.numpy() for t in ttree.pack_leaves(items))
    data = np.ascontiguousarray(data) if data.size else np.zeros(1, np.uint8)
    out = np.zeros((sum(ttree.level_sizes(len(items))), 8), np.uint32)
    ticket = lib.sha256_tree_host(data.ctypes.data, offs.ctypes.data,
                                  len(items), out.ctypes.data)
    assert ticket == 0
    return levels_of(torch.from_numpy(out.view(np.int32)), len(items))


def _check_levels_and_tally(lib, items):
    """Every level, odd tails promoted, equals the host oracle; the
    operations counted are the wrapper's compressions times its per-
    compression constant (the roofline bound's work)."""
    _tally(lib)
    levels = _host_levels(lib, items)
    assert levels == oracle_levels(items)
    assert levels[-1][0] == tmerkle.hash_from_byte_slices(items)
    comps, ops = _tally(lib)
    assert comps == tcs.compressions([len(it) for it in items])
    assert ops == comps * tcs.OPS_PER_COMPRESSION


@pytest.mark.parametrize("length", EDGE_LENS + (200, 1000))
def test_leaf_padding_and_compression_match_hashlib(host_lib, length):
    items = leaves(3, seed=length, lens=(length,))
    _tally(host_lib)
    got = _host_levels(host_lib, items)[0]
    assert got == [hashlib.sha256(b"\x00" + it).digest() for it in items]


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 31, 32, 33, 63, 65, 127, 129])
def test_levels_match_merkle_and_the_tally(host_lib, n):
    _check_levels_and_tally(host_lib, leaves(n))


@pytest.mark.parametrize("edge", CHUNK_EDGES)
def test_chunk_edges_match_merkle_and_the_tally(host_lib, edge):
    """At the edges of the kernel's chunks (one block, one block and a
    leaf, a partial last chunk) every level lands on the rows of
    ``level_sizes``, odd tails where ``layer_core`` puts them."""
    n = CHUNK_EDGES[edge](host_lib.sha256_tree_chunk())
    _check_levels_and_tally(host_lib, leaves(n))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 63, 64, 65, 129, 520])
def test_more_chunk_roots_than_threads(host_lib8, n):
    """C = 8: past 64 leaves the last block reduces the chunk roots C at a
    time, level by level, as it does past C * C leaves at full size."""
    assert host_lib8.sha256_tree_chunk() == 8
    _check_levels_and_tally(host_lib8, leaves(n))


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
@pytest.mark.parametrize(
    "n", [1, 2, 3, 8, 9, 31, 32, 33, 63, 65, 127, 129, 1000, *CHUNK_EDGES])
def test_kernel_matches_plain_and_merkle(card, n):
    if isinstance(n, str):
        n = CHUNK_EDGES[n](tcs.occupancy()["threads"])
    items = leaves(n)
    data, offs = ttree.pack_leaves(items, card)
    before = tcs.launches
    kern = tcs.tree_words(data, offs)
    torch.cuda.synchronize()
    assert tcs.launches - before == 1
    assert torch.equal(kern, ttree.tree_words_plain(data, offs))
    levels = levels_of(kern, n)
    assert levels == oracle_levels(items)
    assert levels[-1][0] == tmerkle.hash_from_byte_slices(items)


@pytest.mark.cuda
def test_ticket_leaves_no_state_behind(card):
    """Trees back to back with no synchronisation between them, one-block
    trees among them, then the same trees on two streams at once: each
    equals its plain version, and every ticket is back at 0."""
    c = tcs.occupancy()["threads"]
    sizes = [3 * c + 5, 10, 2 * c + 1, c, 16384, 1, 1000]
    packed = [ttree.pack_leaves(leaves(n, seed=i), card)
              for i, n in enumerate(sizes)]
    want = [ttree.tree_words_plain(d, o) for d, o in packed]
    got = [tcs.tree_words(d, o) for d, o in packed]
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for i, (d, o) in enumerate(packed * 2):
        with torch.cuda.stream(s1 if i % 2 == 0 else s2):
            got.append(tcs.tree_words(d, o))
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(sizes)]), f"tree {i}"
    dev = torch.cuda.current_device()
    assert {(dev, s1.cuda_stream), (dev, s2.cuda_stream)} <= set(tcs._tickets)
    assert all(int(t) == 0 for t in tcs._tickets.values())


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
