"""The SHA-256 tree plane of the port (``ops/sha256_tree.py``) against the
JAX package's ``ops/sha256_tree.py`` and ``crypto/merkle``.

* The plain version (``leaf_core`` / ``layer_core``: the kernel's
  arithmetic in int64 words) equals the JAX ``_leaf_fn`` / ``_layer_fn``,
  called eagerly (never through ``device_levels``, which reads the shared
  executable cache), word for word, at 8-16 lanes with odd valid
  prefixes.
* ``tree_root(items, device="cpu")`` equals ``merkle.hash_from_byte_slices``
  at 33-129 leaves and on the block-edge lengths; every level of the plain
  version's words equals the JAX package's ``host_levels``.
* The routing: the JAX bucket rules, oversize sets to the host, the trust
  gate (closed without a card and with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``),
  the plane's size gate and kill switch, and the per-tier counters.
* The card's rule, with ``device_root`` (the device pass) patched: a
  failed or malformed tree pass counts against the ``merkle_device``
  breaker, logs a WARNING and raises ``BackendError``; on the CPU the host
  answers, visibly.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import sha256_tree as jtree
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import sha256_tree as ttree
from cometbft_tpu_torch.proofserve import plane as tplane

from test_torch_cuda_sha256 import levels_of
from test_torch_merkle import EDGE_LENS, leaves


@pytest.fixture(autouse=True)
def _clean():
    tds.reset()
    tbh.reset()
    yield
    tds.reset()
    tbh.reset()


def _plain_levels(items):
    return levels_of(ttree.tree_words_plain(*ttree.pack_leaves(items)), len(items))


def _jax_leaves(items, lanes):
    """The JAX leaf program run eagerly: under ``disable_jit`` its
    ``lax.scan`` is a Python loop of eager ops (XLA on the CPU takes
    minutes to compile the unrolled rounds)."""
    _, blocks = jtree._bucket_shape(items)
    words, nblk = jtree._pack_leaves(items, lanes, blocks)
    with jax.disable_jit():
        return np.asarray(jtree._leaf_fn(jnp.asarray(words), jnp.asarray(nblk)))


@pytest.mark.parametrize("n,lanes,lens", [
    (5, 8, (3, 54, 55, 119, 0)),
    (13, 16, EDGE_LENS),
])
def test_leaf_core_equals_jax_leaf_fn(n, lanes, lens):
    items = leaves(n, seed=lanes, lens=lens)
    want = _jax_leaves(items, lanes)[:n].astype(np.int64)
    got = ttree.leaf_core(*ttree.pack_leaves(items)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,lanes", [(3, 8), (7, 8), (8, 8), (13, 16)])
def test_layer_core_equals_jax_layer_fn(k, lanes):
    rng = np.random.default_rng(100 + k)
    digests = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64).astype(np.uint32)
    digests[k:] = 0
    with jax.disable_jit():
        want = np.asarray(jtree._layer_fn(jnp.asarray(digests), jnp.int32(k)))
    got = ttree.layer_core(torch.from_numpy(digests[:k].astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want[: (k + 1) // 2].astype(np.int64))


@pytest.mark.parametrize("n", [33, 64, 65, 100, 129])
def test_tree_root_on_the_plain_version_equals_merkle(n):
    items = leaves(n)
    assert _plain_levels(items) == jtree.host_levels(items)
    assert ttree.tree_root(items, device="cpu") == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["torch"] == (1, n)


@pytest.mark.parametrize("length", EDGE_LENS)
def test_block_edge_lengths(length):
    items = leaves(9, seed=length, lens=(length,))
    assert _plain_levels(items) == jtree.host_levels(items)


def test_small_sets_and_words():
    assert ttree.tree_root([], device="cpu") == ttree.EMPTY_HASH == tmerkle.hash_from_byte_slices([])
    one = [b"only"]
    assert ttree.tree_root(one, device="cpu") == tmerkle._leaf_hash(b"only")
    for n in (1, 2, 3, 8, 9, 31):
        items = leaves(n)
        words = ttree.tree_words_plain(*ttree.pack_leaves(items))
        assert words.dtype == torch.int32 and words.shape == (sum(ttree.level_sizes(n)), 8)
        assert levels_of(words, n) == jtree.host_levels(items)


def test_bucket_rules_equal_jax():
    sets = [leaves(1), leaves(40), [b"x" * 65000] * 3, [b"x" * 66000],
            [b"y"] * 16384, [b"y"] * 16385, [b"z" * 2030] * 16384,
            [b"z" * 2040] * 16384]
    for items in sets:
        assert ttree._bucket_shape(items) == jtree._bucket_shape(items)


def test_oversize_goes_to_the_host_and_is_counted():
    items = [b"a" * 70000] + leaves(40)
    assert ttree.tree_root(items, device="cpu") == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["host"] == (1, 41)
    assert tds.tier_counts("merkle_oversize")["host"] == (1, 41)
    assert tds.tier_counts("merkle")["torch"] == (0, 0)


def test_gate_closed_without_a_card(monkeypatch):
    """No self-check has passed: a validator-set-sized tree with no device
    named is hashed on the host, and nothing touches CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = leaves(40)
    assert not ttree.device_active()
    assert tplane.tree_hash(items) == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["host"] == (1, 40)
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda:0"})  # a trusted card
    assert ttree.device_active()
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert not ttree.device_active()


def test_plane_size_gate_and_kill_switch(monkeypatch):
    items = leaves(31)
    assert tplane.tree_hash(items) == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["host"] == (0, 0)  # never reached the plane
    monkeypatch.setenv("COMETBFT_TPU_MERKLE_MIN_BATCH", "64")
    assert tplane.min_batch() == 64
    monkeypatch.setenv("COMETBFT_TPU_PROOFSERVE", "0")
    assert not tplane.enabled()
    assert tplane.tree_hash(leaves(40)) == tmerkle.hash_from_byte_slices(leaves(40))
    assert tds.tier_counts("merkle")["host"] == (0, 0)


def _malformed(items, device=None):
    return b"\x00" * 31


def _raises(items, device=None):
    raise RuntimeError("injected: the tree kernel failed")


@pytest.fixture
def stand_in_card(monkeypatch):
    """The trust gate open (a card passed the self-check), so a pass with
    no device named goes to the card; returns a function that installs a
    stand-in for the device pass."""
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda:0"})

    def install(fn):
        monkeypatch.setattr(ttree, "device_root", fn)

    return install


def _host_root(items, device=None):
    return tmerkle.hash_from_byte_slices(items)


@pytest.mark.parametrize("runner", [_raises, _malformed])
def test_card_failure_raises_and_counts_against_the_breaker(runner, caplog,
                                                            stand_in_card):
    """On a card (no device named, a stand-in in place of the kernel's
    pass) a failed or malformed pass raises BackendError: no host
    answers."""
    stand_in_card(runner)
    items = leaves(40)
    with caplog.at_level(logging.WARNING):
        with pytest.raises(tbh.BackendError):
            ttree.tree_root(items)
    br = tbh.registry().breaker(ttree.BREAKER).stats()
    assert br["consecutive_failures"] == 1 and ttree.BREAKER == "merkle_device"
    assert any("merkle_device" in r.getMessage() for r in caplog.records)
    assert all(c == (0, 0) for c in tds.tier_counts("merkle").values())


def test_card_pass_on_the_runner_seam_is_counted_as_cuda(stand_in_card):
    stand_in_card(_host_root)
    items = leaves(40)
    assert ttree.tree_root(items) == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["cuda"] == (1, 40)


def test_named_cpu_device_ignores_the_open_gate(stand_in_card):
    """A caller that names the CPU gets the plain version, gate or no
    gate: no pass is recorded on the card."""
    assert ttree.device_active()
    items = leaves(40)
    assert ttree.tree_root(items, device="cpu") == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["torch"] == (1, 40)
    assert tds.tier_counts("merkle")["cuda"] == (0, 0)


def test_cpu_failure_is_answered_by_the_host(caplog, monkeypatch):
    monkeypatch.setattr(ttree, "device_root", _raises)
    items = leaves(40)
    with caplog.at_level(logging.WARNING):
        assert ttree.tree_root(items, device="cpu") == tmerkle.hash_from_byte_slices(items)
    assert tds.tier_counts("merkle")["host"] == (1, 40)
    assert any("host fallback" in r.getMessage() for r in caplog.records)
