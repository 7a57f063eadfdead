"""The port's signature cache (``cometbft_tpu_torch/crypto/sigcache.py``)
and its prefilter in the batch verifiers: the cases of the JAX package's
``tests/test_sigcache.py`` (LRU bound, key framing, kill switch, thread
hammer, prefilter, structural garbage) run against the port, plus the
port's own rules: a commit verified once makes no backend call the second
time, an infrastructure failure caches nothing and never becomes a False
bit, and a bad commit's negative verdicts do not poison the good commit.
"""

import hashlib
import sys
import threading

import pytest

from cometbft_tpu.crypto import sigcache as jsigcache
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import verify as tov
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types.basic import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    PartSetHeader,
    Timestamp,
)
from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import CommitSig

from test_torch_commit import CHAIN, HEIGHT, _jax_commit


@pytest.fixture(autouse=True)
def fresh_cache():
    sigcache.reset_cache()
    yield
    sigcache.reset_cache()


def _keypair(tag: bytes):
    priv = Ed25519PrivKey.from_seed(hashlib.sha256(tag).digest())
    return priv, priv.pub_key()


def _entries(n, tamper=()):
    privs = [_keypair(b"bv%d" % i)[0] for i in range(n)]
    pubs = [p.pub_key() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in tamper:
        sigs[i] = sigs[i][:32] + bytes([sigs[i][32] ^ 1]) + sigs[i][33:]
    return pubs, msgs, sigs


def _port_commit(bad=()):
    """The 16-validator commit of the commit tests, carried into the port;
    ``bad`` indices get a flipped signature bit."""
    vals, commit, block_id = _jax_commit(bad=bad)
    return (
        convert.validator_set_from(vals),
        convert.commit_from(commit),
        convert.block_id_from(block_id),
    )


def test_put_get_roundtrip_and_stats():
    c = sigcache.SigCache(capacity=8)
    assert c.get(b"p", b"m", b"s") is None
    c.put(b"p", b"m", b"s", True)
    c.put(b"p", b"m2", b"s", False)
    assert c.get(b"p", b"m", b"s") is True
    assert c.get(b"p", b"m2", b"s") is False  # negative caching
    st = c.stats()
    assert st["hits"] == 2 and st["misses"] == 1 and st["size"] == 2
    assert 0 < st["hit_rate"] < 1
    c.clear()
    assert len(c) == 0 and c.stats()["hits"] == 0


def test_lru_bound_evicts_oldest():
    c = sigcache.SigCache(capacity=3)
    for i in range(4):
        c.put(b"p%d" % i, b"m", b"s", True)
    assert len(c) == 3
    assert c.get(b"p0", b"m", b"s") is None  # evicted
    assert c.get(b"p3", b"m", b"s") is True
    # access refreshes recency: p1 survives the next insert, p2 doesn't
    assert c.get(b"p1", b"m", b"s") is True
    c.put(b"p4", b"m", b"s", True)
    assert c.get(b"p2", b"m", b"s") is None
    assert c.get(b"p1", b"m", b"s") is True


def test_key_is_unambiguous_across_field_boundaries():
    c = sigcache.SigCache()
    c.put(b"ab", b"c", b"s", True)  # same concatenation, different split
    assert c.get(b"a", b"bc", b"s") is None


@pytest.mark.parametrize(
    "triple",
    [(b"", b"", b""), (b"p" * 32, b"m" * 120, b"s" * 64), (b"ab", b"c", b"s")],
)
def test_key_matches_jax(triple):
    assert sigcache._key(*triple) == jsigcache._key(*triple)


def test_kill_switch_disables_lookup_and_insert(monkeypatch):
    c = sigcache.SigCache()
    c.put(b"p", b"m", b"s", True)
    monkeypatch.setenv("COMETBFT_TPU_SIGCACHE", "0")
    assert c.get(b"p", b"m", b"s") is None
    c.put(b"p2", b"m", b"s", True)
    monkeypatch.delenv("COMETBFT_TPU_SIGCACHE")
    assert c.get(b"p", b"m", b"s") is True  # old entry intact
    assert c.get(b"p2", b"m", b"s") is None  # disabled put dropped


def test_size_variable_bounds_the_process_cache(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_SIGCACHE_SIZE", "5")
    sigcache.reset_cache()
    assert sigcache.get_cache().capacity == 5
    assert sigcache.get_cache() is sigcache.get_cache()


def test_thread_safety_hammer():
    c = sigcache.SigCache(capacity=64)
    errors = []

    def worker(t):
        try:
            for i in range(300):
                c.put(b"p%d" % (i % 97), b"m%d" % t, b"s", i % 2 == 0)
                c.get(b"p%d" % ((i + t) % 97), b"m%d" % t, b"s")
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert len(c) <= 64
    st = c.stats()
    assert st["hits"] + st["misses"] == 12 * 300  # no lost update


def test_verify_with_cache_caches_both_verdicts():
    priv, pub = _keypair(b"vwc")
    msg = b"hello"
    sig = priv.sign(msg)
    bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    assert sigcache.verify_with_cache(pub, msg, sig) is True
    assert sigcache.verify_with_cache(pub, msg, bad) is False
    st = sigcache.get_cache().stats()
    assert st["misses"] == 2 and st["size"] == 2
    assert sigcache.verify_with_cache(pub, msg, sig) is True
    assert sigcache.verify_with_cache(pub, msg, bad) is False
    assert sigcache.get_cache().stats()["hits"] == 2


def test_cpu_verifier_prefilters_hits():
    pubs, msgs, sigs = _entries(4, tamper=(2,))
    bv = cbatch.CpuBatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    ok, bits = bv.verify()
    assert not ok and bits == [True, True, False, True]
    bv2 = cbatch.CpuBatchVerifier()
    calls = []
    bv2._verify_pending = lambda *a: calls.append(a) or []
    for p, m, s in zip(pubs, msgs, sigs):
        bv2.add(p, m, s)
    assert bv2.verify() == (ok, bits)
    assert not calls  # everything resolved from cache


def test_structural_garbage_never_reaches_backend():
    pubs, msgs, sigs = _entries(3)
    bv = cbatch.CpuBatchVerifier()
    bv.add(pubs[0], msgs[0], sigs[0])
    bv.add(b"\x01" * 7, msgs[1], sigs[1])  # impossible pub length
    bv.add(pubs[2], msgs[2], b"short")  # impossible sig length
    shipped = []
    real = bv._verify_pending
    bv._verify_pending = lambda p, m, s: shipped.extend(p) or real(p, m, s)
    ok, bits = bv.verify()
    assert not ok and bits == [True, False, False]
    assert shipped == [pubs[0].bytes()]


def test_kill_switch_restores_uncached_behavior(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_SIGCACHE", "0")
    pubs, msgs, sigs = _entries(3, tamper=(1,))
    for _ in range(2):  # no memoization across passes
        bv = cbatch.CpuBatchVerifier()
        shipped = []
        real = bv._verify_pending
        bv._verify_pending = lambda p, m, s: shipped.extend(p) or real(p, m, s)
        for p, m, s in zip(pubs, msgs, sigs):
            bv.add(p, m, s)
        ok, bits = bv.verify()
        assert not ok and bits == [True, False, True]
        assert len(shipped) == 3  # every entry verified, every time
    assert len(sigcache.get_cache()) == 0


def test_backend_failure_caches_nothing():
    pubs, msgs, sigs = _entries(3)
    bv = cbatch.CpuBatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)

    def broken(*_):
        raise RuntimeError("device lost")

    bv._verify_pending = broken
    with pytest.raises(RuntimeError, match="device lost"):
        bv.verify()
    assert len(sigcache.get_cache()) == 0


def test_missing_verdict_raises_and_is_not_cached():
    """A backend that answers for only some entries: an error, never a
    False bit, and only the definitive verdicts are cached."""
    pubs, msgs, sigs = _entries(3)
    bv = cbatch.CpuBatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    bv._verify_pending = lambda p, m, s: [True, None, True]
    with pytest.raises(cbatch.BackendError):
        bv.verify()
    assert len(sigcache.get_cache()) == 2
    bv2 = cbatch.CpuBatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv2.add(p, m, s)
    bv2._verify_pending = lambda p, m, s: []  # short answer: a hole again
    with pytest.raises(cbatch.BackendError):
        bv2.verify()


def _count_pending(monkeypatch, cls):
    shipped = []
    real = cls._verify_pending
    monkeypatch.setattr(
        cls,
        "_verify_pending",
        lambda self, p, m, s: shipped.append(len(p)) or real(self, p, m, s),
    )
    return shipped


def test_second_cpu_commit_makes_no_backend_call(monkeypatch):
    vals, commit, block_id = _port_commit()
    shipped = _count_pending(monkeypatch, cbatch.CpuBatchVerifier)
    tval.verify_commit(CHAIN, vals, block_id, HEIGHT, commit, backend="cpu")
    assert shipped == [16]
    tval.verify_commit(CHAIN, vals, block_id, HEIGHT, commit, backend="cpu")
    tval.verify_commit_light(CHAIN, vals, block_id, HEIGHT, commit, backend="cpu")
    assert shipped == [16]  # the second commit and the light one: all hits
    assert sigcache.get_cache().stats()["hits"] >= 16


def test_second_gpu_backend_commit_launches_nothing(monkeypatch):
    """The GPU backend on CPU tensors: the second verify of the same
    commit calls ``verify_batch`` no time."""
    vals, commit, block_id = _port_commit()
    calls = []
    real = tov.verify_batch
    monkeypatch.setattr(
        tov, "verify_batch",
        lambda p, m, s, device=None: calls.append(len(p)) or real(p, m, s, device),
    )
    for _ in range(2):
        tval.verify_commit(CHAIN, vals, block_id, HEIGHT, commit, device="cpu")
    assert calls == [16]


def test_bad_commit_does_not_poison_the_good_one(monkeypatch):
    vals, good, block_id = _port_commit()
    _, bad, _ = _port_commit(bad=(3, 9))
    shipped = _count_pending(monkeypatch, cbatch.CpuBatchVerifier)
    with pytest.raises(tval.InvalidSignatureError) as e:
        tval.verify_commit(CHAIN, vals, block_id, HEIGHT, bad, backend="cpu")
    assert e.value.index == 3
    cache = sigcache.get_cache()
    msgs = bad.all_vote_sign_bytes(CHAIN)
    for i in (3, 9):
        pub = vals.validators[i].pub_key.bytes()
        assert cache.get(pub, msgs[i], bad.signatures[i].signature) is False
    # the good commit shares every triple but those two: two misses, passes
    tval.verify_commit(CHAIN, vals, block_id, HEIGHT, good, backend="cpu")
    assert shipped == [16, 2]


def test_single_signature_path_goes_through_the_cache():
    """A commit with one signature is not batched: it is verified through
    ``verify_with_cache``, and the second time it is a hit."""
    priv, pub = _keypair(b"single")
    vals = ValidatorSet([Validator(pub, 10)])
    bid = BlockID(hashlib.sha256(b"b").digest(), PartSetHeader(1, b"\x01" * 32))
    cs = CommitSig(BLOCK_ID_FLAG_COMMIT, pub.address(), Timestamp(1, 2), b"")
    commit = Commit(5, 0, bid, [cs])
    cs.signature = priv.sign(commit.vote_sign_bytes(CHAIN, 0))
    for _ in range(2):
        tval.verify_commit(CHAIN, vals, bid, 5, commit, backend="cpu")
    st = sigcache.get_cache().stats()
    assert (st["misses"], st["hits"], st["size"]) == (1, 1, 1)
