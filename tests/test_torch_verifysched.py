"""The port's continuous-batching verify scheduler
(``cometbft_tpu_torch/verifysched``) against the JAX package's.

Each scenario runs on both schedulers, over their supervisors' host-backed
device-runner seam (as ``tests/test_verifysched.py`` does), with a chain
of one device tier (xla on the JAX side, torch on the port's, on the
CPU): the verdicts and the deterministic counters must be equal.  Then
the port's own rules: a segment submitted at once is one flush, the
bucket mirrors, the kill switch, the bridge from the batch verifier.
"""

import hashlib
import threading
import time
import types

import numpy as np
import pytest

from cometbft_tpu import verifysched as jvs
from cometbft_tpu.crypto import backend_health as jbh
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.crypto import sigcache as jsc
from cometbft_tpu.crypto.keys import Ed25519PubKey as JPub
from cometbft_tpu.ops import dispatch_stats as jds
from cometbft_tpu.ops import supervisor as jsup
from cometbft_tpu_torch import verifysched as tvs
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey as TPub
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.ops import verify as tov
from cometbft_tpu_torch.verifysched import service as tservice

# counters that do not depend on timing
DETERMINISTIC = ("submitted", "submit_hits", "shed", "queue_depth", "flushes",
                 "flush_items", "flush_misses", "flush_lanes", "dedup_hits",
                 "verdicts", "shed_fallback", "verdicts_total", "shed_total")


def _runner(oracle, log):
    def run(backend, pubs, msgs, sigs, lanes):
        log.append(list(msgs))
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [oracle.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
        return out

    return run


def _reset(p):
    p.vs.reset_scheduler()
    p.sup.clear_device_runner()
    p.sup.clear_fault_injector()
    p.bh.reset()
    p.sc.reset_cache()
    p.vs.stats.reset()
    p.ds.reset()


@pytest.fixture
def pkgs(monkeypatch):
    """Both packages scheduler-active on their runner seam: the JAX one
    through its backend variable, the port's through its trust gate (no
    card here) and a process-wide scheduler on the CPU."""
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "tpu")
    monkeypatch.delenv("COMETBFT_TPU_VERIFY_SCHED", raising=False)
    monkeypatch.setattr(tservice, "backend_trusted", lambda: True)
    real = tservice.VerifyScheduler
    monkeypatch.setattr(tservice, "VerifyScheduler",
                        lambda **kw: real(**{"device": "cpu", **kw}))
    out = []
    for name, vs, sup, bh, sc, ds, r, pub in (
        ("jax", jvs, jsup, jbh, jsc, jds, jref, JPub),
        ("torch", tvs, tsup, tbh, tsc, tds, ref, TPub),
    ):
        p = types.SimpleNamespace(name=name, vs=vs, sup=sup, bh=bh, sc=sc, ds=ds,
                                  ref=r, Pub=pub, log=[])
        p.sched = (lambda real=real, vs=vs, name=name, **kw:
                   vs.VerifyScheduler(**kw) if name == "jax"
                   else real(device="cpu", **kw))
        _reset(p)
        sup.set_device_runner(_runner(r, p.log))
        out.append(p)
    yield out
    for p in out:
        _reset(p)


def _triples(n, tag=b"vs", invalid_every=None):
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        seed = hashlib.sha256(b"%s-%d" % (tag, i)).digest()
        msg = b"%s-msg-%d" % (tag, i)
        sig = ref.sign(seed, msg)
        if invalid_every and i % invalid_every == 0:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        pubs.append(ref.pubkey_from_seed(seed))
        msgs.append(msg)
        sigs.append(sig)
    return pubs, msgs, sigs


def _oracle(pubs, msgs, sigs):
    return [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]


def _counters(p) -> dict:
    snap = p.vs.stats.snapshot()
    return {k: snap[k] for k in DETERMINISTIC}


def _same(pkgs, scenario):
    """Run ``scenario(p)`` on both packages; its results, the runner's
    flush log and the deterministic counters must be equal."""
    got = [(scenario(p), p.log, _counters(p)) for p in pkgs]
    assert got[1] == got[0]
    return got[1][0]


# -- scenarios on both schedulers ---------------------------------------------


def test_submit_many_mixed_verdicts_and_counters(pkgs):
    pubs, msgs, sigs = _triples(48, b"mix", invalid_every=3)
    pubs[5], sigs[11] = b"\x01" * 31, b"\x02" * 63

    def run(p):
        s = p.vs.get_scheduler()
        s.pause()
        futs = s.submit_many(pubs, msgs, sigs)
        s.resume()
        return [f.result(timeout=30) for f in futs]

    got = _same(pkgs, run)
    assert got == _oracle(pubs, msgs, sigs)
    assert tvs.stats.snapshot()["flushes"]["full"] == 1


def test_priority_order_under_pause(pkgs):
    """Queued bulk, evidence and consensus items ride one flush with the
    consensus class first, then evidence/light, then bulk."""
    groups = [_triples(3, b"p%d" % k) for k in range(3)]

    def run(p):
        s = p.sched(flush_us=1000)
        try:
            s.pause()
            futs = []
            for prio in (p.vs.PRIO_BLOCKSYNC, p.vs.PRIO_EVIDENCE, p.vs.PRIO_CONSENSUS):
                futs += s.submit_many(*groups[prio], priority=prio)
            s.resume()
            return [f.result(timeout=30) for f in futs]
        finally:
            s.close()

    assert _same(pkgs, run) == [True] * 9
    assert pkgs[1].log == [groups[0][1] + groups[1][1] + groups[2][1]]


def test_shedding_spares_consensus_at_a_small_cap(pkgs):
    bulk, cons = _triples(8, b"bulk"), _triples(6, b"cons")

    def run(p):
        s = p.sched(flush_us=1000, queue_cap=4)
        try:
            s.pause()
            admitted, shed = [], 0
            for t in zip(*bulk):
                try:
                    admitted.append(s.submit(*t, priority=p.vs.PRIO_BLOCKSYNC))
                except p.vs.QueueFullError:
                    shed += 1
            with pytest.raises(p.vs.QueueFullError):
                s.submit(*[x[0] for x in bulk], priority=p.vs.PRIO_EVIDENCE)
            cons_f = [s.submit(*t, priority=p.vs.PRIO_CONSENSUS) for t in zip(*cons)]
            pending = s.pending()
            s.resume()
            return (shed, pending, [f.result(timeout=30) for f in admitted + cons_f])
        finally:
            s.close()

    shed, pending, got = _same(pkgs, run)
    assert (shed, pending, got) == (4, 10, [True] * 10)
    snap = tvs.stats.snapshot()
    assert snap["shed"] == {"consensus": 0, "evidence_light": 1, "bulk": 4}


def test_in_flight_dedup_and_cache_hit(pkgs):
    (pub,), (msg,), (sig,) = _triples(1, b"dup")

    def run(p):
        s = p.vs.get_scheduler()
        s.pause()
        futs = [s.submit(pub, msg, sig) for _ in range(5)]
        s.resume()
        first = [f.result(timeout=30) for f in futs]
        s.pause()  # a queued item could not resolve while paused
        hit = s.submit(pub, msg, sig)
        out = (first, hit.done() and hit.result(), s.pending())
        s.resume()
        return out

    assert _same(pkgs, run) == ([True] * 5, True, 0)
    snap = tvs.stats.snapshot()
    assert (snap["dedup_hits"], snap["flush_misses"]) == (4, 1)
    assert snap["submit_hits"]["consensus"] == 1


def test_close_drains_with_shutdown_and_then_refuses(pkgs):
    pubs, msgs, sigs = _triples(3, b"shut")

    def run(p):
        s = p.sched(flush_us=10_000_000)
        s.pause()
        futs = s.submit_many(pubs, msgs, sigs)
        s.close()  # overrides pause; every future resolves
        with pytest.raises(RuntimeError):
            s.submit(pubs[0], msgs[0], b"\x00" * 64)
        return [f.result(timeout=30) for f in futs]

    assert _same(pkgs, run) == [True] * 3
    assert tvs.stats.snapshot()["flushes"]["shutdown"] == 1


def test_verify_segment_sync_sheds_past_the_cap(pkgs, monkeypatch):
    """The batch-verifier bridge at bulk priority with a queue of 4: four
    ride the scheduler, the rest are verified in one direct dispatch."""
    monkeypatch.setenv("COMETBFT_TPU_SCHED_QUEUE", "4")
    pubs, msgs, sigs = _triples(10, b"seg", invalid_every=4)

    def run(p):
        p.vs.reset_scheduler()
        p.vs.get_scheduler().pause()
        out = []
        t = threading.Thread(target=lambda: out.append(
            p.vs.verify_segment_sync(pubs, msgs, sigs)))
        t.start()
        deadline = time.monotonic() + 30
        while p.vs.stats.snapshot()["shed_fallback"]["bulk"] < 6:
            assert time.monotonic() < deadline, p.vs.stats.snapshot()["shed_fallback"]
            threading.Event().wait(0.002)
        p.vs.get_scheduler().resume()
        t.join(30)
        return out[0]

    assert _same(pkgs, run) == _oracle(pubs, msgs, sigs)
    snap = tvs.stats.snapshot()
    assert snap["shed"]["bulk"] == 6 and snap["submitted"]["bulk"] == 4


def test_faults_under_the_scheduler_resolve_definitively(pkgs):
    """A raising device inside a coalesced flush: every future gets the
    oracle's verdict from the host tier, and nothing false is cached."""
    pubs, msgs, sigs = _triples(24, b"flt", invalid_every=4)

    def run(p):
        p.sup.set_fault_injector(p.sup.FaultyBackend("raise"))
        s = p.vs.get_scheduler()
        s.pause()
        futs = s.submit_many(pubs, msgs, sigs)
        s.resume()
        got = [f.result(timeout=60) for f in futs]
        p.sup.clear_fault_injector()
        again = [p.vs.verify_cached(p.Pub(*t[:1]), *t[1:]) for t in zip(pubs, msgs, sigs)]
        snap = p.bh.snapshot()
        return got, again, snap["demotions"], snap["fallback_signatures"]

    got, again, demotions, fallback = _same(pkgs, run)
    assert got == again == _oracle(pubs, msgs, sigs)
    assert demotions == 1 and fallback == 24
    assert tds.tier_counts()["host"] == (1, 24)


# -- the port's own rules -------------------------------------------------------


def test_a_segment_submitted_at_once_is_one_flush(pkgs):
    """``submit_many`` queues its items under one hold of the lock: a
    running dispatcher cannot split the segment, even past the full
    bucket (the JAX package submits item by item)."""
    p = pkgs[1]
    pubs, msgs, sigs = _triples(100, b"one")
    s = p.sched(flush_us=5_000_000)
    try:
        futs = s.submit_many(pubs, msgs, sigs)
        assert [f.result(timeout=30) for f in futs] == [True] * 100
    finally:
        s.close()
    snap = tvs.stats.snapshot()
    assert snap["flushes"]["full"] == 1 and snap["flush_items"] == 100
    assert p.log == [msgs]


def test_a_segment_that_fills_the_flush_target_is_one_direct_dispatch(pkgs):
    """``verify_segment_sync`` of a segment at least the flush target
    long: one supervised dispatch, nothing queued, no per-item future,
    dedup key or cache write (the JAX package queues it); one short of it
    rides the queue as one flush."""
    p = pkgs[1]
    target = tvs.get_scheduler()._bucket_target()
    pubs, msgs, sigs = _triples(target + 1, b"direct", invalid_every=5)
    assert tvs.verify_segment_sync(pubs, msgs, sigs) == _oracle(pubs, msgs, sigs)
    snap = tvs.stats.snapshot()
    assert sum(snap["submitted"].values()) == 0 and snap["verdicts_total"] == 0
    assert p.log == [msgs] and len(tsc.get_cache()) == 0
    assert tds.tier_counts()["torch"] == (1, target + 1)
    short = [x[:target - 1] for x in (pubs, msgs, sigs)]
    assert tvs.verify_segment_sync(*short) == _oracle(*short)
    snap = tvs.stats.snapshot()
    assert snap["submitted"]["bulk"] == target - 1 and len(p.log) == 2


def test_bucket_mirrors_and_defaults():
    assert tservice._FALLBACK_BUCKETS == tuple(tov._BUCKETS)
    assert tservice.MAX_DRAIN == tov._BUCKETS[-1]
    assert tservice.MAX_DRAIN >= 10_240  # a full-width commit is one drain
    assert tvs.DEFAULT_QUEUE_CAP == jvs.DEFAULT_QUEUE_CAP
    s = tvs.VerifyScheduler(device="cpu")
    assert s._bucket_target() == tov._BUCKETS[0] and s.queue_cap == tvs.DEFAULT_QUEUE_CAP
    s.close()


def test_gate_and_kill_switch(pkgs, monkeypatch):
    p = pkgs[1]
    pubs, msgs, sigs = _triples(4, b"ks", invalid_every=2)
    monkeypatch.setenv("COMETBFT_TPU_VERIFY_SCHED", "0")
    assert not tvs.scheduler_active()
    got = [tvs.verify_cached(TPub(a), b, c) for a, b, c in zip(pubs, msgs, sigs)]
    assert got == _oracle(pubs, msgs, sigs)
    assert tservice._SCHED is None and tvs.stats.snapshot()["verdicts_total"] == 0
    assert len(tsc.get_cache()) == 4 and p.log == []
    monkeypatch.undo()
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    assert not tvs.backend_trusted() and not tvs.scheduler_active()
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda"})
    assert tvs.backend_trusted() and tvs.scheduler_active()


def test_batch_verifier_bridge(pkgs):
    """``GpuBatchVerifier`` on the default device rides the scheduler at
    the ambient priority; one pinned to a device dispatches itself."""
    p = pkgs[1]
    pubs, msgs, sigs = _triples(12, b"bv", invalid_every=4)
    want = _oracle(pubs, msgs, sigs)
    bv = tbatch.GpuBatchVerifier()
    for t in zip(pubs, msgs, sigs):
        bv.add(*t)
    with tvs.priority_class(tvs.PRIO_LIGHT):
        assert bv.verify() == (False, want)
    snap = tvs.stats.snapshot()
    assert snap["submitted"]["evidence_light"] == 12 and len(p.log) == 1
    tsc.reset_cache()
    pinned = tbatch.GpuBatchVerifier(device="cpu")
    for t in zip(pubs, msgs, sigs):
        pinned.add(*t)
    assert pinned.verify() == (False, want)
    assert tvs.stats.snapshot()["submitted"]["evidence_light"] == 12
    assert len(p.log) == 2  # dispatched directly, not through the queue


def test_verify_many_cached_rides_one_flush(pkgs):
    """Several independent checks submitted before any wait (evidence's
    two votes): one flush, verdicts as the JAX package's.  The process-wide
    scheduler is paused until all four items are queued, so no flush window
    can close between the submits however slow the host is."""
    pubs, msgs, sigs = _triples(4, b"many", invalid_every=2)

    def run(p):
        keys = [p.Pub(x) for x in pubs]
        sched, got = p.vs.get_scheduler(), []

        def verify():
            with p.vs.priority_class(p.vs.PRIO_EVIDENCE):
                got.append(p.vs.verify_many_cached(keys, msgs, sigs))

        sched.pause()
        caller = threading.Thread(target=verify)
        caller.start()
        deadline = time.monotonic() + 30
        while sched.pending() < len(keys) and time.monotonic() < deadline:
            time.sleep(0.001)
        sched.resume()
        caller.join(30)
        return got[0], sum(p.vs.stats.snapshot()["flushes"].values())

    assert _same(pkgs, run) == (_oracle(pubs, msgs, sigs), 1)
    assert tvs.stats.snapshot()["submitted"]["evidence_light"] == 4


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dispatcher_restarts_after_death(pkgs):
    """A flush that dies with a BaseException resolves its items on the
    host reference first (counted under the host tier), then the thread
    dies; the next submit starts a fresh dispatcher."""
    p = pkgs[1]
    s = p.sched(flush_us=500)
    try:
        (pub,), (msg,), (sig,) = _triples(1, b"dead")

        def dying(items, reason, recorded):
            raise SystemExit

        real = s._dispatch_flush
        s._dispatch_flush = dying
        assert s.submit(pub, msg, sig).result(timeout=30) is True
        dead = s._thread
        dead.join(10)
        assert not dead.is_alive()
        assert tds.tier_counts()["host"] == (1, 1)
        s._dispatch_flush = real
        (p2,), (m2,), (s2,) = _triples(1, b"alive")
        assert s.submit(p2, m2, s2).result(timeout=30) is True
        assert s._thread is not dead and tvs.stats.snapshot()["queue_depth"] == 0
    finally:
        s.close()
