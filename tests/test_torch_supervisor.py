"""The port's backend supervisor (``cometbft_tpu_torch/ops/supervisor.py``)
against the JAX package's (``cometbft_tpu/ops/supervisor.py``).

Both run on their device-runner seam (a host-backed stand-in for the
device tiers, as ``tests/test_supervisor.py`` does), with the chains
pallas -> xla and cuda -> torch patched in on the CPU, where the host
answers below them: under every fault mode the two give the same verdict
bits, breaker states and counters, tier for tier.  Then the port's own
rules: the tier that served each batch (per thread, per handle, per-tier
counter, a WARNING for every step down), the card's rule that a batch
the kernel did not serve raises ``BackendError`` (on a stand-in card:
CUDA reported available, the device tier on the runner seam), the kill
switch, the sigcache audit, and one real ``torch``-tier verify on the
CPU.  Tests marked ``cuda`` run the supervisor on the card.
"""

import logging

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import backend_health as jbh
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import supervisor as jsup
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import cuda_verify as tcv
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.ops import verify as tov

TIER = {"pallas": "cuda", "xla": "torch", "host": "host"}
SIGN_KEYS = {}


def _clean():
    for bh, sup in ((jbh, jsup), (tbh, tsup)):
        bh.reset()
        sup.clear_fault_injector()
        sup.clear_device_runner()
    tds.reset()


@pytest.fixture(autouse=True)
def clean_state():
    _clean()
    yield
    _clean()


@pytest.fixture
def jov():
    """The JAX package's ``ops.verify``, imported here and not at the top:
    it imports jax, and the ``cuda`` tests below run on a card's machine
    that has none."""
    from cometbft_tpu.ops import verify

    return verify


@pytest.fixture
def chains(monkeypatch):
    """Both packages on their runner seam with a two-tier device chain."""
    monkeypatch.setattr(jsup, "device_chain", lambda: ("pallas", "xla"))
    monkeypatch.setattr(tsup, "device_chain", lambda device=None: ("cuda", "torch"))
    jsup.set_device_runner(_runner(jref))
    tsup.set_device_runner(_runner(ref))


def _runner(oracle):
    def run(backend, pubs, msgs, sigs, lanes):
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [oracle.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
        return out

    return run


def _key(i: int) -> bytes:
    if i not in SIGN_KEYS:
        SIGN_KEYS[i] = bytes(np.random.default_rng(1000 + i).integers(0, 256, 32, np.uint8))
    return SIGN_KEYS[i]


def _mixed_batch(seed: int, n: int):
    """Valid, tampered, truncated, short-key and swapped-message triples,
    as ``tests/test_supervisor.py`` mixes them."""
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        sk = _key(int(rng.integers(0, 40)))
        pub, msg = ref.pubkey_from_seed(sk), b"msg-%d-%d" % (seed, i)
        sig = ref.sign(sk, msg)
        kind = int(rng.integers(0, 6))
        if kind == 1:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        elif kind == 2:
            sig = sig[:40]
        elif kind == 3:
            pub = pub[:31]
        elif kind == 4:
            msg = b"other-%d" % i
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
    return pubs, msgs, sigs


def _oracle(pubs, msgs, sigs):
    return [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]


def _health(bh, rename=None) -> dict:
    """The registry snapshot with breakers renamed to the port's tiers and
    the last error text (which names the tier) dropped."""
    snap = bh.snapshot()
    snap["breakers"] = {
        (rename or {}).get(k, k): {kk: vv for kk, vv in v.items() if kk != "last_error"}
        for k, v in snap["breakers"].items()
    }
    return snap


# -- the fault matrix, against the JAX package --------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["raise", "hang", "wrong_shape", "flap"])
def test_fault_matrix_matches_jax(chains, jov, monkeypatch, mode, seed):
    if mode == "hang":
        monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "60")
    pubs, msgs, sigs = _mixed_batch(seed, 12)
    want = _oracle(pubs, msgs, sigs)
    shims = []
    for sup, tiers in ((jsup, ("pallas", "xla")), (tsup, ("cuda", "torch"))):
        shim = sup.FaultyBackend(mode, backends=tiers, hang_s=0.25, fail_n=2, pass_n=1)
        sup.set_fault_injector(shim)
        shims.append(shim)
    for batch in range(4):  # several batches: breaker transitions included
        j = jov.verify_batch(pubs, msgs, sigs)
        t = tov.verify_batch(pubs, msgs, sigs, device="cpu")
        assert list(t) == list(j) == want, f"batch {batch}"
        assert _health(tbh) == _health(jbh, TIER), f"batch {batch}"
    assert (shims[1].calls, shims[1].faults) == (shims[0].calls, shims[0].faults)
    snap = tbh.snapshot()
    assert snap["demotions"] >= 1 and snap["fallback_signatures"] >= 0
    if mode == "hang":
        assert snap["watchdog_fires"] >= 1


def test_bisect_quarantines_one_poisoned_input_like_jax(chains, jov):
    pubs = [ref.pubkey_from_seed(_key(i)) for i in range(7)]
    msgs = [b"m%d" % i for i in range(7)]
    sigs = [ref.sign(_key(i), m) for i, m in enumerate(msgs)]
    poison = pubs[3]  # a VALID signature whose presence kills the kernel

    def inject(backend, p, m, s):
        if poison in p:
            raise RuntimeError("poisoned input kills the kernel")

    jsup.set_fault_injector(inject)
    tsup.set_fault_injector(inject)
    j = jov.verify_batch(pubs, msgs, sigs)
    t = tov.verify_batch(pubs, msgs, sigs, device="cpu")
    assert list(t) == list(j) == [True] * 7
    assert tsup.last_tier() == "cuda"
    # the quarantined input was answered by the host, the rest by cuda
    assert tds.tier_counts() == {"cuda": (1, 6), "torch": (0, 0), "host": (1, 1)}
    snap = _health(tbh)
    assert snap == _health(jbh, TIER)
    assert (snap["quarantined"], snap["demotions"], snap["fallback_signatures"]) == (1, 0, 1)
    assert snap["breakers"]["cuda"]["state"] == tbh.CLOSED


def test_systematic_failure_demotes_without_quarantine(chains, jov):
    pubs, msgs, sigs = _mixed_batch(4, 6)
    for sup in (jsup, tsup):
        sup.set_fault_injector(sup.FaultyBackend("raise", backends=("pallas", "cuda")))
    j = jov.verify_batch(pubs, msgs, sigs)
    t = tov.verify_batch(pubs, msgs, sigs, device="cpu")
    assert list(t) == list(j) == _oracle(pubs, msgs, sigs)
    assert _health(tbh) == _health(jbh, TIER)
    assert tbh.snapshot()["quarantined"] == 0 and tsup.last_tier() == "torch"


def test_dispatch_fetch_verify_match_jax(chains):
    """The in-flight seam: three handles out at once, one of them under a
    raising injector, fetched in order; then a window while every device
    breaker is open."""
    work = [_mixed_batch(s, k) for s, k in ((5, 5), (6, 3), (7, 4))]
    for sup, tiers in ((jsup, ("pallas",)), (tsup, ("cuda",))):
        sup.set_fault_injector(sup.FaultyBackend("flap", backends=tiers,
                                                 fail_n=1, pass_n=1))
    jh = [jsup.dispatch_verify(*w) for w in work]
    th = [tsup.dispatch_verify(*w, device="cpu") for w in work]
    assert tds.snapshot()["inflight_depth"] == 3
    for j, t, w in zip(jh, th, work):
        assert list(tsup.fetch_verify(t)) == list(jsup.fetch_verify(j)) == _oracle(*w)
    assert [h.tier for h in th] == ["torch", "cuda", "torch"]
    assert tds.snapshot()["inflight_depth"] == 0
    assert _health(tbh) == _health(jbh, TIER)
    for bh, names in ((jbh, ("pallas", "xla")), (tbh, ("cuda", "torch"))):
        for b in names:
            bh.registry().breaker(b).trip("down")
    jh = jsup.dispatch_verify(*work[0])
    th = tsup.dispatch_verify(*work[0], device="cpu")
    assert list(tsup.fetch_verify(th)) == list(jsup.fetch_verify(jh))
    assert th.tier == "host"
    assert tds.snapshot()["lane_dispatches"] == {"cuda": 3, "host": 1}


def test_overlapped_window_under_fault_and_degraded(chains, jov):
    work = [_mixed_batch(s, k) for s, k in ((3, 4), (8, 3))]
    runner = tsup._DEVICE_RUNNER
    calls = []
    tsup.set_device_runner(lambda *a: calls.append(a[0]) or runner(*a))
    for sup in (jsup, tsup):
        sup.set_fault_injector(sup.FaultyBackend("raise"))
    j = jov.verify_batches_overlapped(work)
    t = tov.verify_batches_overlapped(work, device="cpu")
    assert [list(x) for x in t] == [list(x) for x in j] == [_oracle(*w) for w in work]
    assert _health(tbh) == _health(jbh, TIER)
    for b in ("cuda", "torch"):
        tbh.registry().breaker(b).trip("down")
    n = len(calls)
    t = tov.verify_batches_overlapped(work, device="cpu")
    assert [list(x) for x in t] == [_oracle(*w) for w in work]
    assert len(calls) == n  # no device dispatch while every breaker is open
    assert tsup.last_tier() == "host"


# -- the port's rules: tiers visible, kill switch, audit ----------------------


def test_every_step_down_is_counted_and_logged(chains, caplog):
    pubs, msgs, sigs = _mixed_batch(9, 6)
    want = _oracle(pubs, msgs, sigs)
    n = len(pubs)
    with caplog.at_level(logging.WARNING, logger="cometbft_tpu_torch.crypto"):
        assert list(tov.verify_batch(pubs, msgs, sigs, device="cpu")) == want
        assert tsup.last_tier() == "cuda" and not caplog.records
        tsup.set_fault_injector(tsup.FaultyBackend("wrong_shape", backends=("cuda",)))
        h = tov.dispatch_segments([(pubs[:2], msgs[:2], sigs[:2]),
                                   (pubs[2:], msgs[2:], sigs[2:])], device="cpu")
        assert h.tier is None
        assert [list(x) for x in tov.fetch_segments(h)] == [want[:2], want[2:]]
        assert h.tier == "torch" and tsup.last_tier() == "torch"
        for b in ("cuda", "torch"):
            tbh.registry().breaker(b).trip("down")
        assert list(tov.verify_batch(pubs, msgs, sigs, device="cpu")) == want
        assert tsup.last_tier() == "host"
    assert tds.tier_counts() == {"cuda": (1, n), "torch": (1, n), "host": (1, n)}
    text = [r.getMessage() for r in caplog.records]
    assert any("served by the torch tier, not cuda" in m for m in text)
    assert any("served by the host tier" in m for m in text)
    assert any("crypto backend cuda" in m and "failed" in m for m in text)
    snap = tds.snapshot()
    assert snap["fused_batches"] == 1 and snap["inflight_hwm"] == 1


def test_kill_switch_takes_the_raw_path(chains, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_SUPERVISOR", "0")
    assert not jsup.enabled() and not tsup.enabled()
    shim = tsup.FaultyBackend("raise")
    tsup.set_fault_injector(shim)
    seen = []
    monkeypatch.setattr(tov, "_dispatch", lambda p, m, s, dev:
                        seen.append(("d", len(p), dev.type)) or len(p))
    monkeypatch.setattr(tov, "_fetch", lambda n: seen.append(("f", n)) or
                        np.ones(n, dtype=bool))
    pubs, msgs, sigs = _mixed_batch(10, 3)
    assert list(tov.verify_batch(pubs, msgs, sigs, device="cpu")) == [True] * 3
    h = tov.dispatch_segments([(pubs, msgs, sigs)], device="cpu")
    assert h.sup is None and list(tov.fetch_segments(h)[0]) == [True] * 3
    assert seen == [("d", 3, "cpu"), ("f", 3)] * 2
    assert shim.calls == 0 and tbh.snapshot()["breakers"] == {}
    assert tds.tier_counts() == {"cuda": (0, 0), "torch": (0, 0), "host": (0, 0)}


def test_watchdog_and_switches():
    assert tsup.watchdog_call(lambda: 42, timeout_s=5.0) == 42
    with pytest.raises(ValueError):
        tsup.watchdog_call(lambda: int("x"), timeout_s=5.0)
    with pytest.raises(tbh.DispatchTimeoutError):
        tsup.watchdog_call(lambda: __import__("time").sleep(0.3), 0.02, backend="cuda")
    assert tbh.snapshot()["watchdog_fires"] == 1
    assert tsup.device_chain("cpu") == ("torch",)
    assert tsup.device_chain() == tsup.device_chain("cuda") == ("cuda",)
    assert tsup.active_backend("cpu") == "torch"
    tbh.registry().breaker("torch").trip("down")
    assert tsup.active_backend("cpu") is None
    with pytest.raises(ValueError):
        tsup.FaultyBackend("melt")
    assert tsup.supervised_device_call("secp_device", lambda: 7) == 7
    assert tsup.supervised_device_call(
        "secp_device", lambda: int("x"), fallback_units=2) is None
    snap = tbh.snapshot()
    assert snap["demotions"] == 1 and snap["fallback_signatures"] == 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sigcache_audit_caches_no_verdict_of_a_failed_dispatch(pkg):
    """JAX ``tests/test_supervisor.py`` ``TestSigcacheAudit``, on both
    packages: a hole stays a hole, a missing verdict raises BackendError,
    a raising backend caches nothing."""
    if pkg == "jax":
        from cometbft_tpu.crypto import batch as cb
        from cometbft_tpu.crypto import sigcache as sc
        bh, r = jbh, jref
    else:
        cb, sc, bh, r = tbatch, tsc, tbh, ref
    sc.reset_cache()
    try:
        pub, msg = r.pubkey_from_seed(b"\x09" * 32), b"audit"
        sig = r.sign(b"\x09" * 32, msg)
        bits, miss = sc.partition_misses([pub], [msg], [sig])
        sc.writeback([pub], [msg], [sig], bits, miss, [None])
        assert bits == [None] and sc.get_cache().get(pub, msg, sig) is None

        class Holes(cb._CollectingVerifier):
            PUB_SIZES, SIG_SIZES = (32,), (64,)

            def _verify_pending(self, pubs, msgs, sigs):
                return [None] * len(pubs)

        class Raises(cb._CollectingVerifier):
            PUB_SIZES, SIG_SIZES = (32,), (64,)

            def _verify_pending(self, pubs, msgs, sigs):
                raise RuntimeError("backend exploded")

        for cls, err in ((Holes, bh.BackendError), (Raises, RuntimeError)):
            bv = cls()
            bv.add(pub, msg, sig)
            with pytest.raises(err):
                bv.verify()
            assert len(sc.get_cache()) == 0
    finally:
        sc.reset_cache()


def test_corrupt_device_output_never_reaches_the_cache(chains):
    """A device that answers all-False with a lane missing: the supervisor
    rejects the output, the host answers, and only its verdicts are
    cached; the verifier sees no False bit for a valid signature."""
    tsc.reset_cache()
    try:
        tsup.set_device_runner(lambda b, p, m, s, lanes: np.zeros(lanes, dtype=bool))
        tsup.set_fault_injector(tsup.FaultyBackend("wrong_shape"))
        pubs, msgs, sigs = _mixed_batch(11, 8)
        bv = tbatch.GpuBatchVerifier(device="cpu")
        for p, m, s in zip(pubs, msgs, sigs):
            bv.add(p, m, s)
        ok, bits = bv.verify()
        want = _oracle(pubs, msgs, sigs)
        assert bits == want and any(want) and tsup.last_tier() == "host"
        for p, m, s, w in zip(pubs, msgs, sigs, want):
            if len(p) == 32 and len(s) == 64:
                assert tsc.get_cache().get(p, m, s) is w
    finally:
        tsc.reset_cache()


def test_one_real_torch_tier_verify_then_host(caplog):
    """The CPU chain without a stand-in: the torch tier runs the plain
    version (the one plain CPU verify of this file), then a raising
    injector steps the same 16 lanes down to the host tier, visibly."""
    pubs, msgs, sigs = _mixed_batch(12, 16)
    want = _oracle(pubs, msgs, sigs)
    assert list(tov.verify_batch(pubs, msgs, sigs, device="cpu")) == want
    assert tsup.last_tier() == "torch"
    tsup.set_fault_injector(tsup.FaultyBackend("raise"))
    with caplog.at_level(logging.WARNING, logger="cometbft_tpu_torch.crypto"):
        assert list(tov.verify_batch(pubs, msgs, sigs, device="cpu")) == want
    assert tsup.last_tier() == "host"
    assert tds.tier_counts() == {"cuda": (0, 0), "torch": (1, 16), "host": (1, 16)}
    snap = tbh.snapshot()
    assert (snap["demotions"], snap["fallback_signatures"]) == (1, 16)
    assert any("served by the host tier" in r.getMessage() for r in caplog.records)


# -- the card's rule, on a stand-in card -------------------------------------


@pytest.fixture
def stand_in_card(monkeypatch):
    """CUDA reported available, no library loaded and the cuda tier on the
    runner seam: the supervisor's rules for a card run here, with no card
    and no kernel build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsup, "_load_libraries", lambda dev: None)
    tsup.set_device_runner(_runner(ref))
    tsc.reset_cache()
    yield
    tsc.reset_cache()


def _valid_batch(n: int, tag: bytes):
    msgs = [b"%s-%d" % (tag, i) for i in range(n)]
    return ([ref.pubkey_from_seed(_key(i)) for i in range(n)], msgs,
            [ref.sign(_key(i), m) for i, m in enumerate(msgs)])


@pytest.mark.parametrize("mode", ["raise", "hang", "wrong_shape"])
def test_stand_in_card_raises_where_the_cpu_steps_down(stand_in_card, monkeypatch,
                                                       caplog, mode):
    """A batch the cuda tier does not serve raises ``BackendError``: no
    tier below the kernel answers, no bit is False for it, nothing is
    cached; after three failures the breaker is open and a batch raises
    without a dispatch."""
    monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "60")
    pubs, msgs, sigs = _mixed_batch(15, 8)
    shim = tsup.FaultyBackend(mode, hang_s=0.25)
    tsup.set_fault_injector(shim)
    with caplog.at_level(logging.WARNING, logger="cometbft_tpu_torch.crypto"):
        for _ in range(4):
            with pytest.raises(tbh.BackendError, match="no tier below the kernel"):
                tov.verify_batch(pubs, msgs, sigs, device="cuda")
            assert tsup.last_tier() is None
        calls = shim.calls
        bv = tbatch.GpuBatchVerifier(device="cuda")
        for t in zip(pubs, msgs, sigs):
            bv.add(*t)
        with pytest.raises(tbh.BackendError, match="breaker is open"):
            bv.verify()
    assert shim.calls == calls and len(tsc.get_cache()) == 0
    assert tds.tier_counts() == {"cuda": (0, 0), "torch": (0, 0), "host": (0, 0)}
    snap = tbh.snapshot()
    assert (snap["demotions"], snap["fallback_signatures"], snap["quarantined"]) == (3, 0, 0)
    assert snap["breakers"]["cuda"]["state"] == tbh.OPEN
    assert sum("crypto backend cuda dispatch failed" in r.getMessage()
               for r in caplog.records) == 3


def test_stand_in_card_quarantine_raises_and_keeps_the_kernel(stand_in_card):
    pubs, msgs, sigs = _valid_batch(7, b"q")
    poison = pubs[5]
    runs = []
    runner = tsup._DEVICE_RUNNER
    tsup.set_device_runner(lambda *a: runs.append(len(a[1])) or runner(*a))

    def inject(backend, p, m, s):
        if poison in p:
            raise RuntimeError("poisoned input kills the kernel")

    tsup.set_fault_injector(inject)
    with pytest.raises(tsup.PoisonedInputError) as e:
        tov.verify_batch(pubs, msgs, sigs, device="cuda")
    assert e.value.index == 5 and tsup.last_tier() is None
    snap = tbh.snapshot()
    assert (snap["quarantined"], snap["demotions"], snap["fallback_signatures"]) == (1, 0, 0)
    assert snap["breakers"]["cuda"]["state"] == tbh.CLOSED
    assert tds.tier_counts()["host"] == (0, 0) and sum(runs) == 6
    tsup.clear_fault_injector()
    assert list(tov.verify_batch(pubs, msgs, sigs, device="cuda")) == [True] * 7
    assert tsup.last_tier() == "cuda"


def test_stand_in_card_scheduler_completes_futures_with_the_error(stand_in_card,
                                                                  monkeypatch):
    """The scheduler on a card: a flush the kernel did not serve completes
    its futures with ``BackendError``; ``Vote.verify``'s path and the
    batch-verifier bridge (queued and direct) raise it; the host answers
    nothing and nothing is cached."""
    from cometbft_tpu_torch import verifysched as tvs
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.verifysched import service

    monkeypatch.setattr(service, "backend_trusted", lambda: True)
    tvs.reset_scheduler()
    pubs, msgs, sigs = _valid_batch(40, b"sched")
    tsup.set_fault_injector(tsup.FaultyBackend("raise"))
    try:
        for f in tvs.get_scheduler().submit_many(pubs[:5], msgs[:5], sigs[:5]):
            with pytest.raises(tbh.BackendError):
                f.result(timeout=30)
        with pytest.raises(tbh.BackendError):
            tvs.verify_cached(Ed25519PubKey(pubs[0]), msgs[0], sigs[0],
                              priority=tvs.PRIO_CONSENSUS)
        for k in (6, 40):  # below the flush target: queued; above: direct
            with pytest.raises(tbh.BackendError):
                tvs.verify_segment_sync(pubs[:k], msgs[:k], sigs[:k])
        assert len(tsc.get_cache()) == 0
    finally:
        tvs.reset_scheduler()
    assert tvs.stats.snapshot()["shed_fallback"]["consensus"] == 0
    assert tds.tier_counts() == {"cuda": (0, 0), "torch": (0, 0), "host": (0, 0)}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_cuda_tier_fault_raises(card):
    pubs, msgs, sigs = _mixed_batch(13, 16)
    want = _oracle(pubs, msgs, sigs)
    tcv.reset_launches()
    assert list(tov.verify_batch(pubs, msgs, sigs)) == want
    assert tsup.last_tier() == "cuda" and tcv.launches == 1
    tsup.set_fault_injector(tsup.FaultyBackend("raise", backends=("cuda",)))
    with pytest.raises(tbh.BackendError, match="no tier below the kernel"):
        tov.verify_batch(pubs, msgs, sigs)
    assert tsup.last_tier() is None
    assert tds.tier_counts() == {"cuda": (1, 16), "torch": (0, 0), "host": (0, 0)}
    tsup.clear_fault_injector()
    tbh.reset()
    assert list(tov.verify_batch(pubs, msgs, sigs)) == want
    assert tsup.last_tier() == "cuda" and tcv.launches == 2


@pytest.mark.cuda
def test_card_failed_launch_demotes_visibly(card, monkeypatch, caplog):
    monkeypatch.setattr(tcv, "_launcher", lambda: lambda *a: 700)
    pubs, msgs, sigs = _mixed_batch(14, 8)
    with caplog.at_level(logging.WARNING, logger="cometbft_tpu_torch.crypto"):
        h = tov.dispatch_segments([(pubs, msgs, sigs)])
        with pytest.raises(tbh.BackendError, match="kernel launch failed"):
            tov.fetch_segments(h)
    assert h.tier is None and tbh.snapshot()["demotions"] == 1
    assert tds.tier_counts()["torch"] == tds.tier_counts()["host"] == (0, 0)
    assert any("kernel launch failed" in r.getMessage() for r in caplog.records)
