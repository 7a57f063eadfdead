"""The port's transaction ingestion (``cometbft_tpu_torch/txingest``, the
mempool's batched admission and recheck, the mempool reactor's ``ingest``)
held to the JAX package's on the same seeded inputs, with equality as the
tolerance: envelope bytes, sign bytes and codes, ``SigVerifyingApp``'s
responses (each package's ABCI codec bytes), ``check_tx_batch`` against
sequential ``check_tx`` in the port and against the JAX ``check_tx_batch``
(contents, order, codes, cache), the batched recheck, and the ingest
coalescer's size and deadline flushes, shed to sync, nonce replay and
``close``.

Signatures verify on the host with both gates closed
(``COMETBFT_TPU_CRYPTO_BACKEND=cpu``), or through each package's verify
scheduler on the supervisor's device-runner seam (the host oracle): the
JAX one opened by its backend variable, the port's by its trust gate and
a process-wide scheduler on the CPU, as ``tests/test_torch_verifysched.py``
opens it.  No plain verify and no JAX program runs.
"""

import contextlib
import hashlib
import random
import threading
import time
import types

import numpy as np
import pytest

from cometbft_tpu import verifysched as jvs
from cometbft_tpu.abci import codec as jcodec
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.config import config as jcfg
from cometbft_tpu.crypto import backend_health as jbh
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import sigcache as jsc
from cometbft_tpu.mempool import clist_mempool as jmp
from cometbft_tpu.mempool import reactor as jmr
from cometbft_tpu.ops import supervisor as jsup
from cometbft_tpu.proxy import multi_app_conn as jproxy
from cometbft_tpu import txingest as jti
from cometbft_tpu.txingest import envelope as jev
from cometbft_tpu.txingest import stats as jstats

from cometbft_tpu_torch import verifysched as tvs
from cometbft_tpu_torch.abci import codec as tcodec
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.config import config as tcfg
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
from cometbft_tpu_torch.mempool import clist_mempool as tmp
from cometbft_tpu_torch.mempool import reactor as tmr
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.proxy import multi_app_conn as tproxy
from cometbft_tpu_torch import txingest as tti
from cometbft_tpu_torch.txingest import envelope as tev
from cometbft_tpu_torch.txingest import stats as tstats
from cometbft_tpu_torch.verifysched import service as tservice

SEED = 20261037
MAX_TX = 512


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, ti=jti, ev=jev, stats=jstats, mp=jmp, mr=jmr, kv=jkv, cfg=jcfg,
            proxy=jproxy, codec=jcodec, keys=jkeys, vs=jvs, sup=jsup, bh=jbh, sc=jsc,
            ref=jref, cpu={})
    return types.SimpleNamespace(
        name=name, ti=tti, ev=tev, stats=tstats, mp=tmp, mr=tmr, kv=tkv, cfg=tcfg,
        proxy=tproxy, codec=tcodec, keys=tkeys, vs=tvs, sup=tsup, bh=tbh, sc=tsc,
        ref=tref, cpu={"device": "cpu"})


J, T = _pkg("jax"), _pkg("torch")
BOTH = (J, T)


def _ed_privs(p, n=3):
    return [p.keys.Ed25519PrivKey.from_seed(hashlib.sha256(b"tti%d" % i).digest())
            for i in range(n)]


# secp256k1 envelopes are signed once by the port (RFC 6979) and fed to
# both packages as bytes: the JAX package signs with `cryptography` where
# it is installed, whose nonces are random
SECP = Secp256k1PrivKey.from_secret(b"\x51" * 32)


def _mix(n: int, seed: int) -> list:
    """A seeded mix of valid, forged, malformed, plain, bad plain,
    oversize and duplicate txs, the same bytes for both packages."""
    rng = random.Random(seed)
    privs = _ed_privs(T)
    kinds = ("ed", "ed", "ed", "secp", "forged", "malformed", "plain_ok",
             "plain_bad", "oversize", "dup")
    txs: list = []
    for i in range(n):
        kind = rng.choice(kinds)
        if kind == "dup" and txs:
            txs.append(txs[rng.randrange(len(txs))])
        elif kind == "ed":
            txs.append(tev.sign_tx(privs[i % 3], b"k%d=%d" % (i, i), nonce=i))
        elif kind == "secp":
            txs.append(tev.sign_tx(SECP, b"s%d=%d" % (i, i), nonce=i))
        elif kind == "forged":
            e = tev.decode(tev.sign_tx(privs[i % 3], b"f%d=%d" % (i, i), nonce=i))
            txs.append(tev.encode(tev.Envelope(e.key_type, e.pubkey, e.nonce + 7,
                                               e.payload, e.signature)))
        elif kind == "malformed":
            txs.append(tev.MAGIC + b"\x99junk%d" % i)
        elif kind == "plain_ok":
            txs.append(b"p%d=%d" % (i, i))
        elif kind == "plain_bad":
            txs.append(b"notakv%d" % i)
        else:
            txs.append(tev.sign_tx(privs[0], b"o%d=" % i + b"z" * (MAX_TX + 64), nonce=i))
    return txs


def _outcome(res) -> tuple:
    if isinstance(res, (J.ti.envelope.at.CheckTxResponse, T.ti.envelope.at.CheckTxResponse)):
        return ("resp", res.code, res.codespace, res.log)
    return ("err", type(res).__name__)


class CountingConn:
    """A mempool connection counting its round trips by kind."""

    def __init__(self, inner):
        self.inner = inner
        self.check_tx_calls = 0
        self.check_txs_calls = 0

    def check_tx(self, req):
        self.check_tx_calls += 1
        return self.inner.check_tx(req)

    def check_txs(self, reqs):
        self.check_txs_calls += 1
        return self.inner.check_txs(reqs)


def _stack(p, app=None, recheck=False, **cfg):
    """(conn, mempool, app) over a local-client SigVerifyingApp(kvstore)."""
    app = app if app is not None else p.ti.SigVerifyingApp(p.kv.KVStoreApplication(),
                                                           **p.cpu)
    conns = p.proxy.AppConns(p.proxy.local_client_creator(app))
    conns.start()
    aware = getattr(conns.query.info(), "envelope_sig_verified", False)
    conn = CountingConn(conns.mempool)
    cfg.setdefault("max_tx_bytes", MAX_TX)
    mp = p.mp.CListMempool(p.cfg.MempoolConfig(recheck=recheck, **cfg), conn,
                           envelope_aware=aware)
    return conn, mp, app


def _per_tx(p, mp, txs) -> list:
    out = []
    for tx in txs:
        try:
            out.append(_outcome(mp.check_tx(tx)))
        except p.mp.MempoolError as e:
            out.append(_outcome(e))
    return out


def _state(mp) -> tuple:
    """Contents in order, sizes, and the cache's keys (a set: batched
    admission pushes them in another order than a sequence of ``check_tx``
    calls, in both packages)."""
    return (mp.reap_max_txs(-1), mp.size(), mp.size_bytes(), frozenset(mp.cache._map))


def _lru(mp) -> list:
    """The cache's keys in LRU order, for port against JAX."""
    return list(mp.cache._map)


def _oracle_runner(ref):
    def run(backend, pubs, msgs, sigs, lanes):
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
        return out

    return run


def _reset(p):
    p.vs.reset_scheduler()
    p.sup.clear_device_runner()
    p.sup.clear_fault_injector()
    p.bh.reset()
    p.sc.reset_cache()
    p.vs.stats.reset()
    p.stats.reset()


@pytest.fixture
def host(monkeypatch):
    """Both gates closed: every signature verifies on the host."""
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.delenv("COMETBFT_TPU_TXINGEST", raising=False)
    for p in BOTH:
        _reset(p)
    yield
    for p in BOTH:
        _reset(p)


@pytest.fixture
def sched(monkeypatch):
    """Both packages' ingest pipelines and verify schedulers active on the
    device-runner seam (the host oracle)."""
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "tpu")
    monkeypatch.delenv("COMETBFT_TPU_TXINGEST", raising=False)
    monkeypatch.delenv("COMETBFT_TPU_VERIFY_SCHED", raising=False)
    monkeypatch.setattr(tservice, "backend_trusted", lambda: True)
    monkeypatch.setattr(tvs, "backend_trusted", lambda: True)
    real = tservice.VerifyScheduler
    monkeypatch.setattr(tservice, "VerifyScheduler",
                        lambda **kw: real(**{"device": "cpu", **kw}))
    for p in BOTH:
        _reset(p)
        p.sup.set_device_runner(_oracle_runner(p.ref))
    tds.reset()
    yield
    for p in BOTH:
        _reset(p)


# -- envelopes ---------------------------------------------------------------


@pytest.mark.parametrize("nonce,payload", [(0, b""), (1, b"a=1"), (2**64 - 1, b"k=" + bytes(300))])
def test_envelope_and_sign_bytes_equal(nonce, payload):
    jp, tp = _ed_privs(J, 1)[0], _ed_privs(T, 1)[0]
    jtx, ttx = jev.sign_tx(jp, payload, nonce), tev.sign_tx(tp, payload, nonce)
    assert jtx == ttx
    je, te = jev.decode(jtx), tev.decode(ttx)
    assert je.sign_bytes() == te.sign_bytes()
    assert (je.key_type, je.pubkey, je.nonce, je.payload, je.signature) == (
        te.key_type, te.pubkey, te.nonce, te.payload, te.signature)
    stx = tev.sign_tx(SECP, payload, nonce)
    js, ts = jev.decode(stx), tev.decode(stx)
    assert jev.encode(js) == tev.encode(ts) == stx
    assert js.sign_bytes() == ts.sign_bytes()
    assert js.pub_key().verify_signature(js.sign_bytes(), js.signature)


@pytest.mark.parametrize("tx", [
    b"a=1", tev.MAGIC, tev.MAGIC + b"\x99" + b"x" * 120,
    tev.MAGIC + b"\x01" + b"\x00" * 8 + b"short",
    tev.MAGIC + b"\x02" + b"\x00" * 8 + b"\x02" * 33 + b"s" * 63])
def test_decode_errors_equal(tx):
    got = []
    for ev in (jev, tev):
        with pytest.raises(ev.EnvelopeError) as e:
            ev.decode(tx)
        got.append(str(e.value))
    assert got[0] == got[1]


def test_codes_and_rejections_equal():
    assert (jev.CODE_BAD_ENVELOPE, jev.CODE_BAD_SIGNATURE, jev.CODE_STALE_NONCE,
            jev.CODESPACE, jev.MAGIC) == (tev.CODE_BAD_ENVELOPE, tev.CODE_BAD_SIGNATURE,
                                          tev.CODE_STALE_NONCE, tev.CODESPACE, tev.MAGIC)
    for args, f in (((("truncated",),), "reject_bad_envelope"), (((),), "reject_bad_signature"),
                    (((7, 9),), "reject_stale_nonce")):
        (a,) = args
        assert (jcodec.encode_response("check_tx", getattr(jev, f)(*a))
                == tcodec.encode_response("check_tx", getattr(tev, f)(*a)))


# -- SigVerifyingApp -----------------------------------------------------------


def test_sig_verifying_app_responses_equal(host):
    txs = _mix(24, SEED)[:24]
    got = {}
    for p in BOTH:
        app = p.ti.SigVerifyingApp(p.kv.KVStoreApplication(), **p.cpu)
        at = p.ti.envelope.at
        frames = [p.codec.encode_response("info", app.info(at.InfoRequest()))]
        for tx in txs:
            frames.append(p.codec.encode_response(
                "check_tx", app.check_tx(at.CheckTxRequest(tx=tx))))
        frames.append(p.codec.encode_response("check_txs", app.check_txs(
            at.CheckTxsRequest(requests=[at.CheckTxRequest(tx=tx) for tx in txs]))))
        good = [tx for tx, r in zip(txs, app.check_txs(at.CheckTxsRequest(
            requests=[at.CheckTxRequest(tx=tx) for tx in txs])).responses) if r.ok]
        frames.append(p.codec.encode_response("prepare_proposal", app.prepare_proposal(
            at.PrepareProposalRequest(max_tx_bytes=1 << 20, txs=good, height=1))))
        for body in (good, txs):
            frames.append(p.codec.encode_response("process_proposal", app.process_proposal(
                at.ProcessProposalRequest(txs=body, height=1))))
        frames.append(p.codec.encode_response("finalize_block", app.finalize_block(
            at.FinalizeBlockRequest(txs=txs, height=1))))
        got[p.name] = frames
    assert got["jax"] == got["torch"]


def test_sig_verifying_app_takes_the_card_by_default(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND", raising=False)
    with pytest.raises(Exception, match="(?i)cuda|device|card"):
        tti.SigVerifyingApp(tkv.KVStoreApplication())
    assert tti.SigVerifyingApp(tkv.KVStoreApplication(), device="cpu").device == "cpu"
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert tti.SigVerifyingApp(tkv.KVStoreApplication()).device is None


# -- batched admission ---------------------------------------------------------


def _admit_batched(p, txs, via_coalescer: bool, **cfg):
    conn, mp, _ = _stack(p, **cfg)
    if not via_coalescer:
        return [_outcome(r) for r in mp.check_tx_batch(txs)], mp, conn
    order = []
    ing = p.ti.IngestCoalescer(mp, batch_max=16, queue_cap=len(txs) + 1, start_thread=False,
                               on_result=lambda s, r: order.append(r), **p.cpu)
    out = []
    for tx in txs:
        try:
            r = ing.submit(tx, sender="")
        except p.mp.MempoolError as e:
            out.append(_outcome(e))
            continue
        out.append(None if r is None else _outcome(r))
    ing.flush_now()
    it = iter(order)
    return [o if o is not None else _outcome(next(it)) for o in out], mp, conn


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_check_tx_batch_equals_sequential_and_jax_host(host, seed):
    txs = _mix(48, SEED + seed)
    _, seq_mp, _ = _stack(T)
    seq = _per_tx(T, seq_mp, txs)
    got = {}
    for p in BOTH:
        out, mp, _ = _admit_batched(p, txs, False)
        got[p.name] = (out, _state(mp), _lru(mp))
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (seq, _state(seq_mp))


@pytest.mark.parametrize("seed", [5, 11])
def test_check_tx_batch_equals_sequential_and_jax_scheduler(sched, seed):
    """The same differential with both schedulers active: envelope
    signatures ride the mempool class through the runner seam; the
    coalescer admits in chunks of 16."""
    txs = _mix(40, SEED + seed)
    got = {}
    for p in BOTH:
        out, mp, conn = _admit_batched(p, txs, True)
        got[p.name] = (out, _state(mp), _lru(mp))
        assert conn.check_txs_calls <= 4
    assert tvs.stats.snapshot()["submitted"]["bulk"] > 0
    _, seq_mp, _ = _stack(T)
    tsc.reset_cache()
    seq = _per_tx(T, seq_mp, txs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (seq, _state(seq_mp))


def test_duplicate_of_rejected_tx_and_full_and_pre_check(host):
    privs = _ed_privs(T)
    good = [tev.sign_tx(privs[0], b"d%d=%d" % (i, i), nonce=i) for i in range(8)]
    e = tev.decode(good[1])
    forged = tev.encode(tev.Envelope(e.key_type, e.pubkey, 99, e.payload, e.signature))
    cases = [([good[0], forged, forged, good[0]], {}), (good, {"size": 5})]
    for txs, cfg in cases:
        got = {}
        for p in BOTH:
            out, mp, _ = _admit_batched(p, txs, False, **cfg)
            got[p.name] = (out, _state(mp), _lru(mp))
        _, seq_mp, _ = _stack(T, **cfg)
        assert got["torch"] == got["jax"]
        assert got["torch"][:2] == (_per_tx(T, seq_mp, txs), _state(seq_mp))
    got = {}
    for p in BOTH:
        _, mp, _ = _stack(p)
        mp.pre_check = lambda tx, ev=p.ev: None if ev.is_envelope(tx) else "envelopes only"
        got[p.name] = [_outcome(r) for r in mp.check_tx_batch([good[2], b"plain=1", good[3]])]
    assert got["jax"] == got["torch"] and got["torch"][1] == ("err", "PreCheckError")


# -- batched recheck -----------------------------------------------------------


@pytest.mark.parametrize("enabled", [True, False])
def test_batched_recheck_equals_jax(host, monkeypatch, enabled):
    monkeypatch.setenv("COMETBFT_TPU_TXINGEST", "1" if enabled else "0")
    privs = _ed_privs(T)
    txs = [tev.sign_tx(privs[i % 3], b"r%d=%d" % (i, i), nonce=i) for i in range(6)]
    got = {}
    for p in BOTH:
        conn, mp, app = _stack(p, recheck=True)
        for tx in txs:
            assert mp.check_tx(tx).ok
        before = conn.check_tx_calls
        mp.update(1, [txs[0]], [p.ti.envelope.at.ExecTxResult(code=0)])
        got[p.name] = (_state(mp), conn.check_txs_calls, conn.check_tx_calls - before,
                       p.stats.snapshot()["recheck_batches"],
                       p.stats.snapshot()["recheck_txs"])
    assert got["jax"] == got["torch"]
    assert got["torch"][1:3] == ((1, 0) if enabled else (0, 5))


# -- the ingest coalescer ------------------------------------------------------


def test_coalescer_takes_the_card_by_default(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND", raising=False)
    monkeypatch.setenv("COMETBFT_TPU_TXINGEST", "1")
    mp = tmp.CListMempool(tcfg.MempoolConfig(), CountingConn(None))
    with pytest.raises(Exception, match="(?i)cuda|device|card"):
        tti.IngestCoalescer(mp, start_thread=False)
    ing = tti.IngestCoalescer(mp, start_thread=False, device="cpu")
    assert ing.device == "cpu" and not ing.active()  # no trusted card: per tx


def _coalescer_run(p, script):
    conn, mp, _ = _stack(p)
    got = []
    ing = p.ti.IngestCoalescer(mp, on_result=lambda s, r: got.append((s, _outcome(r))),
                               **script["kw"], **p.cpu)
    sync = []
    try:
        # a live flusher takes the coalescer's lock to flush: holding it over
        # the submits makes the batch the deadline flushes the same in both
        # packages, whatever the wall clock does between two submits
        with ing._cond if script.get("hold") else contextlib.nullcontext():
            for i, tx in enumerate(script["txs"]):
                try:
                    r = ing.submit(tx, sender="p%d" % i)
                except p.mp.MempoolError as e:
                    r = e
                sync.append(None if r is None else _outcome(r))
        if script.get("wait"):
            deadline = time.monotonic() + 10
            while len(got) < script["wait"] and time.monotonic() < deadline:
                time.sleep(0.005)
        flushed_before_close = p.stats.snapshot()["flushes"]
        n = ing.flush_now() if script.get("flush") else 0
    finally:
        ing.close()
    snap = p.stats.snapshot()
    return {"sync": sync, "flushed": got, "n": n, "state": _state(mp),
            "calls": (conn.check_txs_calls, conn.check_tx_calls),
            "before_close": flushed_before_close,
            "stats": {k: snap[k] for k in ("enqueued", "shed_to_sync", "flushes",
                                           "flush_txs", "app_batches", "sig_prechecked",
                                           "rejected", "errors", "cache_hits")}}


def _scripts():
    privs = _ed_privs(T)
    ed = [tev.sign_tx(privs[i % 3], b"c%d=%d" % (i, i), nonce=10 + i) for i in range(12)]
    replay = tev.sign_tx(privs[0], b"replayed=1", nonce=10)  # at a used nonce
    return {
        "size": {"kw": {"batch_max": 4, "queue_cap": 64, "start_thread": False},
                 "txs": ed[:10], "flush": True},
        "deadline": {"kw": {"flush_us": 1000, "queue_cap": 64}, "txs": ed[:3], "wait": 3,
                     "hold": True},
        "shed": {"kw": {"queue_cap": 2, "start_thread": False}, "txs": ed[:4], "flush": True},
        "nonce": {"kw": {"batch_max": 4, "start_thread": False}, "txs": ed[:6], "flush": True,
                  "then": [replay, ed[0], ed[6]]},
        "close": {"kw": {"start_thread": False}, "txs": ed[:5]},
    }


@pytest.mark.parametrize("name", ["size", "deadline", "shed", "nonce", "close"])
def test_coalescer_equals_jax(sched, name):
    """Size and deadline flushes, shed to sync, a replay at a verified
    nonce (103) and a cache dup, and ``close`` draining: the same verdicts,
    contents, round trips and counters in both packages."""
    script = _scripts()[name]
    got = {}
    for p in BOTH:
        _reset(p)
        p.sup.set_device_runner(_oracle_runner(p.ref))
        out = _coalescer_run(p, script)
        if "then" in script:
            conn, mp, _ = _stack(p)
            ing = p.ti.IngestCoalescer(mp, batch_max=4, start_thread=False, **p.cpu)
            res = []
            for tx in script["txs"] + script["then"]:
                try:
                    r = ing.submit(tx)
                except p.mp.MempoolError as e:
                    r = e
                res.append(None if r is None else _outcome(r))
                ing.flush_now()
            ing.close()
            out["then"] = (res, _state(mp))
        got[p.name] = out
    assert got["jax"] == got["torch"]
    t = got["torch"]
    if name == "size":
        assert t["calls"] == (3, 0) and t["stats"]["flushes"] == 3
    if name == "deadline":
        assert t["before_close"] >= 1 and len(t["flushed"]) == 3
    if name == "shed":
        assert t["stats"]["shed_to_sync"] == 2 and t["sync"][2:] != [None, None]
    if name == "nonce":
        res = t["then"][0]
        assert res[6][1] == tev.CODE_STALE_NONCE and res[7] == ("err", "TxInCacheError")
    if name == "close":
        assert t["state"][1] == 5


def test_batch_failure_readmits_per_tx(sched, monkeypatch):
    """``_flush_chunk``'s parity path: a batch that raises is logged and
    re-admitted tx by tx in both packages."""
    privs = _ed_privs(T)
    txs = [tev.sign_tx(privs[0], b"b%d=1" % i, nonce=i) for i in range(2)]
    got = {}
    for p in BOTH:
        _, mp, _ = _stack(p)
        out = []
        ing = p.ti.IngestCoalescer(mp, start_thread=False,
                                   on_result=lambda s, r: out.append(_outcome(r)), **p.cpu)
        monkeypatch.setattr(mp, "check_tx_batch",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        for tx in txs:
            assert ing.submit(tx) is None
        ing.flush_now()
        got[p.name] = (out, mp.size())
    assert got["jax"] == got["torch"] == ([("resp", 0, "", "")] * 2, 2)


class _Peer:
    def __init__(self, pid):
        self.id = pid


def test_reactor_ingest_accounting_equals_jax(sched):
    """The mempool reactor hands gossip to the coalescer; flush-time
    verdicts land in the per-peer counts through ``_note_flush_result``."""
    privs = _ed_privs(T)
    txs = [tev.sign_tx(privs[i % 3], b"g%d=1" % i, nonce=i) for i in range(4)]
    e = tev.decode(txs[1])
    txs.append(tev.encode(tev.Envelope(e.key_type, e.pubkey, 77, e.payload, e.signature)))
    txs.append(txs[0])
    got = {}
    for p in BOTH:
        _, mp, _ = _stack(p)
        ing = p.ti.IngestCoalescer(mp, start_thread=False, **p.cpu)
        r = p.mr.MempoolReactor(p.cfg.MempoolConfig(), mp, ingest=ing)
        assert ing.on_result == r._note_flush_result
        for i, tx in enumerate(txs):
            r.receive(0x30, _Peer("peer%d" % (i % 2)), tx)
        ing.flush_now()
        got[p.name] = (r.peer_ingest_stats(), _state(mp))
    assert got["jax"] == got["torch"]
    assert got["torch"][0] == {"peer0": {"accepted": 2, "dedup": 0, "rejected": 1, "error": 0},
                               "peer1": {"accepted": 2, "dedup": 1, "rejected": 0, "error": 0}}


def test_sender_threads_keep_nonce_order(sched):
    """Two client threads, each its own senders in nonce order, through the
    port's coalescer thread: no tx of a sender is refused as stale."""
    privs = _ed_privs(T, 4)
    _, mp, _ = _stack(T, size=5000)
    ing = tti.IngestCoalescer(mp, batch_max=8, flush_us=500, device="cpu")
    res = []

    def client(k):
        for n in range(10):
            tx = tev.sign_tx(privs[k], b"t%d-%d=1" % (k, n), nonce=n)
            r = ing.submit(tx, sender="c%d" % k)
            if r is not None:
                res.append(r)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    ing.close()
    assert res == [] and mp.size() == 40
