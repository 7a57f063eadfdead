"""The port's flight recorder (``cometbft_tpu_torch/libs/tracing.py``)
against the JAX package's (``cometbft_tpu/libs/tracing.py``).

One scripted sequence runs through each package's process-wide tracer on
the same injected clock: nested spans, spans on other threads, a span an
exception leaves, ``begin``/``finish``/``under``/``adopt`` and a
retroactive ``record_span``, ``TraceContext`` tokens (garbage included),
the ring bound, anomalies under each dump setting (no directory, first per
kind, ``COMETBFT_TPU_TRACE_DUMP_ALL``, ``COMETBFT_TPU_TRACE_DUMP_SPANS``)
and the kill switch ``COMETBFT_TPU_TRACE=0``.  The span streams (as
JSON), the dump files (byte for byte), the tracing half of
``trace_document`` and ``summary_line`` must be equal.  Left out of the
comparison, because each measures this process's wall clock or its
history: ``overhead_seconds`` and the recorder overhead of
``summary_line`` (``WALL_CLOCK``).

Then the sites on the device-runner seam: the scheduler's ``sched.flush``
(with its queue wait in ``verifysched/stats``) and the supervisor's
watchdog fire, whose dump names the dispatch triple, against the JAX
package with the tiers mapped (``TIER``); and on a stand-in card (CUDA
reported available, the runner seam) the dump names ``tier="cuda"``.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from cometbft_tpu.crypto import backend_health as jbh
from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.crypto import sigcache as jsc
from cometbft_tpu.libs import tracing as jtr
from cometbft_tpu.ops import dispatch_stats as jds
from cometbft_tpu.ops import supervisor as jsup
from cometbft_tpu.verifysched import stats as jss
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.libs import tracing as ttr
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.verifysched import stats as tss

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
TR = {"cometbft_tpu": jtr, "cometbft_tpu_torch": ttr}
# the JAX package's device tiers and the port's
TIER = {"pallas": "cuda", "xla": "torch", "host": "host"}
# what measures this process's wall clock or history, not the sequence
WALL_CLOCK = ("overhead_seconds", "lifetime", "overhead_s")
ENV = ("COMETBFT_TPU_TRACE", "COMETBFT_TPU_TRACE_DIR", "COMETBFT_TPU_TRACE_DUMP_ALL",
       "COMETBFT_TPU_TRACE_DUMP_SPANS", "COMETBFT_TPU_TRACE_RING",
       "COMETBFT_TPU_TRACE_XNODE")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for tr in TR.values():
        tr.reset_tracer()
    yield
    for tr in TR.values():
        tr.reset_tracer()


class _Clock:
    """A clock that moves 1.25 ms on every read."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 0.00125
        return self.t


TOKENS = ("1f.2a.3", "1f.2a.", "a.b.c", "0.5.1", "5.0.", "1.2", "x", "", None, 42,
          "ff.ee.-1", "1.2.3.4")


def _script(tr, root, monkeypatch) -> dict:
    """The scripted sequence; returns what must be equal across packages."""
    out: dict = {}
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    tracer = tr.get_tracer()
    tracer.set_clock(_Clock())
    # nested spans and attributes set mid-span
    with tr.span("verify.commit", height=3, sigs=4) as sp:
        with tr.span("verify.batch", n=4):
            with tr.span("verify.dispatch", tier="t", lanes=4, n=4, dispatch=1):
                pass
        sp.set(entries=4)
    # spans on other threads: separate stacks, separate traces
    for i in range(3):
        th = threading.Thread(target=lambda i=i: _thread_spans(tr, i))
        th.start()
        th.join(10)
    # a span an exception leaves
    try:
        with tr.span("sched.flush", reason="size", items=2):
            raise ValueError("boom")
    except ValueError:
        pass
    # explicit spans: a round anchor, children under it, adoption
    anchor = tracer.begin("consensus.round", h=5, r=0, node=1)
    with tracer.under(anchor):
        with tr.span("consensus.vote", h=5, r=0, t=1):
            pass
    tracer.record_span("consensus.step", 100.5, 100.75, parent=anchor, h=5, r=0,
                       step="propose")
    other = tracer.begin("consensus.round", h=5, r=0, node=2)
    ctx = tracer.ctx_for(anchor, origin=1)
    out["adopted"] = [tracer.adopt(other, ctx), tracer.adopt(other, ctx),
                      tracer.adopt(anchor, tr.TraceContext(7, 9, 3))]
    with tracer.under(other):
        with tr.span("verify.commit", height=5):
            pass
    tracer.finish(other, committed=True)
    tracer.finish(anchor, committed=True)
    # trace contexts: encode, decode, garbage
    out["tokens"] = [None if (c := tr.TraceContext.decode(t)) is None else c.encode()
                     for t in TOKENS]
    out["ctx"] = ctx.encode()
    # anomalies: no directory (counted), first per kind, dump-all, spans cut
    tracer.record_anomaly("watchdog_fire", tier="t", lanes=4, dispatch=1)
    monkeypatch.setenv("COMETBFT_TPU_TRACE_DIR", str(root / "dumps"))
    tracer.record_anomaly("watchdog_fire", tier="t", lanes=4, dispatch=2)
    tracer.record_anomaly("watchdog_fire", tier="t", lanes=8, dispatch=3)
    tracer.record_anomaly("breaker_open", backend="t", opens=1, error="E")
    monkeypatch.setenv("COMETBFT_TPU_TRACE_DUMP_ALL", "1")
    monkeypatch.setenv("COMETBFT_TPU_TRACE_DUMP_SPANS", "3")
    tracer.record_anomaly("breaker_open", backend="t", opens=2, error="E")
    monkeypatch.delenv("COMETBFT_TPU_TRACE_DUMP_ALL")
    monkeypatch.delenv("COMETBFT_TPU_TRACE_DUMP_SPANS")
    # the kill switch: no span, no dump, still counted
    monkeypatch.setenv("COMETBFT_TPU_TRACE", "0")
    with tr.span("light.chain", headers=1) as sp:
        sp.set(sigs=1)
    tracer.record_anomaly("quarantine", tier="t", n=2)
    out["disabled_doc"] = _doc(tr)
    monkeypatch.delenv("COMETBFT_TPU_TRACE")
    out["spans"] = json.dumps(tracer.tail(0), sort_keys=True)
    out["dumps"] = {p.name: p.read_bytes()
                    for p in sorted((root / "dumps").iterdir())}
    out["doc"] = _doc(tr)
    out["summary"] = tr.summary_line().rsplit(" overhead_s=", 1)[0]
    return out


def _thread_spans(tr, i: int) -> None:
    with tr.span("sched.flush", reason="timer", items=i + 1):
        with tr.span("sched.dispatch", items=i + 1, lanes=32):
            pass


def _doc(tr) -> str:
    """The tracing half of ``trace_document`` (the health sections read
    each package's own stats modules) without ``WALL_CLOCK``."""
    doc = tr.trace_document(max_spans=64, rounds=8)
    keep = {k: doc[k] for k in ("tracing", "stages", "rounds", "spans")}
    for k in WALL_CLOCK:
        keep["tracing"].pop(k, None)
    return json.dumps(keep, sort_keys=True)


def test_scripted_sequence_equal_in_both_tracers(tmp_path, monkeypatch):
    got = {pkg: _script(TR[pkg], tmp_path / pkg, monkeypatch) for pkg in PKGS}
    j, p = got[PKGS[0]], got[PKGS[1]]
    assert set(j) == set(p)
    for key in j:
        assert p[key] == j[key], key
    spans = json.loads(p["spans"])
    assert [s["stage"] for s in spans][:3] == [
        "verify.dispatch", "verify.batch", "verify.commit"]
    assert spans[2]["attrs"]["entries"] == 4
    assert len({s["trace"] for s in spans if s["stage"] == "sched.dispatch"}) == 3
    err = [s for s in spans if s["attrs"].get("error") == "ValueError"]
    assert len(err) == 1 and err[0]["stage"] == "sched.flush"
    assert p["adopted"] == [True, False, True]
    assert p["tokens"][0] == "1f.2a.3" and p["tokens"][1] == "1f.2a."
    assert p["tokens"][2:10] == [None] * 8 and p["tokens"][10] == "ff.ee.-1"
    assert p["tokens"][11] is None
    # dumps: the first watchdog fire (with a directory), the first breaker
    # open, then the breaker open again under dump-all with 3 spans
    assert list(p["dumps"]) == ["trace-001-watchdog_fire.jsonl",
                                "trace-002-breaker_open.jsonl",
                                "trace-003-breaker_open.jsonl"]
    head = json.loads(p["dumps"]["trace-003-breaker_open.jsonl"].splitlines()[0])
    assert head["spans"] == 3 and head["attrs"]["opens"] == 2
    doc = json.loads(p["doc"])
    assert doc["tracing"]["anomalies"] == {"watchdog_fire": 3, "breaker_open": 2,
                                           "quarantine": 1}
    assert "light.chain" not in json.loads(p["disabled_doc"])["stages"]
    assert not json.loads(p["disabled_doc"])["tracing"]["enabled"]
    assert "light.chain" not in {s["stage"] for s in spans}


@pytest.mark.parametrize("ring", [16, 40])
def test_ring_bound_counts_drops_in_both(ring, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_TRACE_RING", str(ring))
    snaps = []
    for pkg in PKGS:
        tr = TR[pkg]
        tr.reset_tracer()
        tr.get_tracer().set_clock(_Clock())
        for i in range(50):
            with tr.span("verify.dispatch", n=i):
                pass
        snap = tr.get_tracer().snapshot()
        snaps.append(({k: v for k, v in snap.items() if k not in WALL_CLOCK},
                      tr.get_tracer().tail(0)))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["spans_dropped"] == 50 - ring == 50 - len(snaps[1][1])


def test_anomaly_kinds_and_sinks_equal():
    assert ttr.ANOMALY_KINDS == jtr.ANOMALY_KINDS
    for tr in TR.values():
        seen = []
        prev = {k: tr.set_sink(k, (lambda *a, k=k: seen.append((k, len(a)))))
                for k in ("span", "open", "anomaly", "event")}
        try:
            tr.get_tracer().set_clock(_Clock())
            sp = tr.get_tracer().begin("consensus.round", h=1, r=0)
            with tr.span("verify.commit"):
                pass
            tr.get_tracer().finish(sp)
            tr.record_anomaly("queue_shed", cls="bulk")
            tr.note_event("breaker_close", backend="x")
        finally:
            for k, fn in prev.items():
                tr.set_sink(k, fn)
        assert seen == [("open", 1), ("span", 1), ("span", 1), ("anomaly", 3),
                        ("event", 2)]


# -- the sites on the device-runner seam ---------------------------------------


def _runner(oracle):
    def run(backend, pubs, msgs, sigs, lanes):
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [oracle.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
        return out

    return run


def _triples(n: int, tag: bytes):
    import hashlib

    out = []
    for i in range(n):
        seed = hashlib.sha256(b"%s-%d" % (tag, i)).digest()
        msg = b"%s-msg-%d" % (tag, i)
        out.append((tref.pubkey_from_seed(seed), msg, tref.sign(seed, msg)))
    return [list(x) for x in zip(*out)]


def _reset_all():
    for bh, sup, ds, ss, sc in ((jbh, jsup, jds, jss, jsc), (tbh, tsup, tds, tss, tsc)):
        bh.reset()
        sup.clear_fault_injector()
        sup.clear_device_runner()
        ds.reset()
        ss.reset()
        sc.reset_cache()


@pytest.fixture
def seam(monkeypatch):
    """Both supervisors on their runner seam with a two-tier device chain
    (``tests/test_torch_supervisor.py``'s set-up) and each tracer fresh."""
    _reset_all()
    monkeypatch.setattr(jsup, "device_chain", lambda: ("pallas", "xla"))
    monkeypatch.setattr(tsup, "device_chain", lambda device=None: ("cuda", "torch"))
    jsup.set_device_runner(_runner(jref))
    tsup.set_device_runner(_runner(tref))
    yield
    _reset_all()


def _dump_lines(root) -> list:
    (path,) = sorted(root.iterdir())
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_watchdog_fire_dump_names_the_dispatch_triple_as_jax(seam, tmp_path,
                                                              monkeypatch):
    from cometbft_tpu.ops import verify as jov
    from cometbft_tpu_torch.ops import verify as tov

    monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "60")
    pubs, msgs, sigs = _triples(3, b"wd")
    heads, stages = {}, {}
    for pkg, sup, ov, kw in ((PKGS[0], jsup, jov, {}),
                             (PKGS[1], tsup, tov, {"device": "cpu"})):
        monkeypatch.setenv("COMETBFT_TPU_TRACE_DIR", str(tmp_path / pkg))
        TR[pkg].get_tracer().set_clock(_Clock())
        sup.set_fault_injector(sup.FaultyBackend("hang", hang_s=0.3))
        try:
            assert ov.verify_batch(pubs, msgs, sigs, **kw).all()
        finally:
            sup.clear_fault_injector()
        lines = _dump_lines(tmp_path / pkg)
        heads[pkg] = lines[0]
        failed = [s for s in lines[1:] if s["stage"] == "verify.dispatch"
                  and s["attrs"].get("error") == "DispatchTimeoutError"]
        assert failed and failed[-1]["attrs"]["dispatch"] == lines[0]["attrs"]["dispatch"]
        stages[pkg] = [s["stage"] for s in TR[pkg].get_tracer().tail(0)]
        time.sleep(0.35)  # the abandoned workers finish before the next package
    j, p = heads[PKGS[0]], heads[PKGS[1]]
    assert p["anomaly"] == j["anomaly"] == "watchdog_fire"
    # the lanes of the JAX tier are its padding bucket; the port's kernel
    # takes a batch unpadded and its plain version pads to the same bucket
    assert p["attrs"]["tier"] == TIER[j["attrs"]["tier"]] == "cuda"
    assert p["attrs"]["n"] == j["attrs"]["n"] == 3
    assert p["attrs"]["dispatch"] == j["attrs"]["dispatch"] == 1
    assert p["attrs"]["lanes"] == 3
    assert stages[PKGS[1]] == stages[PKGS[0]]


def test_sched_flush_span_and_queue_wait_as_jax(seam, monkeypatch):
    from cometbft_tpu import verifysched as jvs
    from cometbft_tpu_torch import verifysched as tvs
    from cometbft_tpu_torch.verifysched import service as tservice

    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "tpu")
    monkeypatch.delenv("COMETBFT_TPU_VERIFY_SCHED", raising=False)
    monkeypatch.setattr(tservice, "backend_trusted", lambda: True)
    real = tservice.VerifyScheduler
    monkeypatch.setattr(tservice, "VerifyScheduler",
                        lambda *a, **k: real(*a, **{**k, "device": "cpu"}))
    pubs, msgs, sigs = _triples(3, b"fl")
    got = {}
    for pkg, vs, ss in ((PKGS[0], jvs, jss), (PKGS[1], tvs, tss)):
        vs.reset_scheduler()
        try:
            sched = vs.get_scheduler()
            sched.pause()
            futs = [sched.submit(p, m, s, vs.PRIO_CONSENSUS)
                    for p, m, s in zip(pubs, msgs, sigs)]
            time.sleep(0.05)  # queue wait accrues while paused
            sched.resume()
            assert [f.result(timeout=30) for f in futs] == [True] * 3
        finally:
            vs.reset_scheduler()
        flushes = [s for s in TR[pkg].get_tracer().tail(0)
                   if s["stage"] in ("sched.flush", "sched.dispatch", "sched.fetch")]
        snap = ss.snapshot()
        got[pkg] = ([(s["stage"], {k: v for k, v in s["attrs"].items() if k != "lanes"})
                     for s in flushes],
                    snap["queue_wait_hist"]["consensus"]["count"])
        assert snap["queue_wait_seconds"]["consensus"] >= 0.05 * 3
    assert got[PKGS[1]] == got[PKGS[0]]
    spans, waits = got[PKGS[1]]
    assert [st for st, _ in spans] == ["sched.dispatch", "sched.flush", "sched.fetch"]
    assert spans[1][1]["items"] == 3 and spans[1][1]["misses"] == 3 and waits == 3


def test_watchdog_fire_on_a_stand_in_card_names_cuda(tmp_path, monkeypatch):
    """On a stand-in card (CUDA reported available, the kernel's library
    load a no-op, the runner seam as the device) a hung launch raises
    ``BackendError`` and its dump names ``tier="cuda"``."""
    import torch

    from cometbft_tpu_torch.crypto.backend_health import BackendError
    from cometbft_tpu_torch.ops import verify as tov

    _reset_all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsup, "_load_libraries", lambda dev: None)
    monkeypatch.setenv("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "60")
    monkeypatch.setenv("COMETBFT_TPU_TRACE_DIR", str(tmp_path))
    tsup.set_device_runner(_runner(tref))
    tsup.set_fault_injector(tsup.FaultyBackend("hang", hang_s=0.3))
    pubs, msgs, sigs = _triples(4, b"card")
    try:
        with pytest.raises(BackendError):
            tov.verify_batch(pubs, msgs, sigs, device="cuda")
    finally:
        _reset_all()
    time.sleep(0.35)
    head = _dump_lines(tmp_path)[0]
    assert head["anomaly"] == "watchdog_fire"
    assert head["attrs"] == {"tier": "cuda", "lanes": 4, "n": 4, "dispatch": 1}
