"""The port's black box (``cometbft_tpu_torch/libs/blackbox.py``) against
the JAX package's (``cometbft_tpu/libs/blackbox.py``).

The same record stream (spans, round opens, anomalies, events and a
boot record, from each package's tracer on one injected clock) goes
through a synchronous journal of each package: the segment files are
equal byte for byte across a rotation.  Each package decodes the other's
journal, whole and damaged (a torn tail, a CRC failure mid-stream, a bad
length field), to the same records and the same ``postmortem_report``,
on a node home directory too, where a later "boot" record retires the
earlier incarnation's in-flight round.  Then the port alone: records a
full queue drops are counted and never block the caller, an anomaly is
durable before ``append`` returns, and the kill switch
``COMETBFT_TPU_BLACKBOX=0`` leaves the RAM-only recorder.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time

import pytest

from cometbft_tpu.libs import blackbox as jbb
from cometbft_tpu.libs import tracing as jtr
from cometbft_tpu_torch.libs import blackbox as tbb
from cometbft_tpu_torch.libs import tracing as ttr

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
BB = {"cometbft_tpu": jbb, "cometbft_tpu_torch": tbb}
TR = {"cometbft_tpu": jtr, "cometbft_tpu_torch": ttr}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("COMETBFT_TPU_BLACKBOX", "COMETBFT_TPU_TRACE", "COMETBFT_TPU_TRACE_DIR"):
        monkeypatch.delenv(k, raising=False)
    for tr in TR.values():
        tr.reset_tracer()
    yield
    for pkg in PKGS:
        BB[pkg].close_journal(clean=True)
        TR[pkg].reset_tracer()


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self) -> float:
        self.t += 0.0005
        return self.t


def _stream(pkg: str, journal, heights: int = 12, finish_last: bool = True) -> None:
    """A node's life through the tracer's sinks into ``journal``: a boot
    record, then per height a round anchor, steps, verify spans, quorum
    events, a commit; anomalies and breaker events on the way."""
    tr = TR[pkg]
    tracer = tr.get_tracer()
    clock = _Clock()
    tracer.set_clock(clock)
    journal.clock = clock
    prev = {k: tr.set_sink(k, fn) for k, fn in (
        ("span", journal.on_span), ("open", journal.on_open),
        ("anomaly", journal.on_anomaly), ("event", journal.on_event))}
    try:
        journal.on_event("boot", {"node": 0, "height": 0})
        for h in range(1, heights + 1):
            anchor = tracer.begin("consensus.round", h=h, r=0, node=0)
            with tracer.under(anchor):
                with tr.span("verify.commit", height=h, sigs=4, count_all=True):
                    with tr.span("verify.dispatch", tier="cuda", lanes=4, n=4,
                                 dispatch=h):
                        pass
                tr.note_event("quorum", h=h, r=0, node=0, key="q_prevote_ms", ms=1.5)
            tracer.record_span("consensus.step", clock.t - 0.001, clock.t,
                               parent=anchor, h=h, r=0, step="propose", node=0)
            if h % 4 == 0:
                tr.record_anomaly("watchdog_fire", tier="cuda", lanes=4, n=4,
                                  dispatch=h)
                tr.note_event("breaker_close", backend="cuda", repromotions=h // 4)
            if h < heights or finish_last:
                tracer.finish(anchor, committed=True)
                journal.on_event("commit", {"height": h})
    finally:
        for k, fn in prev.items():
            tr.set_sink(k, fn)


def _journal(pkg: str, d, **kw):
    return BB[pkg].BlackboxJournal(str(d), threaded=False, health_every=None,
                                   segment_bytes=4096, segments=3, **kw)


def _files(d) -> dict:
    return {os.path.basename(p): open(p, "rb").read() for p in BB[PKGS[1]].segment_files(str(d))}


def test_same_stream_gives_equal_segment_files_across_a_rotation(tmp_path):
    out = {}
    for pkg in PKGS:
        j = _journal(pkg, tmp_path / pkg)
        _stream(pkg, j, heights=30)
        j.close(clean=True)
        out[pkg] = (_files(tmp_path / pkg), j.stats())
    assert out[PKGS[1]] == out[PKGS[0]]
    files, stats = out[PKGS[1]]
    assert stats["rotations"] >= 2 and len(files) == 3  # pruned to 3 segments
    assert stats["dropped"] == 0


def _damage(d, how: str) -> None:
    head = os.path.join(str(d), "blackbox.journal")
    data = bytearray(open(head, "rb").read())
    if how == "torn":
        data = data[:-5]
    elif how == "crc":
        data[len(data) // 2] ^= 0xFF
    elif how == "length":
        # the length field of the head segment's third frame
        pos = 0
        for _ in range(2):
            (ln,) = struct.unpack_from(">I", data, pos + 4)
            pos += 8 + ln
        struct.pack_into(">I", data, pos + 4, 0x7FFFFFF0)
    open(head, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["whole", "torn", "crc", "length"])
def test_each_package_decodes_the_others_journal(tmp_path, how):
    reports = {}
    for writer in PKGS:
        d = tmp_path / writer
        j = _journal(writer, d)
        _stream(writer, j, heights=9, finish_last=False)
        j.kill() if how != "whole" else j.close(clean=True)
        if how not in ("whole",):
            _damage(d, how)
        for reader in PKGS:
            recs, stats = BB[reader].decode_dir(str(d))
            rep = BB[reader].postmortem_report(str(d))
            reports[(writer, reader)] = json.dumps([recs, stats, rep], sort_keys=True)
    assert len(set(reports.values())) == 1
    recs, stats, rep = json.loads(reports[(PKGS[1], PKGS[0])])
    if how == "whole":
        assert rep["clean_close"] and not stats["torn_tail"]
        assert stats["corrupt_skipped"] == 0
    else:
        assert not rep["clean_close"]
        assert rep["in_flight"]["h"] == 9
    if how == "torn":
        assert stats["torn_tail"] and stats["corrupt_skipped"] == 0
    if how in ("crc", "length"):
        assert stats["corrupt_skipped"] >= 1
    assert rep["last_dispatch"]["tier"] == "cuda"


def test_postmortem_on_a_node_home_equal_and_boot_retires_earlier_runs(tmp_path):
    out = {}
    for pkg in PKGS:
        home = tmp_path / pkg
        d = home / "data" / "blackbox"
        j = _journal(pkg, d)
        _stream(pkg, j, heights=5, finish_last=False)  # dies mid-round 5
        j.kill()
        first = BB[pkg].postmortem_report(str(home))
        j = _journal(pkg, d)  # the next incarnation repairs and reboots
        _stream(pkg, j, heights=3, finish_last=False)  # dies mid-round 3
        j.kill()
        second = BB[pkg].postmortem_report(str(home))
        assert BB[pkg].resolve_dir(str(home)) == str(d)
        out[pkg] = json.dumps([first, second, BB[pkg].boot_report(str(d))],
                              sort_keys=True)
    assert out[PKGS[1]] == out[PKGS[0]]
    first, second, boot = json.loads(out[PKGS[1]])
    assert first["in_flight"]["h"] == 5 and first["last_committed_height"] == 4
    # the second boot retired the first incarnation's open round
    assert second["in_flight"]["h"] == 3
    assert not any(sp["attrs"].get("h") == 5 for sp in second["open_spans"])
    assert boot["unclean_shutdown"]


def test_dropped_records_are_counted_and_never_block(tmp_path):
    j = tbb.BlackboxJournal(str(tmp_path), queue_max=4, health_every=None)
    try:
        with j._iolock:  # the writer thread is held on its IO lock
            t0 = time.perf_counter()
            for i in range(200):
                j.append(tbb.REC_EVENT, {"kind": "x", "i": i})
            took = time.perf_counter() - t0
            assert j.stats()["dropped"] >= 190
        assert took < 2.0
    finally:
        j.close(clean=True)
    recs, stats = tbb.decode_dir(str(tmp_path))
    assert recs[-1][0] == tbb.REC_CLEAN_CLOSE and stats["corrupt_skipped"] == 0


def test_anomaly_durable_before_append_returns_in_threaded_mode(tmp_path):
    j = tbb.BlackboxJournal(str(tmp_path), health_every=None)
    try:
        for i in range(5):
            j.on_event("e", {"i": i})
        j.on_anomaly("watchdog_fire", {"tier": "cuda", "lanes": 256, "dispatch": 3}, 1.0)
        # read back with the writer still running: the anomaly is on disk
        recs, _ = tbb.decode_dir(str(tmp_path))
        assert any(k == tbb.REC_ANOMALY and p["kind"] == "watchdog_fire"
                   for k, p in recs)
    finally:
        j.close(clean=True)
        assert j._writer is None or not j._writer.is_alive()


def test_health_records_every_n(tmp_path):
    j = tbb.BlackboxJournal(str(tmp_path), threaded=False, health_every=5)
    for i in range(12):
        j.on_event("e", {"i": i})
    j.close(clean=True)
    recs, _ = tbb.decode_dir(str(tmp_path))
    health = [p for k, p in recs if k == tbb.REC_HEALTH]
    assert len(health) == 2
    assert {"sched", "ingest", "dispatch", "warmboot"} <= set(health[0])


def test_kill_switch_restores_the_ram_only_recorder(tmp_path, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_BLACKBOX", "0")
    for pkg in PKGS:
        assert BB[pkg].open_journal(str(tmp_path / pkg)) is None
        assert all(TR[pkg].get_sink(k) is None for k in ("span", "open", "anomaly",
                                                         "event"))
        with TR[pkg].span("verify.commit"):
            pass
        assert TR[pkg].get_tracer().snapshot()["spans_recorded"] == 1
        assert not (tmp_path / pkg).exists()
    monkeypatch.delenv("COMETBFT_TPU_BLACKBOX")
    j = tbb.open_journal(str(tmp_path / "on"))
    assert j is not None and ttr.get_sink("span") == j.on_span
    with ttr.span("verify.commit"):
        pass
    tbb.close_journal(clean=True)
    assert ttr.get_sink("span") is None
    recs, _ = tbb.decode_dir(str(tmp_path / "on"))
    assert [k for k, _ in recs] == [tbb.REC_SPAN, tbb.REC_CLEAN_CLOSE]


def test_gc_dir_equal(tmp_path):
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg / "n0"
        j = BB[pkg].BlackboxJournal(str(d), threaded=False, health_every=None,
                                    segment_bytes=4096, segments=6)
        _stream(pkg, j, heights=40)
        j.close(clean=True)
        before = sorted(os.listdir(d))
        got = BB[pkg].gc_dir(str(tmp_path / pkg), max_segments=2)
        out.append((before, got, sorted(os.listdir(d))))
        shutil.rmtree(tmp_path / pkg)
    assert out[0] == out[1] and out[1][1][0] >= 1
