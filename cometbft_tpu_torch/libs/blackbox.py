"""Crash-persistent black box: a durable journal under the flight recorder.

The flight recorder (libs/tracing.py) is a RAM ring: spans, anomaly
counters and breaker history all die with the process, and a SIGKILL'd or
wedged node — the exact failure the supervisor chain and the sim's
crash-restart scenarios were built for — leaves zero forensic record of
what it was doing.  This module closes that gap with an append-only,
CRC32+length-framed journal (the same framing discipline as
``consensus/wal.py``) fed from the tracer's sinks:

  * every COMPLETED span (batched, buffered writes — the hot path never
    waits on disk),
  * every explicit-span OPEN (``Tracer.begin`` — one per consensus round;
    flushed, so the in-flight round anchor survives a crash),
  * EVERY anomaly (not just the RAM recorder's first-per-kind; fsync'd),
  * breaker state transitions and other low-rate events (quorum arrivals
    on the in-flight round, device-probe up/down transitions; flushed),
  * periodic health snapshots (sched / ingest / dispatch / warmboot
    counters, every ``health_every`` records — count-based so the sim's
    journal bytes stay a pure function of the seed),
  * a clean-close sentinel, written (and fsync'd) only by a graceful
    shutdown — its absence at boot IS the unclean-shutdown detector.

Size discipline: the head segment rotates at ``segment_bytes`` and only
the newest ``segments`` files are kept, so a journal can never exceed
``segments * segment_bytes`` (+ one frame).  In threaded mode a bounded
queue feeds a background writer; when the queue is full the record is
DROPPED AND COUNTED — the verify hot path never blocks on the black box.

Decode is torn-tail tolerant by design: a truncated final record is a
normal crash artifact (``torn_tail``), not corruption; a mid-stream CRC
or length failure is skipped and counted (``corrupt_skipped``) and never
raises past the postmortem boundary.  ``postmortem_report`` reconstructs
a dead node's final timeline from the records: last committed height, the
in-flight ``consensus.round`` anchor with its step spans and quorum
arrivals, open spans at death, the last ``verify.dispatch`` attribution
triple, recent anomalies and last-known breaker states.

Kill switch: ``COMETBFT_TPU_BLACKBOX=0`` disables the journal entirely —
no sinks installed, the RAM-only recorder restored bit-for-bit.

Deliberately free of torch and of every CUDA call, like ``libs/tracing``:
the postmortem CLI and the boot-time decode must work exactly when the
card is the thing that killed the node.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import threading
import zlib
from collections import deque
from typing import Callable, Iterator, Optional

logger = logging.getLogger("cometbft_tpu_torch.blackbox")

# record kinds (frame body = kind byte + compact sort_keys JSON payload)
REC_SPAN = 1         # a completed span (Span.to_dict())
REC_OPEN = 2         # an explicit span's begin (unfinished at write time)
REC_ANOMALY = 3      # one anomaly occurrence (every one, fsync'd)
REC_EVENT = 4        # low-rate event: breaker transition, quorum, probe…
REC_HEALTH = 5       # periodic pipeline-health counter snapshot
REC_CLEAN_CLOSE = 6  # graceful-shutdown sentinel (absence = unclean)

KIND_NAMES = {
    REC_SPAN: "span",
    REC_OPEN: "open",
    REC_ANOMALY: "anomaly",
    REC_EVENT: "event",
    REC_HEALTH: "health",
    REC_CLEAN_CLOSE: "clean_close",
}

MAX_REC_SIZE = 1 << 20  # 1 MB per record, like the WAL
HEAD_NAME = "blackbox.journal"

DEFAULT_SEGMENTS = 4
DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_QUEUE = 1024
DEFAULT_FLUSH_EVERY = 64
DEFAULT_HEALTH_EVERY = 512


def enabled() -> bool:
    """``COMETBFT_TPU_BLACKBOX=0`` is the kill switch; default on.  With
    it off nothing installs tracer sinks, so the RAM-only recorder
    behaves bit-for-bit as before this module existed."""
    return os.environ.get("COMETBFT_TPU_BLACKBOX", "1") != "0"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_segments() -> int:
    return max(_env_int("COMETBFT_TPU_BLACKBOX_SEGMENTS", DEFAULT_SEGMENTS), 1)


def default_segment_bytes() -> int:
    return max(
        _env_int("COMETBFT_TPU_BLACKBOX_SEGMENT_BYTES", DEFAULT_SEGMENT_BYTES),
        4096,
    )


def _frame(kind: int, payload: dict) -> bytes:
    body = bytes([kind]) + json.dumps(
        payload, sort_keys=True, separators=(",", ":")
    ).encode()
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack(">II", crc, len(body)) + body


class BlackboxJournal:
    """One node's black box.  Thread-safe; ``append`` never blocks on IO
    in threaded mode (full queue → counted drop) and never raises."""

    def __init__(
        self,
        dir_: str,
        segment_bytes: Optional[int] = None,
        segments: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        threaded: bool = True,
        queue_max: int = DEFAULT_QUEUE,
        flush_every: int = DEFAULT_FLUSH_EVERY,
        health_every: Optional[int] = DEFAULT_HEALTH_EVERY,
        repair: bool = True,
    ):
        import time as _time

        self.dir = str(dir_)
        self.segment_bytes = segment_bytes or default_segment_bytes()
        self.segments = segments or default_segments()
        self.clock: Callable[[], float] = clock or _time.perf_counter
        self.flush_every = max(int(flush_every), 1)
        self.health_every = health_every
        self.queue_max = max(int(queue_max), 1)
        # _qlock guards the queue + drop counter (the only lock the hot
        # path ever takes in threaded mode); _iolock guards the file — the
        # writer thread does its IO under _iolock alone, so a caller can
        # never block behind a disk write.  REENTRANT: a failed journal
        # write's own ``disk_fault`` anomaly (diskguard) sinks back into
        # this journal on the same thread — with a plain Lock that is a
        # self-deadlock; the diskguard anomaly latch bounds the nesting
        # at one level
        self._qlock = threading.Lock()
        self._iolock = threading.RLock()
        self._wake = threading.Condition(self._qlock)
        self._f: Optional[io.BufferedWriter] = None
        self._unflushed = 0
        self.closed = False
        # counters (introspection + soak rows)
        self.records = 0
        self.dropped = 0
        self.bytes_written = 0
        self.rotations = 0
        self._since_health = 0
        os.makedirs(self.dir, exist_ok=True)
        if repair:
            # a previous unclean run may have left a torn tail on the head
            # segment; appending after it would desync every later frame,
            # so truncate back to the last valid frame boundary first (the
            # caller is expected to have read its postmortem already)
            self._repair_head()
        self._open_head()
        self._queue: "deque[tuple[bytes, int]]" = deque()
        self._writer: Optional[threading.Thread] = None
        if threaded:
            self._writer = threading.Thread(
                target=self._writer_loop, name="blackbox-writer", daemon=True
            )
            self._writer.start()

    # -- file management ---------------------------------------------------

    @property
    def head_path(self) -> str:
        return os.path.join(self.dir, HEAD_NAME)

    def _open_head(self) -> None:
        self._f = open(self.head_path, "ab")

    def _repair_head(self) -> None:
        """Truncate ONLY the torn tail past the last valid frame before
        appending (new frames after torn bytes would be swallowed by the
        torn header's bogus length).  Mid-stream corruption that is
        FOLLOWED by valid frames is evidence, not a tail — it stays on
        disk for the decoder's skip-and-count resync."""
        path = self.head_path
        if not os.path.exists(path):
            return
        good = _last_valid_end(path)
        if good < os.path.getsize(path):
            try:
                os.truncate(path, good)
            except OSError:
                pass

    def _rotate_locked(self, incoming: int) -> None:
        if self._f is None or self._f.tell() + incoming <= self.segment_bytes:
            return
        if self._f.tell() == 0:
            return  # oversized single record: let it land alone
        self._f.flush()
        self._f.close()
        base = self.head_path
        # monotonically increasing index — NEVER the lowest free slot: once
        # pruning removes .0000, reusing it would make every newly rolled
        # segment sort as the oldest and be pruned immediately, silently
        # keeping stale history instead of the recent window
        rolled = _rolled_files(self.dir)
        idx = (
            int(rolled[-1][len(base) + 1 :]) + 1 if rolled else 0
        )
        os.rename(base, f"{base}.{idx:04d}")
        self.rotations += 1
        self._open_head()
        self._unflushed = 0
        # hard budget: keep the newest (segments - 1) rolled files
        rolled = _rolled_files(self.dir)
        excess = len(rolled) - (self.segments - 1)
        for fp in rolled[:max(excess, 0)]:
            try:
                os.unlink(fp)
            except OSError:
                pass

    # -- append ------------------------------------------------------------

    # durability classes for the ``sync`` argument
    SYNC_NONE = 0   # buffered; flushed every flush_every records
    SYNC_FLUSH = 1  # flushed to the kernel immediately (survives kill -9)
    SYNC_FSYNC = 2  # flushed + fsync'd (survives power loss)

    def append(self, kind: int, payload: dict, sync: int = SYNC_NONE) -> None:
        """Journal one record.  Encoding happens on the caller's thread
        (cheap, deterministic); IO happens here (sync mode) or on the
        writer thread (threaded mode, never blocking the caller)."""
        if self.closed:
            return
        try:
            frame = _frame(kind, payload)
        except (TypeError, ValueError) as e:
            # an unserializable attr must never break the caller
            logger.warning("blackbox: unserializable record dropped: %r", e)
            with self._qlock:
                self.dropped += 1
            return
        if len(frame) > MAX_REC_SIZE + 9:
            # the decoder rejects bodies past MAX_REC_SIZE as garbage
            # headers; writing one anyway would journal a record no
            # postmortem can read — drop it, counted, like the WAL's cap
            logger.warning(
                "blackbox: %d-byte record exceeds the %d cap; dropped",
                len(frame),
                MAX_REC_SIZE,
            )
            with self._qlock:
                self.dropped += 1
            return
        if self._writer is None:
            with self._iolock:
                self._write_io(frame, sync)
        else:
            with self._qlock:
                if self.closed or len(self._queue) >= self.queue_max:
                    self.dropped += 1
                    return
                self._queue.append((frame, sync))
                self._wake.notify()
            if sync >= self.SYNC_FSYNC:
                # the fsync promise must not wait for the writer thread —
                # a SIGKILL microseconds after a watchdog_fire is exactly
                # the moment the record matters.  The CALLER drains the
                # queue through its own record (anomalies are rare; this
                # is the one journal path allowed to pay IO).  A batch the
                # writer already popped may land just after ours — decode
                # is order-tolerant and the postmortem folds by timestamp.
                with self._iolock:
                    with self._qlock:
                        batch = list(self._queue)
                        self._queue.clear()
                    # our record is the batch's tail; its own SYNC_FSYNC
                    # flushes + fsyncs everything written before it
                    for bframe, bsync in batch:
                        self._write_io(bframe, bsync)
        self._maybe_health()

    def _write_io(self, frame: bytes, sync: int) -> None:
        """One frame to the head segment; caller holds ``_iolock``.

        Write / flush / fsync route through the diskguard seam (surface
        ``blackbox``, DEGRADABLE): transient EIO gets a bounded
        exponential-backoff retry, an exhausted fault degrades to the
        counted drop below plus a ``disk_fault`` anomaly — the writer
        thread survives and later records keep landing."""
        from cometbft_tpu_torch.libs import diskguard as _dg

        if self._f is None:
            self.dropped += 1
            return
        written = False
        try:
            self._rotate_locked(len(frame))
            _dg.file_write(
                "blackbox", self._f, frame, op="write", path=self.head_path
            )
            self.records += 1
            self.bytes_written += len(frame)
            written = True
            self._unflushed += 1
            if sync >= self.SYNC_FLUSH or self._unflushed >= self.flush_every:
                _dg.flush("blackbox", self._f, path=self.head_path)
                self._unflushed = 0
            if sync >= self.SYNC_FSYNC:
                _dg.fsync("blackbox", self._f, path=self.head_path)
        except OSError as e:  # forensics must never become a second failure
            logger.warning("blackbox write failed: %r", e)
            # only a failed WRITE drops the frame; a failed flush/fsync
            # leaves the bytes buffered (a later flush may still land
            # them) and is already counted by the guard's surface stats —
            # records + dropped must never exceed frames submitted
            if not written:
                self.dropped += 1

    def _writer_loop(self) -> None:
        while True:
            with self._qlock:
                while not self._queue and not self.closed:
                    self._wake.wait(timeout=0.5)
                if self.closed:
                    return  # close()/kill() handle whatever remains queued
                batch = list(self._queue)
                self._queue.clear()
            with self._iolock:
                for frame, sync in batch:
                    self._write_io(frame, sync)

    def _maybe_health(self) -> None:
        if not self.health_every:
            return
        with self._qlock:
            self._since_health += 1
            if self._since_health < self.health_every:
                return
            self._since_health = 0
        self.append(REC_HEALTH, health_snapshot(self.clock()))

    # -- tracer sinks ------------------------------------------------------

    def on_span(self, sp) -> None:
        self.append(REC_SPAN, sp.to_dict())

    def on_open(self, sp) -> None:
        d = {
            "stage": sp.stage,
            "span": sp.span_id,
            "trace": sp.trace_id,
            "t0": round(sp.t_start, 9),
        }
        if sp.attrs:
            d["attrs"] = dict(sp.attrs)
        self.append(REC_OPEN, d, sync=self.SYNC_FLUSH)

    def on_anomaly(self, kind: str, attrs: dict, t: float) -> None:
        self.append(
            REC_ANOMALY,
            {"kind": kind, "t": round(t, 9), "attrs": dict(attrs)},
            sync=self.SYNC_FSYNC,
        )

    def on_event(self, kind: str, attrs: dict) -> None:
        self.append(
            REC_EVENT,
            {"kind": kind, "t": round(self.clock(), 9), "attrs": dict(attrs)},
            sync=self.SYNC_FLUSH,
        )

    # -- lifecycle ---------------------------------------------------------

    def close(self, clean: bool = True) -> None:
        """Graceful close.  ``clean=True`` drains the queue and appends
        the fsync'd clean-close sentinel — the record whose absence at the
        next boot means the process died uncleanly."""
        with self._qlock:
            if self.closed:
                return
            self.closed = True
            batch = list(self._queue)
            self._queue.clear()
            self._wake.notify_all()
        if self._writer is not None and self._writer.is_alive():
            self._writer.join(timeout=2.0)
        with self._iolock:
            if clean:
                for frame, sync in batch:
                    self._write_io(frame, sync)
                self._write_io(
                    _frame(REC_CLEAN_CLOSE, {"t": round(self.clock(), 9)}),
                    self.SYNC_FSYNC,
                )
            elif batch:
                with self._qlock:
                    self.dropped += len(batch)
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def kill(self) -> None:
        """Simulate abrupt process death, the same drop-unflushed-tail
        discipline as ``WAL.kill``: only bytes the kernel already has at
        kill time survive; queued records and the user-space buffered tail
        are lost (a graceful close would flush them and hide real torn
        tails).  The head file is truncated back to its pre-close on-disk
        size, which may cut mid-frame — exactly the torn tail the tolerant
        decoder exists for."""
        with self._qlock:
            if self.closed:
                return
            self.closed = True
            self.dropped += len(self._queue)
            self._queue.clear()
            self._wake.notify_all()
        if self._writer is not None and self._writer.is_alive():
            self._writer.join(timeout=2.0)
        path = self.head_path
        with self._iolock:
            size = os.path.getsize(path) if os.path.exists(path) else 0
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            if os.path.exists(path) and os.path.getsize(path) > size:
                try:
                    os.truncate(path, size)
                except OSError:
                    pass

    def stats(self) -> dict:
        head = 0
        try:
            head = os.path.getsize(self.head_path)
        except OSError:
            pass
        with self._qlock:
            queued, dropped = len(self._queue), self.dropped
        return {
            "records": self.records,
            "bytes": self.bytes_written,
            "dropped": dropped,
            "rotations": self.rotations,
            "segments": len(_rolled_files(self.dir)) + 1,
            "head_bytes": head,
            "queued": queued,
            "closed": self.closed,
        }


def health_snapshot(t: float) -> dict:
    """Pipeline-health counters for a HEALTH record: scheduler, tx-ingest,
    dispatch and warm-boot snapshots — all torch-free stats modules.  A
    section that fails to import reports its error instead of sinking the
    record (same discipline as ``tracing.trace_document``)."""
    doc: dict = {"t": round(t, 9)}

    def section(name, fn):
        try:
            doc[name] = fn()
        except Exception as e:  # noqa: BLE001
            doc[name] = {"error": repr(e)}

    def _sched():
        from cometbft_tpu_torch.verifysched import stats as sstats

        return sstats.snapshot()

    def _ingest():
        from cometbft_tpu_torch.txingest import stats as istats

        return istats.snapshot()

    def _dispatch():
        from cometbft_tpu_torch.ops import dispatch_stats

        return dispatch_stats.snapshot()

    def _warmboot():
        from cometbft_tpu_torch.ops import warm_stats

        return warm_stats.snapshot()

    section("sched", _sched)
    section("ingest", _ingest)
    section("dispatch", _dispatch)
    section("warmboot", _warmboot)
    return doc


# -- decode -------------------------------------------------------------------


def _rolled_files(dir_: str) -> "list[str]":
    """Rolled segment paths, oldest first."""
    try:
        names = os.listdir(dir_)
    except OSError:
        return []
    rolled = sorted(
        (
            n
            for n in names
            if n.startswith(HEAD_NAME + ".") and n[len(HEAD_NAME) + 1 :].isdigit()
        ),
        key=lambda n: int(n[len(HEAD_NAME) + 1 :]),
    )
    return [os.path.join(dir_, n) for n in rolled]


def segment_files(dir_: str) -> "list[str]":
    """All journal segments, oldest first, head last."""
    out = _rolled_files(dir_)
    head = os.path.join(dir_, HEAD_NAME)
    if os.path.exists(head):
        out.append(head)
    return out


def _last_valid_end(path: str) -> int:
    """End offset of the LAST verifiable frame in a segment, walking
    with the same tolerance as decode (skip corrupt frames, resync on
    garbage headers).  Everything past it is a torn tail."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return 0
    end, pos, n = 0, 0, len(data)
    while pos + 8 <= n:
        crc, length = struct.unpack_from(">II", data, pos)
        if length > MAX_REC_SIZE + 1:
            nxt = _resync(data, pos + 1)
            if nxt is None:
                break
            pos = nxt
            continue
        if pos + 8 + length > n:
            break
        body = data[pos + 8 : pos + 8 + length]
        pos += 8 + length
        if zlib.crc32(body) & 0xFFFFFFFF == crc:
            end = pos
    return end


def _iter_file(data: bytes, last_segment: bool, stats: dict) -> Iterator[tuple]:
    """Yield (kind, payload) frames from one segment's bytes.

    Torn-tail semantics: an incomplete frame at the END of the LAST
    segment is a normal crash artifact (``torn_tail``); everywhere else
    it counts as corruption.  A CRC failure skips one frame (the length
    field still brackets it); an implausible length resyncs by scanning
    forward for the next verifiable frame — skip-and-count, never raise.
    """
    pos, n = 0, len(data)
    while pos + 8 <= n:
        crc, length = struct.unpack_from(">II", data, pos)
        if length > MAX_REC_SIZE + 1:
            # header is garbage (corrupted length): resync forward
            nxt = _resync(data, pos + 1)
            stats["corrupt_skipped"] += 1
            if nxt is None:
                return
            pos = nxt
            continue
        if pos + 8 + length > n:
            if last_segment:
                stats["torn_tail"] = True
            else:
                stats["corrupt_skipped"] += 1
            return
        body = data[pos + 8 : pos + 8 + length]
        pos += 8 + length
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            stats["corrupt_skipped"] += 1
            continue
        try:
            payload = json.loads(body[1:])
        except ValueError:
            stats["corrupt_skipped"] += 1
            continue
        yield body[0], payload
    if 0 < n - pos < 8:
        if last_segment:
            stats["torn_tail"] = True
        else:
            stats["corrupt_skipped"] += 1


def _resync(data: bytes, start: int) -> Optional[int]:
    """Scan forward for the next offset holding a verifiable frame."""
    n = len(data)
    for pos in range(start, n - 8):
        crc, length = struct.unpack_from(">II", data, pos)
        if length > MAX_REC_SIZE + 1 or pos + 8 + length > n:
            continue
        body = data[pos + 8 : pos + 8 + length]
        if zlib.crc32(body) & 0xFFFFFFFF == crc:
            return pos
    return None


def decode_dir(dir_: str) -> "tuple[list[tuple[int, dict]], dict]":
    """Decode a journal directory into ``(records, stats)``.  Never
    raises on damaged input — damage lands in the stats instead."""
    stats = {
        "segments": 0,
        "bytes": 0,
        "records": 0,
        "corrupt_skipped": 0,
        "torn_tail": False,
    }
    records: "list[tuple[int, dict]]" = []
    files = segment_files(dir_)
    for i, fp in enumerate(files):
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except OSError:
            continue
        stats["segments"] += 1
        stats["bytes"] += len(data)
        for rec in _iter_file(data, i == len(files) - 1, stats):
            records.append(rec)
    stats["records"] = len(records)
    return records, stats


# -- postmortem reconstruction ------------------------------------------------


def _fold_breaker(breakers: dict, backend: str, entry: dict) -> None:
    """Last-known-state fold by TIMESTAMP, not record order: the caller-
    drain fast path for fsync'd anomalies can land a breaker_open a hair
    before spans the writer thread had already popped, so on-disk order
    between breaker records is not authoritative — their ``t`` is."""
    prev = breakers.get(backend)
    if prev is not None:
        t_prev, t_new = prev.get("t"), entry.get("t")
        if (
            isinstance(t_prev, (int, float))
            and isinstance(t_new, (int, float))
            and t_new < t_prev
        ):
            return
    breakers[backend] = entry


def resolve_dir(dir_: str) -> Optional[str]:
    """A node home (or its data dir) is accepted anywhere a journal dir
    is: the first of ``dir_``, ``dir_/blackbox``, ``dir_/data/blackbox``
    holding journal segments.  None when no journal exists anywhere —
    the single resolution rule the CLI, the boot path and the report all
    share."""
    for cand in (
        dir_,
        os.path.join(dir_, "blackbox"),
        os.path.join(dir_, "data", "blackbox"),
    ):
        if segment_files(cand):
            return cand
    return None


def postmortem_report(dir_: str, recent: int = 16) -> dict:
    """Reconstruct a node's final timeline from its journal: a pure
    function of the journal bytes, serialized deterministically
    (``sort_keys`` JSON of this dict byte-compares across same-seed sim
    runs).  Tolerates any damage ``decode_dir`` tolerates."""
    dir_ = resolve_dir(dir_) or dir_
    records, stats = decode_dir(dir_)

    clean_close = bool(records) and records[-1][0] == REC_CLEAN_CLOSE
    last_committed: Optional[int] = None
    opens: dict = {}  # span id -> OPEN payload (unmatched so far)
    last_dispatch: Optional[dict] = None
    anomalies: "list[dict]" = []
    anomaly_counts: dict = {}
    breakers: dict = {}
    health: Optional[dict] = None
    quorum_events: "list[dict]" = []
    device_events: "list[dict]" = []
    mesh_events: "list[dict]" = []
    mesh_width = None  # elastic mesh width at death (last reconfig)
    spans_total = 0

    step_spans: "list[dict]" = []  # last incarnation's consensus.step spans
    for kind, p in records:
        if kind == REC_OPEN:
            opens[p.get("span")] = p
        elif kind == REC_SPAN:
            spans_total += 1
            opens.pop(p.get("span"), None)
            stage = p.get("stage")
            attrs = p.get("attrs") or {}
            if stage == "consensus.round" and attrs.get("committed"):
                h = attrs.get("h")
                if isinstance(h, int):
                    last_committed = max(last_committed or 0, h)
            elif stage == "consensus.step":
                step_spans.append(p)
            elif stage == "verify.dispatch":
                last_dispatch = {
                    "tier": attrs.get("tier"),
                    "lanes": attrs.get("lanes"),
                    "n": attrs.get("n"),
                    "dispatch": attrs.get("dispatch"),
                    "t1": p.get("t1"),
                }
                if attrs.get("mesh") is not None:
                    # mesh width the dispatch targeted (single-chip
                    # dispatches carry no key) -- "which fleet shape was
                    # live when it died" is a first-class question
                    last_dispatch["mesh"] = attrs.get("mesh")
        elif kind == REC_ANOMALY:
            k = p.get("kind", "?")
            anomaly_counts[k] = anomaly_counts.get(k, 0) + 1
            anomalies.append(p)
            a = p.get("attrs") or {}
            if k.startswith("breaker_open") and a.get("backend"):
                _fold_breaker(
                    breakers,
                    a["backend"],
                    {
                        "state": "open",
                        "t": p.get("t"),
                        "error": a.get("error", ""),
                    },
                )
        elif kind == REC_EVENT:
            k = p.get("kind")
            a = p.get("attrs") or {}
            if k == "boot":
                # a new incarnation: the previous process's unfinished
                # opens can never complete, and its step/quorum history
                # must not masquerade as the new process's progress (a
                # restarted node re-enters the SAME (h, r)) — "at death"
                # means the death of the LAST process, not an ancestor's
                opens.clear()
                quorum_events.clear()
                step_spans.clear()
                mesh_events.clear()
                mesh_width = None
            elif k == "breaker_close" and a.get("backend"):
                _fold_breaker(
                    breakers,
                    a["backend"],
                    {"state": "closed", "t": p.get("t")},
                )
            elif k == "quorum":
                quorum_events.append(p)
            elif k == "device_probe":
                device_events.append(p)
            elif k == "mesh.reconfig":
                mesh_events.append(p)
                if a.get("width") is not None:
                    mesh_width = a.get("width")
        elif kind == REC_HEALTH:
            health = p

    # the in-flight consensus round: the newest unmatched round OPEN
    in_flight: Optional[dict] = None
    round_opens = [
        p for p in opens.values() if p.get("stage") == "consensus.round"
    ]
    if round_opens:
        p = round_opens[-1]
        attrs = p.get("attrs") or {}
        h, r = attrs.get("h"), attrs.get("r")
        steps = {}
        for sp in step_spans:  # last incarnation only, like quorum/opens
            a = sp.get("attrs") or {}
            if a.get("h") == h and a.get("r") == r:
                steps[a.get("step", "?")] = sp.get("dur_ms")
        quorum = {}
        for ev in quorum_events:
            a = ev.get("attrs") or {}
            if a.get("h") == h and a.get("r") == r and a.get("key"):
                quorum[a["key"]] = a.get("ms")
        in_flight = {
            "h": h,
            "r": r,
            "node": attrs.get("node"),
            "t0": p.get("t0"),
            "steps": steps,
            "quorum": quorum,
        }

    open_spans = [
        {
            "stage": p.get("stage"),
            "span": p.get("span"),
            "t0": p.get("t0"),
            "attrs": p.get("attrs") or {},
        }
        for p in sorted(opens.values(), key=lambda p: p.get("span") or 0)
    ]

    return {
        "journal": stats,
        "clean_close": clean_close,
        # a journal that EXISTS without ending in the sentinel is an
        # unclean shutdown — even an empty head file means a process
        # opened a black box and never got to close it
        "unclean_shutdown": stats["segments"] > 0 and not clean_close,
        "last_committed_height": last_committed,
        "in_flight": in_flight,
        "open_spans": open_spans,
        "last_dispatch": last_dispatch,
        # elastic mesh state at death: the last reconfiguration's width
        # plus the recent membership events (shrinks, probe exclusions,
        # restores) of the final incarnation
        "mesh": {
            "width": mesh_width,
            "events": mesh_events[-recent:],
        },
        "spans_total": spans_total,
        "anomaly_counts": anomaly_counts,
        "anomalies": anomalies[-recent:],
        "breakers": breakers,
        "device_events": device_events[-recent:],
        "health": health,
    }


def boot_report(dir_: str) -> Optional[dict]:
    """Boot-time unclean-shutdown check: None when no journal exists yet
    (first boot), else the previous run's postmortem report."""
    if not segment_files(dir_):
        return None
    return postmortem_report(dir_)


# -- process-wide journal (the real node's black box) -------------------------

_JOURNAL: Optional[BlackboxJournal] = None
_JOURNAL_LOCK = threading.Lock()


def open_journal(dir_: str, **kw) -> Optional[BlackboxJournal]:
    """Open the process-wide journal and install the tracer sinks.  A
    previously installed journal is NOT closed — it stops receiving
    records (the sinks repoint) but stays open so its owner (another
    in-process Node, a test fixture) can still write its clean-close
    sentinel at its own graceful stop; only a journal nobody closes
    reads as an unclean shutdown.  No-op (None) when the kill switch is
    set."""
    global _JOURNAL
    if not enabled():
        return None
    from cometbft_tpu_torch.libs import tracing

    with _JOURNAL_LOCK:
        j = BlackboxJournal(dir_, **kw)
        _JOURNAL = j
    tracing.set_sink("span", j.on_span)
    tracing.set_sink("open", j.on_open)
    tracing.set_sink("anomaly", j.on_anomaly)
    tracing.set_sink("event", j.on_event)
    return j


def close_journal(clean: bool = True) -> None:
    global _JOURNAL
    from cometbft_tpu_torch.libs import tracing

    with _JOURNAL_LOCK:
        j = _JOURNAL
        _JOURNAL = None
    if j is None:
        return
    for kind in ("span", "open", "anomaly", "event"):
        tracing.set_sink(kind, None)
    j.close(clean=clean)


def get_journal() -> Optional[BlackboxJournal]:
    return _JOURNAL


def journal_stats() -> Optional[dict]:
    j = _JOURNAL
    return j.stats() if j is not None else None


# -- on-demand GC (scripts/exec_cache_gc.py --blackbox) -----------------------


def gc_dir(
    root: str,
    max_segments: Optional[int] = None,
    ttl_days: Optional[float] = None,
    now: Optional[float] = None,
    dry_run: bool = False,
) -> "tuple[int, int]":
    """Prune dead-node journals under ``root``: every directory holding a
    ``blackbox.journal`` keeps its newest ``max_segments`` segments, and
    (with ``ttl_days``) loses rolled segments older than the TTL.  The
    head segment is never removed.  Returns (files_removed, bytes)."""
    import time as _time

    max_segments = max_segments or default_segments()
    now = now if now is not None else _time.time()
    removed = freed = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        if HEAD_NAME not in filenames:
            continue
        rolled = _rolled_files(dirpath)
        victims = list(rolled[: max(len(rolled) - (max_segments - 1), 0)])
        if ttl_days is not None:
            cutoff = now - ttl_days * 86400.0
            for fp in rolled:
                if fp not in victims:
                    try:
                        if os.path.getmtime(fp) < cutoff:
                            victims.append(fp)
                    except OSError:
                        pass
        for fp in victims:
            try:
                size = os.path.getsize(fp)
            except OSError:
                continue
            removed += 1
            freed += size
            if not dry_run:
                try:
                    os.unlink(fp)
                except OSError:
                    removed -= 1
                    freed -= size
    return removed, freed
