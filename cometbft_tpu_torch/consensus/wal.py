"""Consensus write-ahead log (reference: internal/consensus/wal.go:59-135).

Every consensus input is written to the WAL before being processed; internal
messages are fsync'd (WriteSync) so a crashed node can deterministically
replay to its exact pre-crash state.  Records are CRC32 + length framed, and
``#ENDHEIGHT <h>`` markers delimit heights (reference: wal.go EndHeightMessage,
WALEncoder).

File rotation follows the autofile.Group design (reference:
internal/autofile/group.go): head file plus numbered rolled files.

Frames are written by the port's host library only (``wal_open``,
``wal_append``, ``wal_sync``, ``wal_size``, ``wal_close`` in
``csrc/host_prep.cpp``): a failed build or load raises, as for every host
library of the port, and no Python writer stands in.  The replay readers
and ``repair_tail`` are Python, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

from cometbft_tpu_torch.libs import diskguard as _dg

MAX_MSG_SIZE = 1 << 20  # 1 MB per WAL record
_REC_DATA = 1
_REC_END_HEIGHT = 2

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024


@dataclass
class WALRecord:
    kind: int
    payload: bytes  # for END_HEIGHT: 8-byte big-endian height

    @property
    def end_height(self) -> Optional[int]:
        if self.kind == _REC_END_HEIGHT:
            return int.from_bytes(self.payload, "big")
        return None


def read_frame(f) -> "tuple[Optional[int], Optional[bytes], Optional[str]]":
    """Read ONE CRC32+length frame from a binary stream — the single
    decode under every walker (strict replay, tolerant tail scans, the
    boot-time scrub, the sim's mid-frame cutter), so a frame-format
    change has exactly one parser to touch.  Returns ``(kind, payload,
    None)`` for a valid frame, else ``(None, None, reason)``: ``"eof"``
    at a clean frame boundary, or the corruption reason a strict reader
    raises (torn header/body, bogus length, CRC mismatch)."""
    hdr = f.read(8)
    if not hdr:
        return None, None, "eof"
    if len(hdr) < 8:
        return None, None, "truncated record header"
    crc, length = struct.unpack(">II", hdr)
    if length == 0:
        # 8 zero bytes pass the CRC check (crc32(b"")==0) but a real
        # frame always carries a kind byte — this is the zero-filled
        # tail ext4 leaves after a power cut, not a record
        return None, None, "zero-length record"
    if length > MAX_MSG_SIZE + 1:
        return None, None, "record too large"
    body = f.read(length)
    if len(body) < length:
        return None, None, "truncated record body"
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        return None, None, "crc mismatch"
    return body[0], body[1:], None


class WALCorruptionError(Exception):
    pass


class WAL:
    """Reference: internal/consensus/wal.go BaseWAL."""

    def __init__(self, path: str, head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT):
        self.path = path
        self.head_size_limit = head_size_limit
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # boot-time crash-consistency scrub (docs/storage-robustness.md):
        # truncate a torn head-file tail back to the last CRC-valid frame
        # BEFORE appending — new frames written after torn bytes would be
        # swallowed by the torn header's bogus length on strict replay
        self.last_repair: Optional[dict] = None
        if _dg.enabled():
            self.repair_tail()
        # write path: the host library's C++ engine (csrc/host_prep.cpp
        # wal_*); a failed build or load raises here
        from cometbft_tpu_torch import native as _native

        self._nlib = _native.lib()
        self._nh = None
        self._open_head()

    def _open_head(self) -> None:
        self._nh = self._nlib.wal_open(self.path.encode())
        if self._nh is None:
            raise OSError(f"wal_open failed for {self.path}")

    # -- crash-consistency scrub ------------------------------------------

    def repair_tail(self) -> Optional[dict]:
        """Truncate a torn/corrupt HEAD-file tail to the last CRC-valid
        frame boundary (the storage analog of the black box's torn-tail
        decode) and journal the repair.  Returns the repair info (also
        kept on ``last_repair``) or None when the tail was clean.  Only
        the head file is touched: rolled files were fsync'd at rotation
        and mid-stream damage there is evidence, not a tail."""
        if not os.path.exists(self.path):
            return None
        size = os.path.getsize(self.path)
        good = 0
        with open(self.path, "rb") as f:
            while True:
                _kind, payload, reason = read_frame(f)
                if reason is not None:
                    break
                good += 9 + len(payload)  # 8-byte header + kind + payload
            if good >= size:
                return None
            f.seek(good)
            tail = f.read()
        # A complete CRC-valid frame anywhere PAST the first bad byte
        # means durable (possibly fsync'd) records follow the corruption
        # — that is mid-stream damage, not a torn tail.  Truncating here
        # would silently discard consensus input the node already relied
        # on, so keep the pre-repair fail-fast for this case: halt and
        # leave the evidence on disk for the operator.
        for i in range(1, len(tail) - 8):
            crc, length = struct.unpack_from(">II", tail, i)
            if length == 0 or length > MAX_MSG_SIZE + 1:
                continue
            if i + 8 + length > len(tail):
                continue
            if zlib.crc32(tail[i + 8 : i + 8 + length]) & 0xFFFFFFFF == crc:
                from cometbft_tpu_torch.libs import storage_stats, tracing

                storage_stats.record_fatal("wal")
                tracing.record_anomaly(
                    "disk_fatal", surface="wal", op="repair",
                    errno=-1, error="WALCorruptionError",
                )
                raise WALCorruptionError(
                    "mid-stream WAL corruption at byte %d of %s: a valid "
                    "frame follows the damage at offset %d — refusing to "
                    "truncate durable records" % (good, self.path, good + i)
                )
        dropped = size - good
        _dg.guard(
            "wal", "repair", lambda: os.truncate(self.path, good),
            path=self.path,
        )
        self.last_repair = {
            "path": self.path,
            "good_bytes": good,
            "dropped_bytes": dropped,
        }
        from cometbft_tpu_torch.libs import storage_stats, tracing

        storage_stats.record_repair("wal", dropped)
        tracing.note_event(
            "wal_repair",
            path=self.path,
            good_bytes=good,
            dropped_bytes=dropped,
        )
        return self.last_repair

    # -- writing ----------------------------------------------------------

    def _append(self, kind: int, payload: bytes, sync: bool) -> None:
        def native_append() -> None:
            rc = self._nlib.wal_append(
                self._nh, kind, payload, len(payload), 1 if sync else 0
            )
            if rc != 0:
                raise OSError("native WAL append failed")

        _dg.guard("wal", "append", native_append, path=self.path)

    def _head_size(self) -> int:
        return self._nlib.wal_size(self._nh)

    def write(self, payload: bytes) -> None:
        """Buffered write (peer messages; reference: state.go:842)."""
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError("WAL message too large")
        self._append(_REC_DATA, payload, sync=False)
        self._maybe_rotate()

    def write_sync(self, payload: bytes) -> None:
        """Write + flush + fsync (internal messages; reference: state.go:850)."""
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError("WAL message too large")
        self._append(_REC_DATA, payload, sync=True)
        self._maybe_rotate()

    def write_end_height(self, height: int) -> None:
        """#ENDHEIGHT marker, fsync'd (reference: state.go:1904)."""
        self._append(_REC_END_HEIGHT, height.to_bytes(8, "big"), sync=True)
        self._maybe_rotate()

    def flush_and_sync(self) -> None:
        if self._nh is not None:
            _dg.guard(
                "wal", "fsync", lambda: self._nlib.wal_sync(self._nh),
                path=self.path,
            )

    def _maybe_rotate(self) -> None:
        if self._head_size() < self.head_size_limit:
            return
        self._close_head()
        idx = 0
        while os.path.exists(f"{self.path}.{idx:03d}"):
            idx += 1
        os.rename(self.path, f"{self.path}.{idx:03d}")
        self._open_head()

    def _close_head(self) -> None:
        if self._nh is not None:
            self._nlib.wal_close(self._nh)
            self._nh = None

    def close(self) -> None:
        try:
            self._close_head()
        except (OSError, ValueError):
            pass

    def kill(self) -> None:
        """Simulate abrupt process death (kill -9): only bytes the kernel
        already has survive; any user-space buffered tail is lost.  The head
        file is truncated back to its pre-close on-disk size so the graceful
        close below cannot quietly flush data a real crash would have
        dropped.  fsync'd records (internal messages, #ENDHEIGHT) were
        written through before this point and are never cut; a mid-frame
        tail is handled by the tolerant (strict=False) replay readers."""
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        self.close()
        if os.path.exists(self.path) and os.path.getsize(self.path) > size:
            os.truncate(self.path, size)

    # -- reading / replay -------------------------------------------------

    def _files(self) -> list[str]:
        """All WAL files, oldest first, head last."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path)
        rolled = sorted(
            (
                f
                for f in os.listdir(d)
                if f.startswith(base + ".") and f[len(base) + 1 :].isdigit()
            ),
            key=lambda f: int(f[len(base) + 1 :]),  # numeric: .999 < .1000
        )
        out = [os.path.join(d, f) for f in rolled]
        if os.path.exists(self.path):
            out.append(self.path)
        return out

    def iter_records(self, strict: bool = True) -> Iterator[WALRecord]:
        for fp in self._files():
            with open(fp, "rb") as f:
                while True:
                    kind, payload, reason = read_frame(f)
                    if reason == "eof":
                        break
                    if reason is not None:
                        if strict:
                            raise WALCorruptionError(reason)
                        return
                    yield WALRecord(kind=kind, payload=payload)

    def scan_end_heights(self, start: int = 0) -> tuple[set, int]:
        """Incrementally collect #ENDHEIGHT markers from the HEAD file,
        parsing only bytes past ``start``; returns (heights, next_offset).

        ``next_offset`` stops before any incomplete or corrupt trailing
        frame (tolerant tail semantics), so a caller polling a live WAL
        resumes there once more bytes land.  Head-file only — rolled files
        are static history a caller has already seen or can read once via
        ``iter_records``.  This keeps a per-event checker (sim/invariants)
        O(new bytes) instead of re-parsing the whole log per height.
        """
        heights: set = set()
        if not os.path.exists(self.path):
            return heights, 0
        with open(self.path, "rb") as f:
            f.seek(start)
            offset = start
            while True:
                kind, payload, reason = read_frame(f)
                if reason is not None:
                    break
                if kind == _REC_END_HEIGHT:
                    heights.add(int.from_bytes(payload, "big"))
                offset += 9 + len(payload)
        return heights, offset

    def search_for_end_height(self, height: int) -> bool:
        """True if an #ENDHEIGHT marker for `height` exists
        (reference: wal.go SearchForEndHeight)."""
        for rec in self.iter_records(strict=False):
            if rec.end_height == height:
                return True
        return False

    def replay_after_height(self, height: int) -> list[bytes]:
        """All data records written after #ENDHEIGHT(height) — the inputs to
        replay on restart (reference: replay.go catchupReplay)."""
        out: list[bytes] = []
        found = False
        for rec in self.iter_records(strict=False):
            if not found:
                if rec.end_height == height:
                    found = True
                continue
            if rec.kind == _REC_DATA:
                out.append(rec.payload)
        return out if found else []
