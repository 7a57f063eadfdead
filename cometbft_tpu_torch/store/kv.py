"""Embedded key-value store abstraction (reference: cometbft-db dependency).

Backends: in-memory (tests) and SQLite (durable default — stdlib, crash-safe
WAL journaling; the reference defaults to goleveldb/pebble, SURVEY.md §2.1.3).
Iteration is ordered by raw bytes, matching the reference's iterator contract.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from bisect import bisect_left, insort
from typing import Iterator, Optional

from cometbft_tpu_torch.libs import diskguard as _dg
from cometbft_tpu_torch.libs import storage_stats


class KVStore:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterate(
        self,
        start: bytes = b"",
        end: Optional[bytes] = None,
        snapshot: bool = True,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over [start, end).  ``snapshot=False`` lets
        a backend page the scan (bounded memory on huge ranges) at the
        cost of point-in-time consistency; backends without a paged mode
        ignore it."""
        raise NotImplementedError

    def write_batch(
        self,
        sets: list[tuple[bytes, bytes]],
        deletes: list[bytes],
        surface: Optional[str] = None,
    ):
        """``surface`` overrides the store's durability policy for THIS
        batch — for maintenance ops whose data belongs to a different
        policy than the file (e.g. draining legacy index rows out of the
        fail-stop chain db must degrade, never halt).  Backends without
        a guard ignore it."""
        for k, v in sets:
            self.set(k, v)
        for k in deletes:
            self.delete(k)

    def compact(self) -> None:
        """Reclaim space; backends without compaction no-op."""

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemKV(KVStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._data:
                insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect_left(self._keys, key)
                del self._keys[i]

    def iterate(
        self,
        start: bytes = b"",
        end: Optional[bytes] = None,
        snapshot: bool = True,
    ):
        with self._lock:
            i = bisect_left(self._keys, start)
            keys = []
            while i < len(self._keys):
                k = self._keys[i]
                if end is not None and k >= end:
                    break
                keys.append(k)
                i += 1
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v


#: exception classes the diskguard seam treats as IO failures on the
#: sqlite surfaces (sqlite errors are not OSErrors)
_SQLITE_IO_ERRORS = (OSError, sqlite3.OperationalError, sqlite3.DatabaseError)


class SqliteKV(KVStore):
    """Durable KV over SQLite with WAL journaling.

    ``surface`` names the durability policy this store's writes run
    under (libs/diskguard): the chain/state store passes ``state``
    (fail-stop — a commit that cannot persist must halt the node before
    consensus advances on it), the event indexer ``indexer``
    (degradable — counted drops, never consensus).  The default ``kv``
    is degradable per diskguard's opt-in principle: a caller must ASK
    for node-halting policy, never get it by accident.
    """

    def __init__(
        self, path: str, surface: str = "kv", probe: Optional[bool] = None
    ):
        self.path = path
        self.surface = surface
        # quick_check is O(database size), so it only runs when the
        # previous writer demonstrably died unclean: a leftover sqlite
        # ``-wal`` sidecar at open (a clean close checkpoints and
        # unlinks it).  Sampled BEFORE we connect — our own connection
        # creates the sidecar.  ``probe=True`` forces the scrub
        # (operator forensics CLIs), ``probe=False`` skips it.
        if probe is None:
            try:
                probe = os.path.getsize(path + "-wal") > 0
            except OSError:
                probe = False
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()
        if probe and _dg.enabled():
            self.integrity_probe()

    def integrity_probe(self) -> bool:
        """Crash-consistency scrub: SQLite's quick_check, run at open
        after an unclean shutdown.  A fail-stop surface refuses to serve
        a corrupt database (typed ``StorageFatal``); a degradable
        surface records the damage as a ``disk_fault`` anomaly and
        carries on."""

        def probe() -> str:
            with self._lock:
                row = self._conn.execute("PRAGMA quick_check(1)").fetchone()
            verdict = str(row[0]) if row else "no result"
            if verdict != "ok":
                raise sqlite3.DatabaseError(f"quick_check: {verdict}")
            return verdict

        try:
            _dg.guard(
                self.surface, "integrity", probe,
                path=self.path, exc_types=_SQLITE_IO_ERRORS,
            )
            return True
        except _dg.StorageFatal:
            raise
        except _SQLITE_IO_ERRORS:
            return False  # degradable surface: damage counted, store open

    def _guard(self, op: str, thunk):
        def locked_retry():
            # sqlite lock contention ("database is locked": another
            # connection holds the file) is TRANSACTIONAL, not an IO
            # failure — nothing was persisted, so a bounded retry is
            # atomic and safe, unlike a failed write/fsync whose retry
            # the durability policy forbids.  It runs BEFORE the policy
            # applies: a fail-stop store must halt on a disk that
            # cannot persist, not on an operator tool's short-lived
            # read lock; contention that outlives the backoff budget
            # still escalates into the guard.
            if not _dg.enabled():
                return thunk()
            attempt = 0
            while True:
                try:
                    return thunk()
                except sqlite3.OperationalError as e:
                    if (
                        "locked" not in str(e).lower()
                        or attempt >= _dg.retries()
                    ):
                        raise
                    storage_stats.record_retry(self.surface)
                    _dg.sleep_backoff(attempt)
                    attempt += 1

        return _dg.guard(
            self.surface, op, locked_retry, path=self.path,
            exc_types=_SQLITE_IO_ERRORS,
        )

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def set(self, key: bytes, value: bytes) -> None:
        def op() -> None:
            with self._lock:
                self._conn.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (key, value),
                )
                self._conn.commit()

        self._guard("set", op)

    def delete(self, key: bytes) -> None:
        def op() -> None:
            with self._lock:
                self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
                self._conn.commit()

        self._guard("delete", op)

    _ITER_PAGE = 1024

    def iterate(
        self,
        start: bytes = b"",
        end: Optional[bytes] = None,
        snapshot: bool = True,
    ):
        if snapshot:
            # default: one fetchall under the lock at first consumption —
            # a point-in-time view; a concurrent write_batch is either
            # fully visible or not at all (live readers such as tx_search
            # depend on never observing a torn batch)
            with self._lock:
                if end is None:
                    rows = self._conn.execute(
                        "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                        (start,),
                    ).fetchall()
                else:
                    rows = self._conn.execute(
                        "SELECT k, v FROM kv WHERE k >= ? AND k < ? "
                        "ORDER BY k",
                        (start, end),
                    ).fetchall()
            for k, v in rows:
                yield bytes(k), bytes(v)
            return
        # paged scan for huge ranges (the legacy-index migration walks
        # the whole keyspace at boot): memory stays bounded, but the lock
        # is released between pages so concurrent writes may be observed
        # torn across a page boundary — callers must tolerate that
        page = self._ITER_PAGE
        bound, key = ">=", start
        while True:
            with self._lock:
                if end is None:
                    rows = self._conn.execute(
                        f"SELECT k, v FROM kv WHERE k {bound} ? "
                        f"ORDER BY k LIMIT {page}",
                        (key,),
                    ).fetchall()
                else:
                    rows = self._conn.execute(
                        f"SELECT k, v FROM kv WHERE k {bound} ? AND k < ? "
                        f"ORDER BY k LIMIT {page}",
                        (key, end),
                    ).fetchall()
            for k, v in rows:
                yield bytes(k), bytes(v)
            if len(rows) < page:
                return
            bound, key = ">", bytes(rows[-1][0])

    def write_batch(self, sets, deletes, surface: Optional[str] = None):
        def op() -> None:
            with self._lock:
                self._conn.executemany(
                    "INSERT INTO kv (k, v) VALUES (?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    sets,
                )
                self._conn.executemany(
                    "DELETE FROM kv WHERE k = ?", [(k,) for k in deletes]
                )
                self._conn.commit()

        _dg.guard(
            surface or self.surface, "write_batch", op, path=self.path,
            exc_types=_SQLITE_IO_ERRORS,
        )

    def compact(self) -> None:
        """Reclaim space (reference: compact-db / RocksDB CompactRange)."""

        def op() -> None:
            with self._lock:
                self._conn.commit()
                self._conn.execute("VACUUM")

        self._guard("compact", op)

    def flush(self) -> None:
        def op() -> None:
            with self._lock:
                self._conn.commit()

        self._guard("flush", op)

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class UnionKV(KVStore):
    """Overlay for the split index dbs: reads consult ``primary``
    (tx_index.db) first, falling back to ``fallback`` (chain.db) for
    legacy rows an interrupted ``migrate_legacy_index`` left behind.
    New values go to ``primary`` only, but deletes reach BOTH halves:
    a prune that removed a key only from tx_index.db would leave the
    legacy copy visible through the union — and the next boot's drain
    would resurrect it into tx_index.db, un-pruning it permanently.
    ``fallback_surface`` names the durability policy for those fallback
    deletes (the node passes ``indexer``: pruning index rows out of the
    fail-stop chain db is index maintenance and must degrade, never
    halt).  Once the legacy index is drained the fallback probes are
    empty prefix scans — effectively free."""

    def __init__(
        self,
        primary: KVStore,
        fallback: KVStore,
        fallback_surface: Optional[str] = None,
    ):
        self._primary = primary
        self._fallback = fallback
        self._fallback_surface = fallback_surface

    def get(self, key: bytes) -> Optional[bytes]:
        v = self._primary.get(key)
        # b"" is a real value (block-event keys) — test presence, not truth
        return v if v is not None else self._fallback.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self._primary.set(key, value)

    def delete(self, key: bytes) -> None:
        self._primary.delete(key)
        self._fallback.write_batch(
            [], [key], surface=self._fallback_surface
        )

    def write_batch(self, sets, deletes, surface: Optional[str] = None):
        self._primary.write_batch(sets, deletes, surface=surface)
        if deletes:
            self._fallback.write_batch(
                [], list(deletes), surface=self._fallback_surface
            )

    def iterate(
        self,
        start: bytes = b"",
        end: Optional[bytes] = None,
        snapshot: bool = True,
    ):
        import heapq

        def tagged(db, pref):
            for k, v in db.iterate(start, end, snapshot=snapshot):
                yield k, pref, v

        # (key, pref) ordering: for duplicate keys the primary (pref 0)
        # arrives first and the shadowed fallback row is skipped
        last = None
        for k, _pref, v in heapq.merge(
            tagged(self._primary, 0), tagged(self._fallback, 1)
        ):
            if k == last:
                continue
            last = k
            yield k, v


def open_kv(
    backend: str, path: Optional[str] = None, surface: str = "kv"
) -> KVStore:
    if backend == "memdb":
        return MemKV()
    if backend == "sqlite":
        if not path:
            raise ValueError("sqlite backend requires a path")
        return SqliteKV(path, surface=surface)
    raise ValueError(f"unknown db backend: {backend}")
