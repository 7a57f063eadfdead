"""Statesync syncer: bootstrap a fresh node from an app snapshot.

Reference: statesync/syncer.go:144 SyncAny — discover snapshots from
peers, pick the best, fetch the trusted state for its height through the
light-client state provider, offer it to the app, stream the chunks in,
then verify the app's restored hash against the trusted one.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import log as liblog


class StatesyncError(Exception):
    pass


class ErrNoSnapshots(StatesyncError):
    pass


class ErrSnapshotRejected(StatesyncError):
    pass


class ErrVerifyFailed(StatesyncError):
    pass


@dataclass(frozen=True)
class SnapshotKey:
    height: int
    format: int
    hash: bytes
    chunks: int
    metadata: bytes = b""


@dataclass
class _SnapshotInfo:
    snapshot: SnapshotKey
    peers: set = field(default_factory=set)
    rejected: bool = False


class Syncer:
    """Reference: statesync/syncer.go syncer.

    ``clock``/``sleeper`` form the determinism seam (same pattern as the
    sim ticker): production leaves them unset and gets wall-clock
    ``time.monotonic`` plus a real ``Event.wait``; the deterministic
    simulator injects a virtual clock and a sleeper that advances it and
    delivers scheduled chunk responses, so churn-under-statesync
    scenarios replay byte-identically from their seed.
    """

    # chunk re-request backoff: first retry after RETRY_BASE_S, doubling
    # to RETRY_MAX_S while no new chunk arrives (a burst of losses must
    # not hammer peers with a flat-rate re-request storm)
    RETRY_BASE_S = 0.5
    RETRY_MAX_S = 8.0
    WAIT_BASE_S = 0.1
    WAIT_MAX_S = 1.0

    def __init__(
        self,
        state_provider,
        proxy_app,  # AppConns (snapshot + query conns)
        request_chunk: Callable[[str, int, int, int], bool],  # peer,h,fmt,idx
        chunk_timeout: float = 10.0,
        logger=None,
        clock: Optional[Callable[[], float]] = None,
        sleeper: Optional[Callable[[float], None]] = None,
    ):
        self.state_provider = state_provider
        self.proxy_app = proxy_app
        self.request_chunk = request_chunk
        self.chunk_timeout = chunk_timeout
        self.logger = logger or liblog.nop_logger()
        self._clock = clock or time.monotonic
        self._sleeper = sleeper
        self._lock = threading.Lock()
        self.snapshots: dict[SnapshotKey, _SnapshotInfo] = {}
        self._chunks: dict[int, bytes] = {}
        self._chunk_event = threading.Event()
        self._active: Optional[SnapshotKey] = None

    def _wait(self, timeout: float) -> None:
        """Block up to ``timeout`` (or until a chunk arrives) on the real
        clock, or hand control to the injected sleeper on the virtual one."""
        if self._sleeper is not None:
            self._sleeper(timeout)
        else:
            self._chunk_event.wait(timeout)

    def _sleep(self, duration: float) -> None:
        """Plain sleep (no chunk wakeup) on whichever clock is injected."""
        if self._sleeper is not None:
            self._sleeper(duration)
        else:
            time.sleep(duration)

    # -- snapshot discovery (reactor feeds these) --------------------------

    def add_snapshot(self, peer_id: str, snapshot: SnapshotKey) -> bool:
        with self._lock:
            info = self.snapshots.get(snapshot)
            if info is None:
                info = _SnapshotInfo(snapshot)
                self.snapshots[snapshot] = info
            new = peer_id not in info.peers
            info.peers.add(peer_id)
            return new

    def add_chunk(self, height: int, format_: int, index: int, chunk: bytes):
        with self._lock:
            active = self._active
            if (
                active is None
                or active.height != height
                or active.format != format_
            ):
                return
            if index < 0 or index >= active.chunks:
                # out-of-range chunks from a malicious peer must not grow
                # _chunks without bound (ADVICE r1: statesync/syncer.py:94)
                return
            if index not in self._chunks:
                self._chunks[index] = chunk
                self._chunk_event.set()

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            for info in self.snapshots.values():
                info.peers.discard(peer_id)

    # -- the sync loop (reference: syncer.go:144 SyncAny) ------------------

    def sync_any(
        self,
        discovery_time: float,
        is_running: Callable[[], bool],
        rediscover: Optional[Callable[[], None]] = None,
    ):
        """Block until a snapshot is restored; returns (state, commit).
        Raises ErrNoSnapshots when discovery yields nothing usable."""
        # wait out the FULL discovery window so the best snapshot wins, not
        # merely the first to arrive (reference: SyncAny discoveryTime) —
        # re-polling peers as we wait so fresh snapshots keep arriving
        deadline = self._clock() + discovery_time
        last_poll = -3.0
        while self._clock() < deadline and is_running():
            if rediscover is not None and self._clock() - last_poll > 3.0:
                last_poll = self._clock()
                rediscover()
            self._sleep(0.2)

        while is_running():
            best = self._best_snapshot()
            if best is None:
                raise ErrNoSnapshots("no viable snapshots discovered")
            try:
                return self._sync(best)
            except Exception as e:  # noqa: BLE001 — includes light-client and
                # provider errors (e.g. snapshot too close to head for the
                # H+2 light block to exist yet): reject and try the next
                self.logger.error(
                    "snapshot restore failed",
                    height=best.height,
                    err=str(e),
                )
                with self._lock:
                    self.snapshots[best].rejected = True
                    self._active = None
                    self._chunks = {}
        raise StatesyncError("statesync aborted")

    def _best_snapshot(self) -> Optional[SnapshotKey]:
        with self._lock:
            cands = [
                i
                for i in self.snapshots.values()
                if not i.rejected and i.peers
            ]
            if not cands:
                return None
            # highest height, then newest format (reference: snapshots.go Best)
            cands.sort(key=lambda i: (i.snapshot.height, i.snapshot.format))
            return cands[-1].snapshot

    def _sync(self, snapshot: SnapshotKey):
        self.logger.info(
            "restoring snapshot", height=snapshot.height, chunks=snapshot.chunks
        )
        # 1. trusted state + commit BEFORE touching the app (so a bad light
        #    chain aborts early; reference syncer.go:240)
        state = self.state_provider.state(snapshot.height)
        commit = self.state_provider.commit(snapshot.height)
        trusted_app_hash = self.state_provider.app_hash(snapshot.height)

        # 2. offer to the app (reference :321)
        res = self.proxy_app.snapshot.offer_snapshot(
            at.OfferSnapshotRequest(
                snapshot=at.Snapshot(
                    height=snapshot.height,
                    format=snapshot.format,
                    chunks=snapshot.chunks,
                    hash=snapshot.hash,
                    metadata=snapshot.metadata,
                ),
                app_hash=trusted_app_hash,
            )
        )
        if res.result != at.OFFER_SNAPSHOT_ACCEPT:
            raise ErrSnapshotRejected(f"app returned {res.result}")

        with self._lock:
            self._active = snapshot
            self._chunks = {}

        # 3. fetch + apply chunks in order (reference :357,414)
        self._fetch_chunks(snapshot)
        for idx in range(snapshot.chunks):
            chunk = self._chunks.get(idx)
            ares = self.proxy_app.snapshot.apply_snapshot_chunk(
                at.ApplySnapshotChunkRequest(
                    index=idx, chunk=chunk, sender=""
                )
            )
            if ares.result == at.APPLY_SNAPSHOT_CHUNK_RETRY:
                raise StatesyncError(f"chunk {idx} retry requested")
            if ares.result != at.APPLY_SNAPSHOT_CHUNK_ACCEPT:
                raise ErrSnapshotRejected(
                    f"chunk {idx} rejected ({ares.result})"
                )

        # 4. verify the app took the snapshot (reference :479 verifyApp)
        info = self.proxy_app.query.info(at.InfoRequest())
        if info.last_block_app_hash != trusted_app_hash:
            raise ErrVerifyFailed(
                f"app hash {info.last_block_app_hash.hex()} != trusted "
                f"{trusted_app_hash.hex()}"
            )
        if info.last_block_height != snapshot.height:
            raise ErrVerifyFailed(
                f"app restored to height {info.last_block_height}, "
                f"expected {snapshot.height}"
            )
        self.logger.info("snapshot restored", height=snapshot.height)
        return state, commit

    def _fetch_chunks(self, snapshot: SnapshotKey) -> None:
        """Request all chunks from the snapshot's peers, re-requesting
        missing ones on a bounded exponential backoff until the timeout
        (reference: fetchChunks, concurrent via the reactor's async
        responses).  Both the re-request interval and the poll wait grow
        while no new chunk lands and reset to base on progress, so a burst
        of losses degrades to patient retries instead of a flat-rate
        re-request storm."""
        if snapshot.chunks == 0:
            return  # a complete zero-chunk snapshot needs no fetching
        with self._lock:
            # sorted: peer rotation must not depend on set iteration order
            # (the sim's byte-identical replay would otherwise vary with
            # PYTHONHASHSEED)
            peers = sorted(self.snapshots[snapshot].peers)
        if not peers:
            raise StatesyncError("no peers for snapshot")
        deadline = self._clock() + self.chunk_timeout * max(snapshot.chunks, 1)
        next_req = self._clock()  # first round of requests fires immediately
        retry_s = self.RETRY_BASE_S
        wait_s = self.WAIT_BASE_S
        while self._clock() < deadline:
            with self._lock:
                missing = [
                    i for i in range(snapshot.chunks) if i not in self._chunks
                ]
                have = snapshot.chunks - len(missing)
            if not missing:
                return
            if self._clock() >= next_req:
                for n, idx in enumerate(missing):
                    peer = peers[(n + len(missing)) % len(peers)]
                    self.request_chunk(
                        peer, snapshot.height, snapshot.format, idx
                    )
                next_req = self._clock() + retry_s
                retry_s = min(retry_s * 2.0, self.RETRY_MAX_S)
            self._wait(wait_s)
            self._chunk_event.clear()
            with self._lock:
                progressed = len(self._chunks) > have
            if progressed:
                retry_s = self.RETRY_BASE_S
                wait_s = self.WAIT_BASE_S
            else:
                wait_s = min(wait_s * 2.0, self.WAIT_MAX_S)
        raise StatesyncError("timed out fetching chunks")
