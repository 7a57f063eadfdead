"""Batched X25519 handshake admission: concurrent dials coalesced into
ladder passes.

Counterpart of the JAX package's ``p2p/handshake_pool.py``.  A connection
storm presents many concurrent ``SecretConnection`` handshakes, each with
two X25519 evaluations (its ephemeral public key and the ECDH).  Callers
``exchange(scalar, peer_pub)`` and block on a Future while one dispatcher
thread fuses every pending exchange, across all dialing threads, into one
``ops/x25519_ladder.exchange_batch`` (one launch of the ladder kernel on a
card), flushing when the oldest waiter has aged
``COMETBFT_TPU_HANDSHAKE_FLUSH_US`` (2,000) or
``COMETBFT_TPU_HANDSHAKE_MAX_BATCH`` (256) exchanges are queued.

Shed dials: the queue is bounded (``COMETBFT_TPU_HANDSHAKE_QUEUE``,
1,024).  At capacity, or when a future is not resolved within
``COMETBFT_TPU_HANDSHAKE_TIMEOUT_S`` (5), the dial takes the synchronous
path (``sync_exchange``), counted as shed: on a card one direct
supervised launch of the ladder kernel for that pair, elsewhere the host
reference.  Shedding costs the batching, never the handshake.

Activation: ``COMETBFT_TPU_HANDSHAKE`` is not 0 and the ladder's device
pass is live for the dial's device (``x25519_ladder.device_active``: a
device named, a runner installed, or the gate open).  Inactive, the pool
is bypassed and ``exchange`` is ``sync_exchange``.

The port's rule differs from the JAX package's in one place: a flush the
ladder did not serve (on a card ``exchange_batch`` raises
``BackendError``) resolves its dials' futures with that error; the JAX
package answers them on the host ladder.  A flush records a
``handshake.flush`` span, a shed dial a ``handshake_shed`` anomaly and a
timed-out one a ``handshake_timeout`` anomaly (``libs/tracing``), as in
the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Optional, Sequence

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import x25519_ladder
from cometbft_tpu_torch.p2p import transport_stats as tstats

logger = logging.getLogger("cometbft_tpu_torch.p2p.handshake_pool")

DEFAULT_FLUSH_US = 2000.0
DEFAULT_QUEUE_CAP = 1024
DEFAULT_MAX_BATCH = 256
DEFAULT_TIMEOUT_S = 5.0


class QueueFullError(Exception):
    """Admission control rejected a submission (backpressure).  The caller
    dials synchronously instead."""


def enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_HANDSHAKE", "1") != "0"


def active(device=None) -> bool:
    """True when exchanges on ``device`` take the pool: the kill switch is
    on and the ladder's device pass is live."""
    return enabled() and x25519_ladder.device_active(device)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def sync_exchange(scalar: bytes, peer_pub: bytes, device=None) -> bytes:
    """The synchronous dial that every shed, timed-out or inactive path
    takes: where the ladder's device pass is live on a card, one direct
    supervised launch for this pair; elsewhere the host reference.  No
    device named means the gate's (``verifysched.gate_device``)."""
    from cometbft_tpu_torch.ops import dispatch_stats, supervisor
    from cometbft_tpu_torch.verifysched import service

    if device is None:
        device = service.gate_device()
    if x25519_ladder.device_active(device) and supervisor._on_card(device):
        return x25519_ladder.exchange_batch([(scalar, peer_pub)], device)[0]
    dispatch_stats.record_tier("host", 1, x25519_ladder.X25519)
    return x25519_ladder.host_exchange([(scalar, peer_pub)])[0]


class _Req:
    __slots__ = ("pair", "device", "future", "t0")

    def __init__(self, pair, device, future, t0):
        self.pair = pair
        self.device = device
        self.future = future
        self.t0 = t0


class HandshakePool:
    """One dispatcher thread over a bounded FIFO of pending exchanges.
    Thread-safe; starts (and restarts, should it have died) its thread on
    the first queued submission, and drains everything (reason
    ``shutdown``) on ``close()``: a future handed out is always resolved."""

    def __init__(self, flush_us: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 max_batch: Optional[int] = None):
        if flush_us is None:
            flush_us = _env_float("COMETBFT_TPU_HANDSHAKE_FLUSH_US",
                                  DEFAULT_FLUSH_US)
        if queue_cap is None:
            queue_cap = _env_int("COMETBFT_TPU_HANDSHAKE_QUEUE", DEFAULT_QUEUE_CAP)
        if max_batch is None:
            max_batch = _env_int("COMETBFT_TPU_HANDSHAKE_MAX_BATCH",
                                 DEFAULT_MAX_BATCH)
        self.flush_s = max(float(flush_us), 0.0) / 1e6
        self.queue_cap = max(int(queue_cap), 1)
        self.max_batch = max(int(max_batch), 1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[_Req]" = deque()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._paused = False

    # -- submission -------------------------------------------------------

    def submit(self, scalar: bytes, peer_pub: bytes, device=None) -> "Future[bytes]":
        """Queue one exchange on ``device``; returns a Future of the 32-byte
        shared secret.  Raises ``QueueFullError`` at capacity."""
        fut: "Future[bytes]" = Future()
        with self._cond:
            if self._stopped:
                raise RuntimeError("handshake pool is stopped")
            if len(self._queue) >= self.queue_cap:
                raise QueueFullError(
                    f"handshake queue at capacity ({self.queue_cap}); "
                    "shedding to the synchronous dial")
            self._queue.append(_Req((bytes(scalar), bytes(peer_pub)), device,
                                    fut, time.perf_counter()))
            tstats.record_hs_enqueued()
            if self._thread is None or not self._thread.is_alive():
                if self._thread is not None:
                    logger.error("handshake dispatcher thread died; restarting "
                                 "(%d dials pending)", len(self._queue))
                self._thread = threading.Thread(target=self._run,
                                                name="handshake-pool", daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return fut

    # -- test hooks -------------------------------------------------------

    def pause(self) -> None:
        """Hold flushing (tests: build a backlog that resumes as one
        coalesced pass)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting work, drain the queue (reason ``shutdown``) and
        join the dispatcher.  Every outstanding future resolves."""
        with self._cond:
            self._stopped = True
            self._paused = False
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                logger.warning("handshake pool dispatcher still alive %.1fs "
                               "after close()", timeout_s)

    # -- dispatcher -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and (not self._queue or self._paused):
                    self._cond.wait()
                if self._stopped and not self._queue:
                    return
                reason = "shutdown"
                if not self._stopped:
                    while True:
                        if self._stopped or self._paused:
                            break
                        if len(self._queue) >= self.max_batch:
                            reason = "full"
                            break
                        if not self._queue:
                            break
                        remain = (self._queue[0].t0 + self.flush_s
                                  - time.perf_counter())
                        if remain <= 0:
                            reason = "deadline"
                            break
                        self._cond.wait(remain)
                    if self._paused and not self._stopped:
                        continue
                    if not self._queue:
                        continue
                batch: "list[_Req]" = []
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
            if batch:
                self._execute(batch, reason)

    def _execute(self, batch: "list[_Req]", reason: str) -> None:
        groups: "dict[object, list[_Req]]" = {}
        for r in batch:
            groups.setdefault(r.device, []).append(r)
        try:
            with tracing.span("handshake.flush", reason=reason, items=len(batch)):
                results = {dev: x25519_ladder.exchange_batch([r.pair for r in reqs],
                                                             dev)
                           for dev, reqs in groups.items()}
        except BaseException as e:  # noqa: BLE001 — futures must ALWAYS
            # resolve: these dials left the queue
            logger.warning("handshake flush of %d dials failed: %r; the dials "
                           "raise", len(batch), e)
            tstats.record_hs_flush(reason, len(batch))
            for r in batch:
                r.future.set_exception(e)
            if not isinstance(e, Exception):
                raise
            return
        # record before resolving: a caller reading the counters right after
        # its secret must find its flush counted
        tstats.record_hs_flush(reason, len(batch))
        for dev, reqs in groups.items():
            for r, secret in zip(reqs, results[dev]):
                r.future.set_result(secret)


# -- process-wide instance ----------------------------------------------------

_POOL: Optional[HandshakePool] = None
_POOL_LOCK = threading.Lock()


def get_pool() -> HandshakePool:
    """The process-wide pool: every dialing thread shares it, which is the
    point."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = HandshakePool()
    return _POOL


def reset_pool() -> None:
    """Drain and drop the process-wide pool (tests; the switches are read
    again on next use)."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.close()


# -- call-site wrappers -------------------------------------------------------


def _timeout_s() -> float:
    return _env_float("COMETBFT_TPU_HANDSHAKE_TIMEOUT_S", DEFAULT_TIMEOUT_S)


def _shed(scalar: bytes, peer_pub: bytes, device, kind: str, **attrs) -> bytes:
    tstats.record_hs_shed()
    tstats.record_handshake("sync")
    tracing.record_anomaly(kind, **attrs)
    return sync_exchange(scalar, peer_pub, device)


def exchange(scalar: bytes, peer_pub: bytes, device=None) -> bytes:
    """The SecretConnection ECDH: pool-coalesced when active, synchronous
    otherwise; shed or timed out, the dial proceeds synchronously.  Raises
    ``ValueError`` for malformed key lengths, and on a card
    ``BackendError`` when the ladder kernel did not serve the flush."""
    if not active(device):
        tstats.record_handshake("sync")
        return sync_exchange(scalar, peer_pub, device)
    try:
        fut = get_pool().submit(scalar, peer_pub, device)
    except (QueueFullError, RuntimeError):
        # at capacity, or the pool torn down under us (a reset race)
        return _shed(scalar, peer_pub, device, "handshake_shed",
                     queue_cap=get_pool().queue_cap)
    try:
        out = fut.result(_timeout_s())
    except FutureTimeoutError:
        # a wedged dispatcher: the dial must not hang; the straggling flush
        # resolves the orphaned future later
        return _shed(scalar, peer_pub, device, "handshake_timeout",
                     timeout_s=_timeout_s())
    tstats.record_handshake("pool")
    return out


def exchange_many(pairs: "Sequence[tuple[bytes, bytes]]",
                  device=None) -> "list[bytes]":
    """Several exchanges submitted before waiting on any, so that they ride
    one flush.  Shed entries take the synchronous path one by one."""
    futs: "list[Optional[Future]]" = []
    if active(device):
        pool = get_pool()
        for s, u in pairs:
            try:
                futs.append(pool.submit(s, u, device))
            except (QueueFullError, RuntimeError):
                tstats.record_hs_shed()
                futs.append(None)
    else:
        futs = [None] * len(pairs)
    out: "list[bytes]" = []
    for f, (s, u) in zip(futs, pairs):
        if f is None:
            tstats.record_handshake("sync")
            out.append(sync_exchange(s, u, device))
            continue
        try:
            out.append(f.result(_timeout_s()))
            tstats.record_handshake("pool")
        except FutureTimeoutError:
            out.append(_shed(s, u, device))
    return out


def public_key(scalar: bytes, device=None) -> bytes:
    """X25519 public key: a ladder over the base point, so it coalesces
    into the same flushes as the exchanges."""
    return exchange(scalar, x25519_ladder.BASE_U, device)
