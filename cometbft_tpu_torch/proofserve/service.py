"""Coalescing proof server for light-client read traffic.

The port of ``cometbft_tpu/proofserve/service.py``.  Every
``tx(prove=True)``, header and validator-hash query of a light client
would otherwise build its own tree; at thousands of clients that is
thousands of identical builds per block.  The server is the read-side
sibling of ``verifysched/service.py``:

  * callers ``submit(kind, height)`` into a bounded queue and get a
    Future;
  * one dispatcher thread coalesces the pending queries of all clients
    into (kind, height) groups and builds each group once through
    ``proofserve/plane.py`` (the tree kernel when the gate is open, the
    host reference otherwise; bit-identical either way), flushing when the
    oldest query has waited ``COMETBFT_TPU_PROOFSERVE_FLUSH_US`` (default
    1,000) or the queue is full (``COMETBFT_TPU_PROOFSERVE_QUEUE``, default
    4,096);
  * an LRU cache keyed (kind, height) (``COMETBFT_TPU_PROOFSERVE_CACHE``,
    default 128 entries) answers repeated queries without a queue slot;
  * ``prove_tx`` answers a shed (``QueueFullError``), a future timeout or
    a stopped server (``ServerStoppedError``) with the caller's serial
    host build: those cost the coalescing, never the response.

Unlike the JAX ``prove_tx``, which catches every ``RuntimeError`` around
the future, the port lets any other error of a build reach the caller.  A
failed tree pass on a card raises ``BackendError`` (a ``RuntimeError``),
and answering it on the host would hide the kernel's fault; so a stopped
server has an error class of its own and nothing else steps down.

The server knows no block or state types: three loaders are given at
``configure`` time, ``tx_loader(h) -> list of tx bytes | None``,
``header_hasher(h) -> bytes | None`` and ``valset_hasher(h) -> bytes |
None``.  The kill switch ``COMETBFT_TPU_PROOFSERVE=0`` (the plane's)
restores the serial path bit for bit.  A flush records a ``proof.flush``
span and a shed query a ``proof_shed`` anomaly (``libs/tracing``), as in
the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Optional

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.proofserve import plane
from cometbft_tpu_torch.proofserve import stats as pstats

logger = logging.getLogger("cometbft_tpu_torch.proofserve")

DEFAULT_FLUSH_US = 1000.0
DEFAULT_QUEUE_CAP = 4096
DEFAULT_CACHE_CAP = 128

KINDS = pstats.KINDS


class QueueFullError(Exception):
    """Admission control refused a proof query (backpressure).  The caller
    builds serially instead: a shed costs the coalescing, never the
    response."""


class ServerStoppedError(RuntimeError):
    """``submit`` on a server that ``close`` stopped (a stop race at node
    shutdown).  ``prove_tx`` answers it with the serial host build."""


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


class _Query:
    __slots__ = ("kind", "height", "future", "t0")

    def __init__(self, kind, height, future, t0):
        self.kind = kind
        self.height = height
        self.future = future
        self.t0 = t0


class ProofServer:
    """One dispatcher thread over one bounded queue of (kind, height)
    proof queries.  Thread-safe; starts (and restarts) its thread at the
    first queued submission and drains everything (reason ``shutdown``) on
    ``close()``: every future handed out is resolved.

    Results: ``tx`` -> ``(root, [Proof])`` for the whole block (the
    caller picks its tx: that sharing is the coalescing) or ``None`` for a
    missing height; ``header``/``valset`` -> ``bytes`` or ``None``."""

    def __init__(
        self,
        tx_loader: Callable[[int], Optional[list]],
        header_hasher: Callable[[int], Optional[bytes]],
        valset_hasher: Callable[[int], Optional[bytes]],
        flush_us: Optional[float] = None,
        queue_cap: Optional[int] = None,
        cache_cap: Optional[int] = None,
    ):
        self._loaders = {
            "tx": tx_loader,
            "header": header_hasher,
            "valset": valset_hasher,
        }
        if flush_us is None:
            flush_us = _env_float("COMETBFT_TPU_PROOFSERVE_FLUSH_US",
                                  DEFAULT_FLUSH_US)
        if queue_cap is None:
            queue_cap = _env_int("COMETBFT_TPU_PROOFSERVE_QUEUE", DEFAULT_QUEUE_CAP)
        if cache_cap is None:
            cache_cap = _env_int("COMETBFT_TPU_PROOFSERVE_CACHE", DEFAULT_CACHE_CAP)
        self.flush_s = max(float(flush_us), 0.0) / 1e6
        self.queue_cap = max(int(queue_cap), 1)
        self.cache_cap = max(int(cache_cap), 1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[_Query]" = deque()
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._paused = False

    # -- submission -------------------------------------------------------

    def submit(self, kind: str, height: int) -> "Future":
        """Queue one proof query; returns a Future.  A cache hit resolves
        at once without a queue slot.  Raises ``QueueFullError`` at
        capacity (proof traffic is all read-class: no query is exempt) and
        ``ServerStoppedError`` after ``close``."""
        if kind not in KINDS:
            raise ValueError(f"unknown proof kind {kind!r}")
        height = int(height)
        fut: "Future" = Future()
        try:
            with self._cond:
                if self._stopped:
                    raise ServerStoppedError("proof server is stopped")
                key = (kind, height)
                if key in self._cache:
                    self._cache.move_to_end(key)
                    pstats.record_cache_hit(kind)
                    fut.set_result(self._cache[key])
                    return fut
                if len(self._queue) >= self.queue_cap:
                    pstats.record_shed(kind)
                    raise QueueFullError(
                        f"proof queue at capacity ({self.queue_cap}); shedding "
                        f"{kind} query")
                self._queue.append(_Query(kind, height, fut, time.perf_counter()))
                pstats.record_query(kind)
                if self._thread is None or not self._thread.is_alive():
                    if self._thread is not None:
                        logger.error("proof dispatcher thread died; restarting "
                                     "(%d queries pending)", len(self._queue))
                    self._thread = threading.Thread(target=self._run,
                                                    name="proof-serve",
                                                    daemon=True)
                    self._thread.start()
                self._cond.notify_all()
        except QueueFullError:
            # anomaly recorded AFTER the cond is released: the flight
            # recorder's ring-dump IO must never block other submitters
            tracing.record_anomaly(
                "proof_shed", query_kind=kind, queue_cap=self.queue_cap
            )
            raise
        return fut

    # -- test and bench hooks ---------------------------------------------

    def pause(self) -> None:
        """Hold flushing (tests: build a backlog that one flush takes)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def cached(self, kind: str, height: int) -> bool:
        with self._lock:
            return (kind, int(height)) in self._cache

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop taking work, drain the queue (reason ``shutdown``) and join
        the dispatcher.  Every outstanding future resolves."""
        with self._cond:
            self._stopped = True
            self._paused = False
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                logger.warning("proof dispatcher still alive %.1fs after close()",
                               timeout_s)

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
                        if len(self._queue) >= self.queue_cap:
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
                    if (self._paused and not self._stopped) or not self._queue:
                        continue
                items = list(self._queue)
                self._queue.clear()
            self._execute(items, reason)

    # -- flush ------------------------------------------------------------

    def _build(self, kind: str, height: int):
        """One uncached build through the plane: ``tx`` builds the whole
        block's proofs in one tree pass; ``header``/``valset`` call their
        hashers, whose trees go through the plane at the type layer."""
        if kind == "tx":
            txs = self._loaders["tx"](height)
            if txs is None:
                return None
            return plane.tree_proofs([bytes(t) for t in txs])
        return self._loaders[kind](height)

    def _execute(self, items: "list[_Query]", reason: str) -> None:
        recorded = [False]
        try:
            self._execute_inner(items, reason, recorded)
        except BaseException as e:  # noqa: BLE001 — futures must always
            # resolve: these queries left the queue, so nothing else can
            logger.exception("proof flush failed unexpectedly; failing %d "
                             "queries", len(items))
            if not recorded[0]:
                pstats.record_flush(reason, len(items), 0)
            for it in items:
                if not it.future.done():
                    it.future.set_exception(
                        e if isinstance(e, Exception) else RuntimeError(
                            type(e).__name__))
            if not isinstance(e, Exception):
                raise

    def _execute_inner(self, items: "list[_Query]", reason: str,
                       recorded: "list[bool]") -> None:
        groups: "OrderedDict[tuple, list[_Query]]" = OrderedDict()
        for it in items:
            groups.setdefault((it.kind, it.height), []).append(it)
        resolutions: "list[tuple[Future, object, Optional[Exception]]]" = []
        builds = 0
        with tracing.span(
            "proof.flush",
            reason=reason,
            queries=len(items),
            groups=len(groups),
        ) as sp:
            for (kind, height), members in groups.items():
                with self._lock:
                    hit = (kind, height) in self._cache
                    val = self._cache.get((kind, height))
                if not hit:
                    pstats.record_cache_miss()
                    try:
                        val = self._build(kind, height)
                    except Exception as e:  # noqa: BLE001 — fail the group,
                        # flush the rest; its callers see the error
                        resolutions.extend((m.future, None, e) for m in members)
                        continue
                    pstats.record_build(kind)
                    builds += 1
                    if val is not None:
                        with self._lock:
                            self._cache[(kind, height)] = val
                            self._cache.move_to_end((kind, height))
                            while len(self._cache) > self.cache_cap:
                                self._cache.popitem(last=False)
                resolutions.extend((m.future, val, None) for m in members)
            sp.set(builds=builds)
        # recorded before resolving: a waiter that reads the stats right
        # after its result must see this flush
        pstats.record_flush(reason, len(items), len(groups))
        recorded[0] = True
        for fut, val, exc in resolutions:
            if fut.done():
                continue
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(val)


# -- the process-wide server --------------------------------------------------

_SERVER: Optional[ProofServer] = None
_SERVER_LOCK = threading.Lock()


def configure(tx_loader, header_hasher, valset_hasher, **kwargs) -> ProofServer:
    """Install the process-wide proof server (a node does so at start, with
    loaders over its stores).  Replaces, and drains, any previous one."""
    global _SERVER
    server = ProofServer(tx_loader, header_hasher, valset_hasher, **kwargs)
    with _SERVER_LOCK:
        prev, _SERVER = _SERVER, server
    if prev is not None:
        prev.close()
    return server


def get_server() -> Optional[ProofServer]:
    with _SERVER_LOCK:
        return _SERVER


def reset_server() -> None:
    """Drain and drop the process-wide server (node stop, tests)."""
    global _SERVER
    with _SERVER_LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.close()


def server_active() -> bool:
    """True when proof queries ride the coalescer: the kill switch on and a
    server configured."""
    return plane.enabled() and get_server() is not None


def prove_tx(tx_loader, height: int, index: int, timeout_s: float = 5.0):
    """(root, Proof) of tx ``index`` of block ``height``, or None when the
    height or the index does not exist: the call an RPC handler makes.
    Coalesced through the server when it is active; a shed, a timeout, a
    stopped server or no server at all is answered by the serial host
    build (``merkle.proofs_from_byte_slices``), and counted when the
    server was active.  Any other error of the build, ``BackendError``
    from the tree kernel on a card above all, reaches the caller."""
    server = get_server()
    if plane.enabled() and server is not None:
        try:
            res = server.submit("tx", height).result(timeout_s)
        except (QueueFullError, FutureTimeoutError, ServerStoppedError):
            pstats.record_serial_fallback()
        else:
            if res is None:
                return None
            root, proofs = res
            return (root, proofs[index]) if 0 <= index < len(proofs) else None
    txs = tx_loader(height)
    if txs is None:
        return None
    txs = [bytes(t) for t in txs]
    if not 0 <= index < len(txs):
        return None
    root, proofs = merkle.proofs_from_byte_slices(txs)
    return root, proofs[index]
