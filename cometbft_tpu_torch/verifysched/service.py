"""Continuous-batching asynchronous verification service.

The kernel only earns its keep when batches are full, yet gossip-time
``Vote.verify`` checks one signature at a time, from many peers at once.
This module is the shared engine that coalesces them — the
continuous-batching scheduler shape from inference serving applied to
signature verification:

  * callers ``submit(pub, msg, sig, priority)`` and get back a Future (or
    bridge whole segments via ``verify_segment_sync``: one that fills a
    padding bucket alone gains nothing from coalescing and is verified in
    one direct supervised dispatch instead);
  * one dispatcher thread coalesces pending items ACROSS all submitters
    into a single ``ops/verify.dispatch_segments`` dispatch, flushing when
    the oldest item has waited ``COMETBFT_TPU_SCHED_FLUSH_US`` (default
    2000) or when the smallest padding bucket fills;
  * up to ``INFLIGHT`` flushes ride the card at once; one completion
    thread fetches them in drain order and resolves their futures;
  * the sigcache is consulted before any queue slot or device lane is
    occupied, and duplicate in-flight triples (the same vote gossiped by
    two peers at once) collapse into one lane;
  * everything below the flush runs under the ``ops/supervisor``, so a
    future ALWAYS completes, and only ever with a definitive verdict — an
    infrastructure failure never becomes a False accept bit.  On a card a
    flush the kernel did not serve completes its futures with
    ``BackendError``; on the CPU the host reference answers it.

Priority classes and admission control: ``consensus`` (vote checks) >
``evidence_light`` (evidence, light client) > ``bulk`` (blocksync,
mempool, and untagged work).  The queue is bounded
(``COMETBFT_TPU_SCHED_QUEUE``, default ``DEFAULT_QUEUE_CAP``); overload
sheds ONLY non-consensus classes — a shed caller falls back to its own
synchronous verify (it loses the batching win, never the verdict) — while
consensus submissions are always admitted.

Activation: the scheduler takes the verify path only when
``COMETBFT_TPU_VERIFY_SCHED`` != 0 (default on) AND the batch backend has
resolved to ``gpu`` on this process (``backend_trusted``).  Otherwise
every wrapper here falls through to the pre-scheduler path, so the kill
switch ``COMETBFT_TPU_VERIFY_SCHED=0`` restores it exactly.

The JAX package's spans and anomaly records (``libs/tracing``) are left
out until that module is ported (ROADMAP §1 item 10); its lane pinning
over the elastic mesh waits for ROADMAP §1 item 4.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Optional, Sequence

from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto.backend_health import BackendError
from cometbft_tpu_torch.ops import dispatch_stats
from cometbft_tpu_torch.verifysched import stats

logger = logging.getLogger("cometbft_tpu_torch.verifysched")

# Priority classes (lower = more important).  EVIDENCE/LIGHT share a class,
# as do BLOCKSYNC/MEMPOOL — three queues cover the real urgency tiers.
PRIO_CONSENSUS = 0
PRIO_EVIDENCE = 1
PRIO_LIGHT = 1
PRIO_BLOCKSYNC = 2
PRIO_MEMPOOL = 2
N_CLASSES = 3

DEFAULT_FLUSH_US = 2000.0
# mirror of ops.verify._BUCKETS, for the ``_bucket_target`` fallback when
# the ops import fails: the target must still be a real padding bucket
_FALLBACK_BUCKETS = (32, 64, 128, 256, 512, 1024, 4096, 8192, 10240, 32768)
# largest fusable bucket (ops.verify._BUCKETS[-1]); a single drain never
# exceeds it — leftovers stay queued for the next flush
MAX_DRAIN = _FALLBACK_BUCKETS[-1]
DEFAULT_QUEUE_CAP = 8192
# flushes dispatched and not yet fetched: on one card the depth buys
# host-prep/device overlap (the JAX package follows the live mesh width,
# ROADMAP §1 item 4)
INFLIGHT = 2


class QueueFullError(Exception):
    """Admission control rejected a non-consensus submission (backpressure).
    The caller verifies synchronously instead — shedding costs the batching
    win, never the verdict."""


def enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_VERIFY_SCHED", "1") != "0"


def backend_trusted() -> bool:
    """True once the batch backend has resolved to ``gpu`` on this process
    (``crypto.batch.default_backend`` ran the card's known-answer
    self-check and it passed).  Never runs the self-check itself: a
    gossip-time ``Vote.verify`` must not be the thing that first touches
    the card; until the batch seam's own first use resolves the backend,
    the gate stays closed."""
    from cometbft_tpu_torch.crypto import batch as cbatch

    return bool(cbatch._SELF_CHECKED)


def scheduler_active() -> bool:
    """True when submissions should take the scheduler path: kill switch
    on AND the batch backend trusted (``backend_trusted``)."""
    return enabled() and backend_trusted()


# -- per-thread priority class ----------------------------------------------

_TLS = threading.local()


def current_priority() -> int:
    """The ambient priority class for this thread.  Call sites that reach
    the scheduler through deep shared layers (the ``_CollectingVerifier``
    bridge under ``types/validation``) tag their work with
    ``priority_class`` instead of plumbing an argument through.

    Fail-closed default: untagged work is BULK (sheddable); the consensus
    class is shed-exempt, so it is only ever handed out explicitly."""
    return getattr(_TLS, "prio", PRIO_BLOCKSYNC)


@contextlib.contextmanager
def priority_class(priority: int):
    prev = getattr(_TLS, "prio", None)
    _TLS.prio = int(priority)
    try:
        yield
    finally:
        if prev is None:
            del _TLS.prio
        else:
            _TLS.prio = prev


def _clamp_prio(priority: int) -> int:
    return min(max(int(priority), 0), N_CLASSES - 1)


# -- the scheduler -----------------------------------------------------------


class _Item:
    # t0 = submit time, t_drain = when the dispatcher drained it out of the
    # queue: submit->drain is QUEUE WAIT, drain->verdict is DEVICE time
    __slots__ = ("pub", "msg", "sig", "prio", "future", "t0", "t_drain")

    def __init__(self, pub, msg, sig, prio, future, t0):
        self.pub = pub
        self.msg = msg
        self.sig = sig
        self.prio = prio
        self.future = future
        self.t0 = t0
        self.t_drain = t0


class VerifyScheduler:
    """One dispatcher thread over three priority queues, and one completion
    thread over the dispatched flushes.  Thread-safe; lazily starts its
    threads on the first queued submission and drains everything (reason
    ``shutdown``) on ``close()`` — a future handed out is always
    eventually resolved.  ``device`` is where its flushes verify
    (``None``: the card)."""

    def __init__(
        self,
        flush_us: Optional[float] = None,
        queue_cap: Optional[int] = None,
        device=None,
    ):
        if flush_us is None:
            try:
                flush_us = float(
                    os.environ.get("COMETBFT_TPU_SCHED_FLUSH_US", "")
                    or DEFAULT_FLUSH_US
                )
            except ValueError:
                flush_us = DEFAULT_FLUSH_US
        if queue_cap is None:
            try:
                queue_cap = int(
                    os.environ.get("COMETBFT_TPU_SCHED_QUEUE", "")
                    or DEFAULT_QUEUE_CAP
                )
            except ValueError:
                queue_cap = DEFAULT_QUEUE_CAP
        self.flush_s = max(flush_us, 0.0) / 1e6
        self.queue_cap = max(int(queue_cap), 1)
        self.device = device
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: "list[deque[_Item]]" = [
            deque() for _ in range(N_CLASSES)
        ]
        self._count = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._paused = False
        self._full_target: Optional[int] = None
        # stamped at dispatch on the dispatcher thread, so intervals are
        # monotonic however many flushes are in flight
        self._last_flush_t: Optional[float] = None
        # in-flight pipeline: FIFO of dispatched-but-unfetched flushes,
        # resolved in drain order by one completion thread; _fcond has its
        # OWN lock so a waiting dispatcher never blocks submitters
        self._flock = threading.Lock()
        self._fcond = threading.Condition(self._flock)
        self._fetch_queue: "deque[tuple]" = deque()
        self._inflight = 0
        self._fetch_thread: Optional[threading.Thread] = None
        self._fetch_stop = False

    # -- submission -------------------------------------------------------

    def _ensure_dispatcher_locked(self) -> None:
        """Start the dispatcher — and RESTART it if it ever died (an
        exception escaping even the ``_execute`` fallback): without this,
        every queued future would hang forever.  Called under the lock."""
        if self._thread is None or not self._thread.is_alive():
            if self._thread is not None:
                logger.error(
                    "verify dispatcher thread died; restarting "
                    "(%d items pending)",
                    self._count,
                )
            self._thread = threading.Thread(
                target=self._run, name="verify-sched", daemon=True
            )
            self._thread.start()

    def submit(
        self,
        pub: bytes,
        msg: bytes,
        sig: bytes,
        priority: int = PRIO_CONSENSUS,
        precleared: bool = False,
    ) -> "Future[bool]":
        """Queue one (pub, msg, sig) check; returns a Future resolving to
        the definitive verdict.  A sigcache hit resolves immediately
        without occupying a queue slot (``precleared=True`` skips that
        lookup — for bridges that just partitioned the cache themselves).
        Raises ``QueueFullError`` for non-consensus classes when the queue
        is at capacity; consensus submissions are always admitted."""
        prio = _clamp_prio(priority)
        fut: "Future[bool]" = Future()
        if not precleared:
            hit = sigcache.get_cache().get(pub, msg, sig)
            if hit is not None:
                stats.record_submit_hit(prio)
                fut.set_result(bool(hit))
                return fut
        with self._cond:
            if self._stopped:
                raise RuntimeError("verify scheduler is stopped")
            if prio != PRIO_CONSENSUS and self._count >= self.queue_cap:
                stats.record_shed(prio)
                # (the JAX package records a "queue_shed" anomaly here,
                # after the lock; it waits for libs/tracing)
                raise QueueFullError(
                    f"verify queue at capacity ({self.queue_cap}); "
                    f"shedding class {stats.CLASS_NAMES[prio]}"
                )
            self._queues[prio].append(
                _Item(pub, msg, sig, prio, fut, time.perf_counter())
            )
            self._count += 1
            stats.record_submit(prio)
            self._ensure_dispatcher_locked()
            self._cond.notify_all()
        return fut

    def submit_many(
        self,
        pubs: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
        priority: int = PRIO_CONSENSUS,
        precleared: bool = False,
    ) -> "list[Optional[Future]]":
        """Submit a whole segment before waiting on any item, so the pieces
        ride one flush: every admitted item is queued under ONE hold of
        the lock, so a dispatcher that wakes meanwhile cannot split the
        segment (a segment of up to ``MAX_DRAIN`` items is one drain).
        Entries the admission control sheds come back as ``None`` — the
        caller verifies those itself; so do all entries of a stopped
        scheduler (teardown race)."""
        prio = _clamp_prio(priority)
        out: "list[Optional[Future]]" = [None] * len(msgs)
        todo = range(len(msgs))
        if not precleared:
            cache = sigcache.get_cache()
            todo = []
            for i, (p, m, s) in enumerate(zip(pubs, msgs, sigs)):
                hit = cache.get(p, m, s)
                if hit is None:
                    todo.append(i)
                    continue
                stats.record_submit_hit(prio)
                out[i] = fut = Future()
                fut.set_result(bool(hit))
        with self._cond:
            if self._stopped:
                return out
            now = time.perf_counter()
            queued = 0
            for i in todo:
                if prio != PRIO_CONSENSUS and self._count >= self.queue_cap:
                    # (the JAX package records a "queue_shed" anomaly)
                    stats.record_shed(prio)
                    continue
                out[i] = fut = Future()
                self._queues[prio].append(
                    _Item(pubs[i], msgs[i], sigs[i], prio, fut, now)
                )
                self._count += 1
                queued += 1
                stats.record_submit(prio)
            if queued:
                self._ensure_dispatcher_locked()
                self._cond.notify_all()
        return out

    # -- hooks for tests and measurements ----------------------------------

    def pause(self) -> None:
        """Hold flushing (build a deterministic backlog)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def pending(self) -> int:
        with self._lock:
            return self._count

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting work, drain the queue (reason ``shutdown``) and
        join the dispatcher, then the completion thread.  Every
        outstanding future resolves.  A thread wedged past the join
        timeout (a stuck device dispatch) is reported loudly."""
        with self._cond:
            self._stopped = True
            self._paused = False
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                logger.warning(
                    "verify scheduler dispatcher still alive %.1fs after "
                    "close() — a wedged flush will finish under whatever "
                    "global state exists when it unwedges",
                    timeout_s,
                )
        # the dispatcher is down (no new enqueues); now drain the
        # completion thread — it exits only once the in-flight FIFO is
        # empty, so every dispatched flush still resolves its futures
        with self._fcond:
            self._fetch_stop = True
            self._fcond.notify_all()
            ft = self._fetch_thread
        if ft is not None:
            ft.join(timeout_s)
            if ft.is_alive():
                logger.warning(
                    "verify scheduler completion thread still alive %.1fs "
                    "after close() — a wedged fetch will finish under "
                    "whatever global state exists when it unwedges",
                    timeout_s,
                )

    # -- dispatcher -------------------------------------------------------

    def _bucket_target(self) -> int:
        """Items that fill the smallest padding bucket: flushing there
        costs no padding on the plain version's ladder, so waiting any
        longer only adds latency.  Computed once, off the submit path (the
        ops import pulls in torch).  The JAX package scales it by the live
        elastic mesh width; the port has one card (ROADMAP §1 item 4)."""
        if self._full_target is None:
            try:
                from cometbft_tpu_torch.ops import verify as ov

                self._full_target = ov.bucket_size(1, ov._BUCKETS[0])
            except Exception:  # noqa: BLE001 — conservative fallback
                self._full_target = _FALLBACK_BUCKETS[0]
        return self._full_target

    def _oldest_t0(self) -> Optional[float]:
        heads = [q[0].t0 for q in self._queues if q]
        return min(heads) if heads else None

    def _drain(self) -> "list[_Item]":
        out: "list[_Item]" = []
        now = time.perf_counter()
        for q in self._queues:  # consensus first
            while q and len(out) < MAX_DRAIN:
                it = q.popleft()
                it.t_drain = now
                out.append(it)
        self._count -= len(out)
        return out

    def _run(self) -> None:
        # (the JAX package starts its warm boot here; the port's build
        # cache and warm boot are ROADMAP §1 item 5)
        full = self._bucket_target()  # the torch import happens here, unlocked
        while True:
            with self._cond:
                while not self._stopped and (
                    self._count == 0 or self._paused
                ):
                    self._cond.wait()
                if self._stopped and self._count == 0:
                    return
                reason = "shutdown"
                if not self._stopped:
                    while True:
                        if self._stopped or self._paused:
                            break
                        if self._count >= full:
                            reason = "full"
                            break
                        oldest = self._oldest_t0()
                        if oldest is None:
                            break
                        remain = oldest + self.flush_s - time.perf_counter()
                        if remain <= 0:
                            reason = "deadline"
                            break
                        self._cond.wait(remain)
                    if self._paused and not self._stopped:
                        continue
                    if self._count == 0:
                        continue
                items = self._drain()
            if items:
                self._execute(items, reason)

    # -- flush ------------------------------------------------------------

    def _execute(self, items: "list[_Item]", reason: str) -> None:
        recorded = [False]
        try:
            # enqueueing onto the completion FIFO is the LAST step of the
            # dispatch, so any exception reaching the fallback below means
            # these items were never handed off
            self._dispatch_flush(items, reason, recorded)
        except BaseException as e:  # noqa: BLE001 — futures must ALWAYS
            # resolve: these items left the queue, so the submit-path
            # dispatcher restart can never recover them
            logger.exception(
                "verify flush failed unexpectedly; resolving its %d items "
                "without the kernel",
                len(items),
            )
            # exactly-once flush accounting
            if not recorded[0]:
                stats.record_flush(reason, items=len(items), misses=0, lanes=0)
            self._resolve_unserved(items, [None] * len(items), e)
            if not isinstance(e, Exception):
                raise  # SystemExit etc.: die, but only AFTER resolving
                # (the next submit detects the dead thread and restarts)

    def _resolve_unserved(self, items, bits, err: BaseException) -> None:
        """Complete every open future whose item the flush did not serve
        (``bits[i] is None``).  On the CPU the host reference answers,
        counted under the host tier.  On a card nothing below the kernel
        may answer: the futures complete with ``BackendError``."""
        from cometbft_tpu_torch.ops import supervisor

        open_ix = [
            i for i, it in enumerate(items)
            if not it.future.done() and bits[i] is None
        ]
        if supervisor._on_card(self.device):
            exc = err if isinstance(err, BackendError) else BackendError(
                f"a verify flush failed before the kernel served it: {err!r}"
            )
            for i in open_ix:
                items[i].future.set_exception(exc)
            return
        from cometbft_tpu_torch.crypto import ed25519_ref as ref

        dispatch_stats.record_tier("host", len(open_ix))
        for i in open_ix:
            it = items[i]
            try:
                bits[i] = len(it.pub) == 32 and len(it.sig) == 64 and bool(
                    ref.verify_zip215(it.pub, it.msg, it.sig)
                )
            except Exception:  # noqa: BLE001 — malformed input
                bits[i] = False
        now = time.perf_counter()
        for i in open_ix:
            items[i].future.set_result(bool(bits[i]))
            stats.record_verdict(items[i].prio, now - items[i].t0)

    def _flush_interval(self) -> Optional[float]:
        """Interval between consecutive flushes, stamped now on the
        dispatcher thread."""
        t = time.perf_counter()
        interval = None if self._last_flush_t is None else t - self._last_flush_t
        self._last_flush_t = t
        return interval

    def _dispatch_flush(
        self, items: "list[_Item]", reason: str, recorded: "list[bool]"
    ) -> None:
        """The front half of a flush: structural filter + dedup + ONE
        fused dispatch (``ops.verify.dispatch_segments``), then hand the
        in-flight handle to the completion thread and return to draining
        — up to ``INFLIGHT`` flushes ride the card at once.  (The JAX
        package's "sched.flush" span covers this.)"""
        n = len(items)
        pubs = [it.pub for it in items]
        msgs = [it.msg for it in items]
        sigs = [it.sig for it in items]
        interval = self._flush_interval()

        # structural filter (garbage never occupies a device lane) +
        # in-flight dedup: concurrent gossip of the same vote collapses
        # into one lane, both futures share the verdict
        bits: "list[Optional[bool]]" = [None] * n
        uniq: "OrderedDict[bytes, list[int]]" = OrderedDict()
        for i in range(n):
            if len(pubs[i]) != 32 or len(sigs[i]) != 64:
                bits[i] = False
                continue
            k = sigcache._key(pubs[i], msgs[i], sigs[i])
            uniq.setdefault(k, []).append(i)
        firsts = [ixs[0] for ixs in uniq.values()]
        stats.record_dedup(sum(len(ixs) - 1 for ixs in uniq.values()))

        lanes = 0
        handle = None
        ordered: "list[int]" = []
        if firsts:
            from cometbft_tpu_torch.ops import verify as ov

            # one segment per priority class present: dispatch_segments
            # fuses them into ONE dispatch and splits the bits back
            by_class: "list[list[int]]" = [[] for _ in range(N_CLASSES)]
            for i in firsts:
                by_class[items[i].prio].append(i)
            ordered = [i for cls in by_class for i in cls]
            work = [
                (
                    [pubs[i] for i in cls],
                    [msgs[i] for i in cls],
                    [sigs[i] for i in cls],
                )
                for cls in by_class
                if cls
            ]
            lanes = ov.bucket_size(len(ordered), ov._BUCKETS[0])
            self._ensure_fetch_thread()
            # reserve an in-flight slot BEFORE dispatching; the wait
            # re-checks the completion thread so a dead one is restarted
            # rather than waited on forever
            with self._fcond:
                while self._inflight >= INFLIGHT:
                    if (
                        self._fetch_thread is None
                        or not self._fetch_thread.is_alive()
                    ):
                        break
                    self._fcond.wait(0.1)
                self._inflight += 1
                stats.record_inflight(self._inflight)
            self._ensure_fetch_thread()
            try:
                # (the JAX package's "sched.dispatch" span goes here)
                handle = ov.dispatch_segments(work, device=self.device)
            except BaseException:
                with self._fcond:
                    self._inflight -= 1
                    stats.record_inflight(self._inflight)
                    self._fcond.notify_all()
                raise

        stats.record_flush(
            reason, items=n, misses=len(firsts), lanes=lanes,
            interval_s=interval,
        )
        recorded[0] = True
        if handle is None:
            # nothing device-bound (all garbage): resolve inline
            now = time.perf_counter()
            for i, it in enumerate(items):
                it.future.set_result(bool(bits[i]))
                stats.record_verdict(
                    it.prio,
                    now - it.t0,
                    queue_wait_s=it.t_drain - it.t0,
                    device_s=now - it.t_drain,
                )
            return
        with self._fcond:
            self._fetch_queue.append((handle, items, bits, uniq, ordered))
            self._fcond.notify_all()

    def _ensure_fetch_thread(self) -> None:
        """Start — or RESTART, mirroring the dispatcher's own restart
        path — the completion thread.  A dead completion thread with
        flushes still queued would strand their futures forever."""
        with self._fcond:
            if self._fetch_thread is None or not self._fetch_thread.is_alive():
                if self._fetch_thread is not None:
                    logger.error(
                        "verify completion thread died; restarting "
                        "(%d flushes in flight)",
                        len(self._fetch_queue),
                    )
                self._fetch_thread = threading.Thread(
                    target=self._fetch_run,
                    name="verify-sched-fetch",
                    daemon=True,
                )
                self._fetch_thread.start()

    def _fetch_run(self) -> None:
        while True:
            with self._fcond:
                while not self._fetch_queue and not self._fetch_stop:
                    self._fcond.wait()
                if not self._fetch_queue:
                    return  # stop requested and FIFO drained
                pf = self._fetch_queue.popleft()
            try:
                self._resolve_flush(pf)
            finally:
                with self._fcond:
                    self._inflight = max(0, self._inflight - 1)
                    stats.record_inflight(self._inflight)
                    self._fcond.notify_all()

    def _resolve_flush(self, pf: tuple) -> None:
        """The completion half of one flush: fetch verdicts, write the
        sigcache back, resolve every future.  Runs on the completion
        thread in drain order; cannot leave a future unresolved — a fetch
        that raises (on a card, the supervisor's ``BackendError``)
        completes the flush's open futures through ``_resolve_unserved``.
        (The JAX package's "sched.fetch" span covers the fetch.)"""
        handle, items, bits, uniq, ordered = pf
        try:
            from cometbft_tpu_torch.ops import verify as ov

            results = ov.fetch_segments(handle)
            verdict_by_first = dict(
                zip(ordered, (bool(b) for seg in results for b in seg))
            )
            # every member of each dedup group + cache writeback, with the
            # keys the dedup loop already computed; supervised verdicts are
            # always definitive, so caching them is safe
            cache = sigcache.get_cache()
            cache_on = cache.enabled()
            for k, ixs in uniq.items():
                v = verdict_by_first[ixs[0]]
                for i in ixs:
                    bits[i] = v
                if cache_on:
                    cache._put(k, v)
        except BaseException as e:  # noqa: BLE001 — swallow even
            # SystemExit: the completion thread must outlive one bad flush
            # or every queued flush behind it strands its futures
            if isinstance(e, BackendError):
                logger.warning(
                    "verify flush of %d items not served by the kernel: %s",
                    len(items), e,
                )
            else:
                logger.exception(
                    "pipelined flush fetch failed unexpectedly; resolving "
                    "its %d items without the kernel",
                    len(items),
                )
            self._resolve_unserved(items, bits, e)
        now = time.perf_counter()
        for i, it in enumerate(items):
            if it.future.done():
                continue
            it.future.set_result(bool(bits[i]))
            stats.record_verdict(
                it.prio,
                now - it.t0,
                queue_wait_s=it.t_drain - it.t0,
                device_s=now - it.t_drain,
            )


# -- process-wide instance ----------------------------------------------------

_SCHED: Optional[VerifyScheduler] = None
_SCHED_LOCK = threading.Lock()


def get_scheduler() -> VerifyScheduler:
    """The process-wide scheduler on the card (consensus, evidence, light
    and blocksync all share one — that sharing IS the optimization)."""
    global _SCHED
    if _SCHED is None:
        with _SCHED_LOCK:
            if _SCHED is None:
                _SCHED = VerifyScheduler()
    return _SCHED


def reset_scheduler() -> None:
    """Drain + drop the process-wide scheduler (tests; also re-reads the
    flush/queue environment on next use)."""
    global _SCHED
    with _SCHED_LOCK:
        sched, _SCHED = _SCHED, None
    if sched is not None:
        sched.close()


# -- call-site wrappers -------------------------------------------------------


def _ed25519_pub(pub_key) -> Optional[bytes]:
    from cometbft_tpu_torch.crypto import keys as ck

    if getattr(pub_key, "type_", None) != ck.ED25519_KEY_TYPE:
        return None
    return pub_key.bytes() if hasattr(pub_key, "bytes") else bytes(pub_key)


def verify_now(pub_key, msg: bytes, sig: bytes) -> bool:
    """Synchronous escape hatch: cache-through single verification with no
    queueing — exactly the pre-scheduler path."""
    return sigcache.verify_with_cache(pub_key, msg, sig)


def _shed_fallback_verify(pub_key, msg: bytes, sig: bytes, prio: int) -> bool:
    """The synchronous verify a SHED caller runs; its submit->verdict time
    stays in the latency record.  (The JAX package also spans it.)"""
    t0 = time.perf_counter()
    ok = verify_now(pub_key, msg, sig)
    stats.record_shed_fallback(prio, time.perf_counter() - t0)
    return ok


def verify_cached(pub_key, msg: bytes, sig: bytes, priority=None) -> bool:
    """THE drop-in for ``sigcache.verify_with_cache`` on scheduler-wired
    call sites (gossip-time ``Vote.verify``).  Scheduler inactive,
    non-ed25519 key, or shed by admission control -> the synchronous
    path, verdict-identical."""
    prio = current_priority() if priority is None else priority
    if scheduler_active():
        pub = _ed25519_pub(pub_key)
        if pub is not None:
            try:
                fut = get_scheduler().submit(pub, msg, sig, prio)
            except (QueueFullError, RuntimeError):
                # shed, or scheduler torn down under us (reset race)
                return _shed_fallback_verify(pub_key, msg, sig, prio)
            # a flush the kernel did not serve raises BackendError here
            return bool(fut.result())
    return verify_now(pub_key, msg, sig)


def verify_many_cached(
    pub_keys, msgs: Sequence[bytes], sigs: Sequence[bytes], priority=None
) -> "list[bool]":
    """Several independent checks submitted before waiting on any, so they
    ride one flush.  Falls back per item on shed / inactive /
    non-ed25519."""
    prio = current_priority() if priority is None else priority
    out: "list[Optional[bool]]" = [None] * len(msgs)
    futs: "list[Optional[Future]]" = [None] * len(msgs)
    shed_ix: set = set()
    if scheduler_active():
        sched = get_scheduler()
        for i, (pk, m, s) in enumerate(zip(pub_keys, msgs, sigs)):
            pub = _ed25519_pub(pk)
            if pub is None:
                continue
            try:
                futs[i] = sched.submit(pub, m, s, prio)
            except (QueueFullError, RuntimeError):
                shed_ix.add(i)  # shed or torn down: sync fallback below
    for i, (pk, m, s) in enumerate(zip(pub_keys, msgs, sigs)):
        if futs[i] is not None:
            out[i] = bool(futs[i].result())
        elif i in shed_ix:
            out[i] = _shed_fallback_verify(pk, m, s, prio)
        else:
            out[i] = verify_now(pk, m, s)
    return out


def verify_segment_sync(
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    priority=None,
) -> "list[bool]":
    """The batch-verifier bridge: submit a pre-partitioned segment of raw
    ed25519 triples (the caller — ``_CollectingVerifier`` — already took
    its cache hits) and wait for all verdicts.  Entries shed by admission
    control are verified in one direct supervised dispatch instead, so the
    call never blocks on queue capacity.

    A segment that fills the flush target (``_bucket_target``) by itself
    skips the queue: the dispatcher would flush it at once, as one launch,
    so coalescing gains it nothing, and the queue's per-item work (a
    future, dedup key, cache write and latency record per triple) would
    cost more than its kernel.  It is one direct supervised dispatch, and
    the caller writes its verdicts back to the cache."""
    from cometbft_tpu_torch.ops import verify as ov

    prio = current_priority() if priority is None else priority
    sched = get_scheduler()
    if len(pubs) >= sched._bucket_target():
        # (the JAX package submits every segment through submit_many)
        return [bool(b) for b in ov.verify_batch(pubs, msgs, sigs, sched.device)]
    futs = sched.submit_many(pubs, msgs, sigs, prio, precleared=True)
    shed = [i for i, f in enumerate(futs) if f is None]
    direct: dict = {}
    if shed:
        t0 = time.perf_counter()
        # (the JAX package's "sched.shed_fallback" span goes here)
        got = ov.verify_batch(
            [pubs[i] for i in shed],
            [msgs[i] for i in shed],
            [sigs[i] for i in shed],
            sched.device,
        )
        dt = time.perf_counter() - t0
        for _ in shed:
            # every shed item waited for the whole direct dispatch
            stats.record_shed_fallback(prio, dt)
        direct = {i: bool(b) for i, b in zip(shed, got)}
    return [
        direct[i] if f is None else bool(f.result())
        for i, f in enumerate(futs)
    ]
