"""Ingest coalescer: gossip burst -> one batched CheckTx round trip.

The mempool reactor hands every incoming gossip tx to ``submit``; a
flusher drains the bounded queue when the oldest tx has waited
``COMETBFT_TPU_TXINGEST_FLUSH_US`` (default 5000) or when
``COMETBFT_TPU_TXINGEST_BATCH`` (default 256) txs are pending, and
admits the whole batch through ``CListMempool.check_tx_batch`` — cache
dedup before any queue slot, envelope signatures verified as the
verifysched BULK class, one ``check_txs`` app round trip for the
survivors (docs/tx-ingest.md).

Degradation is always to the per-tx synchronous path, never to a dropped
verdict: a full ingest queue (``COMETBFT_TPU_TXINGEST_QUEUE``, default
4096) sheds the submission to ``mempool.check_tx``; the kill switch
``COMETBFT_TPU_TXINGEST=0`` disables the pipeline entirely, restoring
per-tx admission bit-for-bit.  Activation additionally gates on the same
trusted-backend check as the verification scheduler: a CPU-backend node
has no dispatch floor to amortize, so it keeps today's synchronous
behavior untouched.

Thread model: a daemon flusher thread in production
(``start_thread=True``); the deterministic simulator builds coalescers
with ``start_thread=False`` and drives ``flush_now`` explicitly from
scripted virtual-time actions.

``device=None`` means the card: built with no card, the coalescer raises
unless the caller names the CPU (``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu``; ``types/validation.entry_device``).
On the card it resolves the batch backend when it is built (the kernel's
known-answer self-check, once a process), so that ``ingest_active``'s
gate is open for the first gossiped tx; with the gate closed every
submission would take the per-tx path with no counter showing it.  A
flush whose signatures the kernel did not serve raises ``BackendError``
inside ``check_tx_batch``; ``_flush_chunk`` then logs "batched admission
failed" and re-admits the chunk tx by tx, as the JAX package does.

A flush records a ``txingest.flush`` span, a shed tx an ``ingest_shed``
anomaly and its synchronous check a ``txingest.shed_sync`` span
(``libs/tracing``), as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.txingest import stats

logger = logging.getLogger("cometbft_tpu_torch.txingest")

DEFAULT_BATCH = 256
DEFAULT_FLUSH_US = 5000.0
DEFAULT_QUEUE_CAP = 4096
DEFAULT_NONCE_LRU = 4096


class _NonceLRU:
    """Last-seen *verified* envelope nonce per sender pubkey, LRU-bounded.

    Only nonces whose signatures actually verified are recorded — a forged
    envelope carrying a huge nonce must not be able to poison a sender's
    record and censor their future traffic.  A replayed or re-signed
    envelope at or below the recorded nonce dies at ingest with the
    canonical ``CODE_STALE_NONCE`` before costing a queue slot, a
    signature check, or an app round trip.

    Locked: reactor threads consult it at submit while the ingest thread
    records at flush, and OrderedDict relinking is not thread-safe."""

    def __init__(self, cap: int):
        self.cap = max(1, cap)
        self._d: "OrderedDict[bytes, int]" = OrderedDict()
        self._lock = threading.Lock()

    def last(self, pub: bytes) -> Optional[int]:
        with self._lock:
            v = self._d.get(pub)
            if v is not None:
                self._d.move_to_end(pub)
            return v

    def note(self, pub: bytes, nonce: int) -> None:
        with self._lock:
            cur = self._d.get(pub)
            if cur is None or nonce > cur:
                self._d[pub] = nonce
            self._d.move_to_end(pub)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)


def ingest_enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_TXINGEST", "1") != "0"


def ingest_active() -> bool:
    """Kill switch on AND the accelerator batch backend trusted — the
    scheduler's own gate (never triggers the jax auto-probe from a
    gossip-path check)."""
    from cometbft_tpu_torch.verifysched import backend_trusted

    return ingest_enabled() and backend_trusted()


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


class IngestCoalescer:
    """Bounded ingest queue + deadline/size flusher over one mempool."""

    def __init__(
        self,
        mempool,
        batch_max: Optional[int] = None,
        flush_us: Optional[float] = None,
        queue_cap: Optional[int] = None,
        start_thread: bool = True,
        on_result: Optional[Callable[[str, object], None]] = None,
        device=None,
    ):
        from cometbft_tpu_torch.types.validation import entry_device

        self.device = entry_device(device)  # the gate open for the first tx
        self.mempool = mempool
        self.batch_max = max(
            1,
            batch_max
            if batch_max is not None
            else _env_int("COMETBFT_TPU_TXINGEST_BATCH", DEFAULT_BATCH),
        )
        self.flush_s = (
            max(
                0.0,
                flush_us
                if flush_us is not None
                else _env_float("COMETBFT_TPU_TXINGEST_FLUSH_US", DEFAULT_FLUSH_US),
            )
            / 1e6
        )
        self.queue_cap = max(
            1,
            queue_cap
            if queue_cap is not None
            else _env_int("COMETBFT_TPU_TXINGEST_QUEUE", DEFAULT_QUEUE_CAP),
        )
        # flush-time outcome callback: (sender, CheckTxResponse-or-
        # MempoolError) — the reactor uses it for per-peer accounting
        self.on_result = on_result
        self._nonces = _NonceLRU(
            _env_int("COMETBFT_TPU_TXINGEST_NONCES", DEFAULT_NONCE_LRU)
        )
        self._cond = threading.Condition()
        self._q: "deque[tuple[bytes, str, float]]" = deque()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._start_thread = start_thread

    # -- submission ---------------------------------------------------------

    def active(self) -> bool:
        return ingest_active()

    def pending(self) -> int:
        with self._cond:
            return len(self._q)

    def submit(self, tx: bytes, sender: str = ""):
        """Queue one gossiped tx for batched admission.

        Returns ``None`` when queued (verdict arrives at flush time via
        ``on_result``) or the ``CheckTxResponse`` when the tx took a
        synchronous path (pipeline inactive, or shed by the queue bound).
        Raises the same ``MempoolError`` family as ``check_tx`` for
        synchronous rejections — including ``TxInCacheError`` for the
        pre-queue cache dedup, which is the common gossip-duplicate case
        and costs neither a queue slot nor an app call."""
        from cometbft_tpu_torch.mempool.clist_mempool import TxInCacheError

        if not self.active():
            return self.mempool.check_tx(tx, sender=sender)
        # dedup BEFORE taking a queue slot, with the same recency refresh
        # cache.push gives duplicates on the per-tx path
        key = self.mempool.tx_key(tx)
        if self.mempool.cache.touch(key):
            self.mempool.note_duplicate(key, sender)
            stats.record_cache(True)
            stats.record_error("duplicate")
            raise TxInCacheError()
        stale, pn = self._check_nonce(tx)
        if stale is not None:
            return stale
        with self._cond:
            if not self._stopped and len(self._q) < self.queue_cap:
                # the key and decoded (pubkey, nonce) ride along so
                # flush-time admission neither hashes nor decodes the tx
                # a second time
                self._q.append((tx, sender, key, time.perf_counter(), pn))
                stats.record_enqueue()
                if self._start_thread and (
                    self._thread is None or not self._thread.is_alive()
                ):
                    self._thread = threading.Thread(
                        target=self._run, name="tx-ingest", daemon=True
                    )
                    self._thread.start()
                self._cond.notify_all()
                return None
        # queue full (or closing): shed to the per-tx synchronous path —
        # shedding costs the batching win, never a tx verdict
        stats.record_shed_sync()
        tracing.record_anomaly("ingest_shed", queue_cap=self.queue_cap)
        with tracing.span("txingest.shed_sync"):
            res = self.mempool.check_tx(tx, sender=sender)
        self._note_verified_nonce(pn, res)
        return res

    # -- per-sender nonce replay protection ---------------------------------

    def _check_nonce(self, tx: bytes):
        """Canonical ``CODE_STALE_NONCE`` rejection for a replayed or
        re-signed envelope at/below the sender's last verified nonce, as
        ``(rejection-or-None, (pubkey, nonce)-or-None)`` — the decoded pair
        rides the queue so flush never re-decodes.  Only meaningful behind
        an envelope-aware app (same gate as the batched sig precheck)."""
        if not getattr(self.mempool, "envelope_aware", False):
            return None, None
        from cometbft_tpu_torch.txingest import envelope as ev

        if not ev.is_envelope(tx):
            return None, None
        try:
            env = ev.decode(tx)
        except ev.EnvelopeError:
            return None, None  # malformed: the canonical 101 path downstream
        last = self._nonces.last(env.pubkey)
        if last is not None and env.nonce <= last:
            stats.record_reject(ev.CODE_STALE_NONCE)
            stats.record_error("stale_nonce")
            return ev.reject_stale_nonce(env.nonce, last), None
        return None, (env.pubkey, env.nonce)

    def _note_verified_nonce(self, pn, res) -> None:
        """Record a (pubkey, nonce) pair once its tx VERIFIED (res.ok)."""
        if pn is None:
            return
        from cometbft_tpu_torch.abci import types as at

        if isinstance(res, at.CheckTxResponse) and res.ok:
            self._nonces.note(*pn)

    # -- flushing -----------------------------------------------------------

    def flush_now(self) -> int:
        """Drain everything queued, in batch_max chunks.  Synchronous —
        the simulator's deterministic drive path, and the thread's flush
        body."""
        total = 0
        while True:
            with self._cond:
                if not self._q:
                    return total
                items = [
                    self._q.popleft()
                    for _ in range(min(self.batch_max, len(self._q)))
                ]
            self._flush_chunk(items)
            total += len(items)

    def _flush_chunk(self, items) -> None:
        txs = [it[0] for it in items]
        senders = [it[1] for it in items]
        keys = [it[2] for it in items]
        stats.record_flush(len(items), self.batch_max)
        try:
            with tracing.span(
                "txingest.flush", txs=len(items), cap=self.batch_max
            ):
                results = self.mempool.check_tx_batch(txs, senders, keys=keys)
        except Exception:  # noqa: BLE001 — the flusher must survive
            logger.exception(
                "batched admission failed; re-admitting %d txs per-tx",
                len(txs),
            )
            results = []
            for tx, sender in zip(txs, senders):
                try:
                    results.append(self.mempool.check_tx(tx, sender=sender))
                except Exception as e:  # noqa: BLE001 — MempoolError family
                    results.append(e)
        for it, res in zip(items, results):
            self._note_verified_nonce(it[4], res)
        if self.on_result is not None:
            for sender, res in zip(senders, results):
                try:
                    self.on_result(sender, res)
                except Exception:  # noqa: BLE001 — accounting only
                    pass

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and not self._q:
                    self._cond.wait()
                if self._stopped and not self._q:
                    return
                while not self._stopped and len(self._q) < self.batch_max:
                    oldest = self._q[0][3] if self._q else None
                    if oldest is None:
                        break
                    remain = oldest + self.flush_s - time.perf_counter()
                    if remain <= 0:
                        break
                    self._cond.wait(remain)
                if not self._q:
                    continue
            self.flush_now()

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop accepting queued work and drain what's left — a tx handed
        to the coalescer always reaches the mempool exactly once."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        self.flush_now()
