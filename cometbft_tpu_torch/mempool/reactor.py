"""Mempool gossip reactor (reference: mempool/reactor.go).

Channel 0x30 (reference: mempool/mempool.go:14 MempoolChannel).  One
broadcast thread per peer walks the mempool's lanes and sends every tx the
peer hasn't already sent us (reference: reactor.go:213
broadcastTxRoutine's send-loop with the senders check).
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.mempool.clist_mempool import (
    MempoolError,
    MempoolFullError,
    PreCheckError,
    TxInCacheError,
    TxTooLargeError,
)
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor

MEMPOOL_CHANNEL = 0x30
_BROADCAST_SLEEP = 0.02
_BLOCKED_SLEEP = 0.005  # a full send queue: try the same tx again after this


class MempoolReactor(Reactor):
    """Reference: mempool/reactor.go Reactor.

    ``ingest`` (a ``txingest.IngestCoalescer``) routes incoming gossip
    through batched admission when active; without it — or with
    ``COMETBFT_TPU_TXINGEST=0`` — every tx takes the per-tx ``check_tx``
    path exactly as before.  Either way the reactor now counts (and logs,
    at debug) tx-cache dedup hits and CheckTx rejections per peer instead
    of silently swallowing them: ``peer_ingest_stats`` feeds sim
    assertions and the ``cometbft_mempool_*`` metrics."""

    def __init__(self, config, mempool, logger=None, ingest=None):
        super().__init__("MempoolReactor")
        self.config = config
        self.mempool = mempool
        self.logger = logger or liblog.nop_logger()
        self.ingest = ingest
        if ingest is not None and ingest.on_result is None:
            ingest.on_result = self._note_flush_result
        self._peer_routines: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._peer_stats: dict[str, dict[str, int]] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                MEMPOOL_CHANNEL,
                priority=5,
                send_queue_capacity=100,
                recv_message_capacity=self.config.max_tx_bytes + 64
                if hasattr(self.config, "max_tx_bytes")
                else 1024 * 1024,
            )
        ]

    def add_peer(self, peer) -> None:
        if not getattr(self.config, "broadcast", True):
            return
        stop = threading.Event()
        with self._lock:
            self._peer_routines[peer.id] = stop
        threading.Thread(
            target=self._broadcast_tx_routine,
            args=(peer, stop),
            name="mempool-broadcast",
            daemon=True,
        ).start()

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            stop = self._peer_routines.pop(peer.id, None)
        if stop is not None:
            stop.set()

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        """An incoming tx: CheckTx with the peer recorded as sender —
        batched through the ingest coalescer when active.  Dupes / full /
        failed pre-check stay non-fatal, but are now counted per peer."""
        try:
            if self.ingest is not None:
                res = self.ingest.submit(msg_bytes, sender=peer.id)
            else:
                res = self.mempool.check_tx(msg_bytes, sender=peer.id)
        except MempoolError as e:
            self._note_sync_error(peer.id, e)
            return
        if res is not None:  # None = queued; verdict arrives at flush time
            self._note_response(peer.id, res)

    # -- per-peer ingest accounting ---------------------------------------

    def peer_ingest_stats(self) -> "dict[str, dict[str, int]]":
        with self._lock:
            return {p: dict(s) for p, s in self._peer_stats.items()}

    def _bump(self, peer_id: str, kind: str) -> None:
        with self._lock:
            stats = self._peer_stats.setdefault(
                peer_id, {"accepted": 0, "dedup": 0, "rejected": 0, "error": 0}
            )
            stats[kind] += 1

    def _note_response(self, peer_id: str, res: at.CheckTxResponse) -> None:
        if res.ok:
            self._bump(peer_id, "accepted")
        else:
            self._bump(peer_id, "rejected")
            self.logger.debug(
                "tx rejected by CheckTx",
                peer=peer_id,
                code=res.code,
                codespace=res.codespace,
                log=res.log,
            )

    def _note_sync_error(self, peer_id: str, err: MempoolError) -> None:
        if isinstance(err, TxInCacheError):
            self._bump(peer_id, "dedup")
            self.logger.debug("tx dedup (cache hit)", peer=peer_id)
        else:
            self._bump(peer_id, "error")
            kind = {
                MempoolFullError: "mempool full",
                TxTooLargeError: "tx too large",
                PreCheckError: "pre-check failed",
            }.get(type(err), "mempool error")
            self.logger.debug("tx not admitted", peer=peer_id, reason=kind)

    def _note_flush_result(self, peer_id: str, res) -> None:
        """Flush-time outcome from the coalescer (response or the
        MempoolError the per-tx path would have raised)."""
        if isinstance(res, at.CheckTxResponse):
            self._note_response(peer_id, res)
        elif isinstance(res, MempoolError):
            self._note_sync_error(peer_id, res)

    def _broadcast_tx_routine(self, peer, stop: threading.Event) -> None:
        """Reference: reactor.go:213 broadcastTxRoutine — walk the lanes
        forever in ``_iter_lane_elems`` order (priority lanes round-robin,
        one tx a lane a turn), skipping txs the peer sent us.

        A cursor per lane keeps the walk's place, so each tx is looked at
        once, and a full send queue holds the walk at that tx until it has
        room, as the reference's blocking send does.  The JAX package
        rebuilds the whole snapshot of the lanes every pass (every 20 ms
        when idle) and retries a full queue tx by tx: for a pool that does
        not change it sends the same txs in the same order, at O(pool) a
        pass and peer, which takes the GIL from consensus on the node that
        holds the txs, even in a process of its own (ROADMAP §3)."""
        sent: set[bytes] = set()
        last: dict = {}  # lane -> the last element looked at
        while self.is_running and peer.is_running and not stop.is_set():
            advanced = blocked = False
            for lane in self.mempool.sorted_lanes:
                el = self._next_in_lane(lane, last)
                if el is None:
                    continue
                with self.mempool._mtx:
                    key, tx = el.value.key, el.value.tx
                    theirs = peer.id in el.value.senders
                if key not in sent and not theirs:
                    if not peer.try_send(MEMPOOL_CHANNEL, tx):
                        blocked = True
                        break
                    sent.add(key)
                last[lane] = el
                advanced = True
            # drop bookkeeping for txs no longer in the pool
            if len(sent) > 10000:
                with self.mempool._mtx:
                    sent &= {el.value.key for el in self.mempool._iter_lane_elems()}
            if blocked:
                time.sleep(_BLOCKED_SLEEP)
            elif not advanced:
                time.sleep(_BROADCAST_SLEEP)

    def _next_in_lane(self, lane, last: dict):
        """The live element of ``lane`` after the last one looked at (its
        front at the start), or None at the end.  A removed element keeps
        its next, so the walk goes on past removals; a removed tail never
        gets a next, so from one the walk starts again at the front (the
        sent set skips what went out)."""
        clist = self.mempool.lanes[lane]
        prev = last.get(lane)
        el = clist.front() if prev is None else prev.next()
        while el is None or el.removed:
            if el is None:
                return clist.front() if prev is not None and prev.removed else None
            prev, el = el, el.next()
        return el
