"""Indexer service: subscribes to the event bus and feeds the indexers.

Reference: state/txindex/indexer_service.go — one subscriber draining
NewBlockEvents + Tx events so tx_search/block_search stay current.

The port's copy of the JAX package's ``indexer/service.py``.
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs.pubsub import Query
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.types import events as tev

_SUBSCRIBER = "IndexerService"


class IndexerService(BaseService):
    """Reference: txindex/indexer_service.go IndexerService."""

    def __init__(self, tx_indexer, block_indexer, event_bus, logger=None):
        super().__init__("IndexerService")
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus
        self.logger = logger or liblog.nop_logger()
        self._thread = None
        self._tx_sub = None
        self._block_sub = None

    def on_start(self) -> None:
        # Unbounded queues (capacity 0), where the JAX package bounds them at
        # 1,000 txs and 100 blocks: the event bus cancels a subscription whose
        # queue is full, and a block of more than ~1,000 txs then ended tx
        # indexing for good.  The reference's indexer subscribes unbuffered
        # (state/txindex/indexer_service.go), so that no event is lost.
        self._tx_sub = self.event_bus.subscribe(
            _SUBSCRIBER,
            Query.parse(f"{tev.EVENT_TYPE_KEY}='{tev.EVENT_TX}'"),
            capacity=0,
        )
        self._block_sub = self.event_bus.subscribe(
            _SUBSCRIBER,
            Query.parse(f"{tev.EVENT_TYPE_KEY}='{tev.EVENT_NEW_BLOCK_EVENTS}'"),
            capacity=0,
        )
        self._thread = threading.Thread(
            target=self._run, name="indexer", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        try:
            self.event_bus.unsubscribe_all(_SUBSCRIBER)
        except Exception:  # noqa: BLE001
            pass

    def _run(self) -> None:
        while self.is_running:
            # drain BOTH queues completely each wakeup — blocking on one
            # starves the other and a full queue gets its subscription
            # canceled by the pubsub server
            drained = 0
            while True:
                msg = self._block_sub.next(timeout=0)
                if msg is None:
                    break
                drained += 1
                data: tev.EventDataNewBlockEvents = msg.data
                try:
                    self.block_indexer.index(data.height, data.events)
                except Exception as e:  # noqa: BLE001
                    self.logger.error("block index failed", err=repr(e))
            txs = []
            while True:
                tx_msg = self._tx_sub.next(timeout=0)
                if tx_msg is None:
                    break
                drained += 1
                txs.append(tx_msg.data)
            if txs:
                self._index_txs(txs)
            if not drained:
                time.sleep(0.02)

    def _index_txs(self, batch) -> None:
        """One drain's worth of txs: use the indexer's batch entry point
        when it has one (the psql sink commits once per batch, reference
        psql.go IndexTxEvents takes the whole block's txs) else per-tx.
        A failing batch falls back to per-tx indexing so one bad tx never
        discards the rest of the drain, and per-tx errors are isolated."""
        index_batch = getattr(self.tx_indexer, "index_batch", None)
        if index_batch is not None:
            try:
                index_batch(batch)
                return
            except Exception as e:  # noqa: BLE001
                self.logger.error(
                    "batch tx index failed; retrying per-tx", err=repr(e)
                )
        for d in batch:
            try:
                self.tx_indexer.index(d.height, d.index, d.tx, d.result)
            except Exception as e:  # noqa: BLE001
                self.logger.error("tx index failed", err=repr(e))
