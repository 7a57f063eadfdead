"""Background pruner service (reference: state/pruner.go).

Runs pruning OFF the commit path on its own thread, honoring every retain
height the data-companion API can set (rpc gRPC PruningService) plus the
application's Commit retain height:

  * blocks + historical states: min(app_retain, companion_retain), each
    only when set (>0) — both consumers must be done with a block before
    it is dropped (reference: state/pruner.go pruneBlocksToRetainHeight);
  * finalize-block responses: companion_results_retain, always keeping the
    latest response for crash recovery (reference: pruning.proto comment
    on SetBlockResultsRetainHeight);
  * tx / block indexer entries: tx_index_retain / block_index_retain
    (reference: state/pruner.go pruneIndexesToRetainHeight).

The executor's inline pruning is gone; it only records the app's retain
height and this service acts on it.

The port's copy of the JAX package's ``state/pruner.py``: it deletes
the same keys for the same retain heights.
"""

from __future__ import annotations

import threading
from typing import Optional

from cometbft_tpu_torch.libs import log as liblog


class Pruner:
    """Periodic pruning worker over the node's stores."""

    def __init__(
        self,
        retain,  # state.execution._PrunerHeights (shared, written by gRPC)
        block_store,
        state_store,
        tx_indexer=None,
        block_indexer=None,
        interval_s: float = 10.0,
        logger=None,
    ):
        self._retain = retain
        self._block_store = block_store
        self._state_store = state_store
        self._tx_indexer = tx_indexer
        self._block_indexer = block_indexer
        self._interval = interval_s
        self.logger = logger or liblog.nop_logger()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # progress watermarks (avoid rescanning already-pruned ranges)
        self._results_pruned_to = 0
        self._tx_index_pruned_to = 0
        self._block_index_pruned_to = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pruner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.prune_once()
            except Exception as e:  # noqa: BLE001 — keep the service alive
                self.logger.error("pruner pass failed", err=str(e))

    # -- one pass ------------------------------------------------------------

    def _block_retain(self) -> int:
        app = self._retain.app_retain
        comp = self._retain.companion_retain
        if app > 0 and comp > 0:
            return min(app, comp)
        return app or comp

    def prune_once(self) -> dict:
        """Prune all stores to their retain heights; returns per-kind counts
        (exposed for tests and the debug dump).  Each section is isolated:
        a failure in one must not wedge the others."""
        out = {"blocks": 0, "states": 0, "results": 0, "tx_index": 0, "block_index": 0}

        def guard(name, fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                self.logger.error("prune section failed", kind=name, err=str(e))

        def do_blocks():
            # clamp: an out-of-range companion height must not wedge the
            # pruner (prune_blocks raises beyond height+1)
            retain = min(self._block_retain(), self._block_store.height())
            base = self._block_store.base()
            if retain > base:
                out["blocks"] = self._block_store.prune_blocks(retain)
                # When the data companion governs results retention, block
                # pruning keeps the finalize responses — only vals/params
                # go (reference: PruneStates vs PruneABCIResponses split).
                out["states"] = self._state_store.prune_states(
                    base,
                    retain,
                    include_responses=(
                        self._retain.companion_results_retain == 0
                    ),
                )

        def do_results():
            rres = self._retain.companion_results_retain
            if rres <= 0:
                return
            # keep the latest response for crash recovery
            to = min(rres, self._block_store.height())
            frm = max(self._results_pruned_to, 1)
            n = 0
            for h in range(frm, to):
                if self._state_store.delete_finalize_block_response(h):
                    n += 1
            self._results_pruned_to = max(self._results_pruned_to, to)
            out["results"] = n

        def do_tx_index():
            retain = self._retain.tx_index_retain
            if self._tx_indexer is None or retain <= self._tx_index_pruned_to:
                return
            out["tx_index"] = self._tx_indexer.prune(retain)
            self._tx_index_pruned_to = retain

        def do_block_index():
            retain = self._retain.block_index_retain
            if (
                self._block_indexer is None
                or retain <= self._block_index_pruned_to
            ):
                return
            out["block_index"] = self._block_indexer.prune(retain)
            self._block_index_pruned_to = retain

        guard("blocks", do_blocks)
        guard("results", do_results)
        guard("tx_index", do_tx_index)
        guard("block_index", do_block_index)
        if any(out.values()):
            self.logger.debug("pruned", **out)
        return out
