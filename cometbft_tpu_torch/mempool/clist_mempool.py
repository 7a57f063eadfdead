"""The mempool's error class and the no-op mempool (reference:
mempool/nop_mempool.go), the port of those two names of the JAX package's
``mempool/clist_mempool.py``.  ``NopMempool`` is what a block executor
drives when the app keeps its own transactions; ``CListMempool`` and its
lanes wait for ROADMAP "Node assembly" stage (b).
"""

from __future__ import annotations


class MempoolError(Exception):
    pass


class NopMempool:
    """Reference: mempool/nop_mempool.go — app manages txs itself."""

    def __init__(self):
        self._txs_available = None

    def check_tx(self, tx: bytes, sender: str = ""):
        raise MempoolError("tx rejected: nop mempool does not accept txs")

    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0

    def is_empty(self) -> bool:
        return True

    def contains(self, tx_key: bytes) -> bool:
        return False

    def get_tx_by_hash(self, tx_hash: bytes):
        return None

    def enable_txs_available(self) -> None:
        pass

    def txs_available(self):
        return None

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        return []

    def reap_max_txs(self, n: int) -> list[bytes]:
        return []

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def update(self, height, txs, tx_results) -> None:
        pass

    def flush(self) -> None:
        pass
