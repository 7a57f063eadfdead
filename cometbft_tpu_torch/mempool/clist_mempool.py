"""CList mempool with lanes (reference: mempool/clist_mempool.go).

Transactions are validated through the app's mempool connection (CheckTx),
cached in an LRU to dedupe gossip, and stored in per-lane concurrent lists —
lanes are priority classes the app declares in its ``Info`` response
(reference: mempool/lanes.go, ``lane_priorities``/``default_lane``).  Reaping
visits lanes in priority order round-robin (high first); after a block commits,
``update`` removes committed txs and rechecks the remainder.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.libs import sync as libsync
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.config.config import MempoolConfig
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs.clist import CElement, CList
from cometbft_tpu_torch.txingest import stats as ingest_stats


class MempoolError(Exception):
    pass


class TxInCacheError(MempoolError):
    pass


class MempoolFullError(MempoolError):
    def __init__(self, n_txs: int, total_bytes: int):
        super().__init__(f"mempool full: {n_txs} txs, {total_bytes} bytes")


class TxTooLargeError(MempoolError):
    pass


class PreCheckError(MempoolError):
    pass


@dataclass
class MempoolTx:
    """Reference: clist_mempool.go mempoolTx."""

    tx: bytes
    height: int  # height at which validated
    gas_wanted: int = 0
    lane: str = ""
    senders: set[str] = field(default_factory=set)

    @property
    def key(self) -> bytes:
        return tmhash.sum256(self.tx)


class LRUTxCache:
    """Reference: mempool/cache.go LRUTxCache."""

    def __init__(self, size: int):
        self.size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._mtx = threading.Lock()

    def push(self, key: bytes) -> bool:
        """Returns False if already present (and refreshes recency)."""
        with self._mtx:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            if len(self._map) >= self.size > 0:
                self._map.popitem(last=False)
            self._map[key] = None
            return True

    def remove(self, key: bytes) -> None:
        with self._mtx:
            self._map.pop(key, None)

    def has(self, key: bytes) -> bool:
        with self._mtx:
            return key in self._map

    def touch(self, key: bytes) -> bool:
        """True if present, refreshing recency — the dedup probe the
        ingest coalescer runs before taking a queue slot, with the same
        LRU effect a duplicate gets from ``push`` on the per-tx path."""
        with self._mtx:
            if key in self._map:
                self._map.move_to_end(key)
                return True
            return False

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()


class NopTxCache:
    def push(self, key: bytes) -> bool:
        return True

    def remove(self, key: bytes) -> None:
        pass

    def has(self, key: bytes) -> bool:
        return False

    def touch(self, key: bytes) -> bool:
        return False

    def reset(self) -> None:
        pass


DEFAULT_LANE = "default"


class CListMempool:
    """Reference: mempool/clist_mempool.go CListMempool.

    ``proxy_app`` is the mempool ABCI connection.  ``lane_info`` comes from
    the app's Info response; when absent a single default lane is used.
    """

    def __init__(
        self,
        config: MempoolConfig,
        proxy_app,
        height: int = 0,
        lane_priorities: Optional[dict[str, int]] = None,
        default_lane: str = "",
        pre_check: Optional[Callable[[bytes], Optional[str]]] = None,
        envelope_aware: bool = False,
    ):
        self.config = config
        self.proxy_app = proxy_app
        self.height = height
        self.pre_check = pre_check
        # True when the app advertises InfoResponse.envelope_sig_verified:
        # batched admission may then pre-verify signed-tx envelopes on the
        # crypto seam and reject forgeries with the app's own canonical
        # codes before any app round trip (docs/tx-ingest.md)
        self.envelope_aware = envelope_aware
        self.cache = (
            LRUTxCache(config.cache_size) if config.cache_size > 0 else NopTxCache()
        )
        if not lane_priorities:
            lane_priorities = {DEFAULT_LANE: 1}
            default_lane = DEFAULT_LANE
        if default_lane not in lane_priorities:
            raise MempoolError(f"default lane {default_lane!r} not in priorities")
        self.default_lane = default_lane
        # high priority first
        self.sorted_lanes = sorted(
            lane_priorities, key=lambda l: (-lane_priorities[l], l)
        )
        self.lanes: dict[str, CList] = {l: CList() for l in lane_priorities}
        self._tx_map: dict[bytes, CElement] = {}
        self._mtx = libsync.rlock("mempool")  # held across Update (reference Lock())
        self._total_bytes = 0
        self._notified_available = False
        self._txs_available: Optional[threading.Event] = None
        self._recheck_cursor: Optional[int] = None

    # -- introspection ----------------------------------------------------

    def size(self) -> int:
        return len(self._tx_map)

    def size_bytes(self) -> int:
        return self._total_bytes

    def is_empty(self) -> bool:
        return not self._tx_map

    def contains(self, tx_key: bytes) -> bool:
        return tx_key in self._tx_map

    def get_tx_by_hash(self, tx_hash: bytes):
        """The queued tx bytes with this hash, or None (reference:
        mempool/clist_mempool.go GetTxByHash via the unconfirmed_tx RPC,
        rpc/core/mempool.go:189-197)."""
        el = self._tx_map.get(tx_hash)
        return el.value.tx if el is not None else None

    def enable_txs_available(self) -> None:
        self._txs_available = threading.Event()

    def txs_available(self) -> Optional[threading.Event]:
        return self._txs_available

    def flush(self) -> None:
        """Remove everything (reference: Flush)."""
        with self._mtx:
            for lane in self.lanes.values():
                el = lane.front()
                while el is not None:
                    lane.remove(el)
                    el = el.next()
            self._tx_map.clear()
            self.cache.reset()
            self._total_bytes = 0

    # -- CheckTx ingress --------------------------------------------------

    @staticmethod
    def tx_key(tx: bytes) -> bytes:
        return tmhash.sum256(tx)

    def note_duplicate(self, key: bytes, sender: str) -> None:
        """Record a gossip duplicate's sender so we don't gossip back
        (reference :365) — shared by the per-tx path, batched admission
        and the coalescer's pre-queue dedup."""
        el = self._tx_map.get(key)
        if el is not None and sender:
            el.value.senders.add(sender)

    def check_tx(self, tx: bytes, sender: str = "") -> at.CheckTxResponse:
        """Validate and maybe add a tx (reference: clist_mempool.go:333).

        Synchronous here — the async pipelining of the reference's socket
        client is handled inside the ABCI client; mempool semantics (cache,
        duplicate-sender tracking, full checks) are identical.
        """
        if len(tx) > self.config.max_tx_bytes:
            ingest_stats.record_error("too_large")
            raise TxTooLargeError(
                f"tx {len(tx)}B > max {self.config.max_tx_bytes}B"
            )
        if self.pre_check is not None:
            err = self.pre_check(tx)
            if err:
                ingest_stats.record_error("pre_check")
                raise PreCheckError(err)

        key = tmhash.sum256(tx)
        # Under the lock that ``update`` runs under (the reference's
        # updateMtx, which CheckTx read-locks): a block committed between
        # the cache probe and the add would otherwise leave its tx in the
        # mempool, and a later block would carry it again.
        with self._mtx:
            if not self.cache.push(key):
                self.note_duplicate(key, sender)
                ingest_stats.record_cache(True)
                ingest_stats.record_error("duplicate")
                raise TxInCacheError()
            ingest_stats.record_cache(False)

            if (
                self.size() + 1 > self.config.size
                or self._total_bytes + len(tx) > self.config.max_txs_bytes
            ):
                self.cache.remove(key)
                ingest_stats.record_error("full")
                raise MempoolFullError(self.size(), self._total_bytes)

            res = self.proxy_app.check_tx(at.CheckTxRequest(tx=tx))
            self._handle_check_tx_response(tx, key, sender, res)
            return res

    def check_tx_batch(
        self,
        txs: Sequence[bytes],
        senders: Optional[Sequence[str]] = None,
        keys: Optional[Sequence[bytes]] = None,
    ) -> list:
        """Batched admission (docs/tx-ingest.md): run the per-tx gauntlet
        (size, pre-check, cache dedup) in request order, pre-verify
        signed-tx envelopes on the crypto seam when the app is
        envelope-aware (forgeries rejected with the app's canonical codes,
        no app round trip), then admit every survivor through ONE batched
        ``check_txs`` call.  Returns one entry per tx: the
        ``CheckTxResponse``, or the ``MempoolError`` instance the per-tx
        path would have raised.  Final mempool contents, tx order, codes
        and cache state are identical to sequential ``check_tx`` calls —
        tests/test_txingest.py pins this differentially.

        ``keys`` optionally carries precomputed ``tx_key`` hashes (the
        coalescer already hashed every tx for its pre-queue dedup probe)
        so the hot gossip path hashes each tx once, not twice."""
        n = len(txs)
        senders = list(senders) if senders is not None else [""] * n
        if len(senders) != n:
            raise ValueError(
                f"check_tx_batch: {len(senders)} senders for {n} txs"
            )
        if keys is not None and len(keys) != n:
            raise ValueError(
                f"check_tx_batch: {len(keys)} keys for {n} txs"
            )
        with self._mtx:  # against update, as in check_tx
            return self._check_tx_batch(txs, senders, keys)

    def _check_tx_batch(self, txs, senders, pre_keys) -> list:
        from cometbft_tpu_torch.txingest import envelope as ev

        n = len(txs)
        results: list = [None] * n
        keys: "list[Optional[bytes]]" = [None] * n
        live: "list[int]" = []
        for i, (tx, sender) in enumerate(zip(txs, senders)):
            if len(tx) > self.config.max_tx_bytes:
                ingest_stats.record_error("too_large")
                results[i] = TxTooLargeError(
                    f"tx {len(tx)}B > max {self.config.max_tx_bytes}B"
                )
                continue
            if self.pre_check is not None:
                err = self.pre_check(tx)
                if err:
                    ingest_stats.record_error("pre_check")
                    results[i] = PreCheckError(err)
                    continue
            key = pre_keys[i] if pre_keys is not None else tmhash.sum256(tx)
            if not self.cache.push(key):
                # also dedups duplicates WITHIN the batch: the first
                # occurrence owns the cache slot, later ones land here
                # (the apply loop re-probes — see below — in case the
                # first occurrence is rejected and releases the slot)
                self.note_duplicate(key, sender)
                ingest_stats.record_cache(True)
                ingest_stats.record_error("duplicate")
                keys[i] = key
                results[i] = TxInCacheError()
                continue
            ingest_stats.record_cache(False)
            keys[i] = key
            live.append(i)

        if self.envelope_aware and live:
            # one bulk-class pass through the verify seam for the whole
            # burst; a shed inside verify_envelopes degrades to per-item
            # sync host verify — never a dropped tx verdict
            envs: "list" = [None] * n
            for i in live:
                if ev.is_envelope(txs[i]):
                    try:
                        envs[i] = ev.decode(txs[i])
                    except ev.EnvelopeError as e:
                        results[i] = ev.reject_bad_envelope(str(e))
            verdicts = ev.verify_envelopes(envs)
            n_sigs = sum(1 for e in envs if e is not None)
            ingest_stats.record_sig_precheck(n_sigs)
            for i in live:
                if envs[i] is not None and not verdicts[i]:
                    results[i] = ev.reject_bad_signature()
            live = [i for i in live if results[i] is None]

        if live:
            reqs = [at.CheckTxRequest(tx=txs[i]) for i in live]
            resps = self._app_check_txs(reqs)
            ingest_stats.record_app_batch(len(reqs))
            for i, res in zip(live, resps):
                results[i] = res

        # apply in request order: the full check and the add/cache
        # bookkeeping see exactly the mempool state sequential per-tx
        # admission would have seen
        for i in range(n):
            res = results[i]
            if isinstance(res, TxInCacheError):
                # the dedup probe ran before any verdict existed; if the
                # occurrence that owned the cache slot was since rejected
                # (rejection releases the slot unless
                # keep_invalid_txs_in_cache), sequential admission would
                # have re-checked this tx — do that now, per-tx
                if not self.cache.push(keys[i]):
                    continue  # genuine duplicate, error stands
                res = self.proxy_app.check_tx(at.CheckTxRequest(tx=txs[i]))
                results[i] = res
            if not isinstance(res, at.CheckTxResponse):
                continue  # admission error; cache handled above
            if (
                self.size() + 1 > self.config.size
                or self._total_bytes + len(txs[i]) > self.config.max_txs_bytes
            ):
                self.cache.remove(keys[i])
                ingest_stats.record_error("full")
                results[i] = MempoolFullError(self.size(), self._total_bytes)
                continue
            self._handle_check_tx_response(txs[i], keys[i], senders[i], res)
        return results

    def _app_check_txs(
        self, reqs: "list[at.CheckTxRequest]"
    ) -> "list[at.CheckTxResponse]":
        """One batched round trip when the proxy supports it (all
        ``abci.client.Client``s do), else the per-tx loop."""
        ck = getattr(self.proxy_app, "check_txs", None)
        if ck is None:
            return [self.proxy_app.check_tx(r) for r in reqs]
        return ck(reqs)

    def _handle_check_tx_response(
        self, tx: bytes, key: bytes, sender: str, res: at.CheckTxResponse
    ) -> None:
        """Reference: clist_mempool.go:393 handleCheckTxResponse."""
        if not res.ok:
            ingest_stats.record_reject(res.code)
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            return
        with self._mtx:
            if key in self._tx_map:
                return
            lane = res.lane_id or self.default_lane
            if lane not in self.lanes:
                lane = self.default_lane
            mtx = MempoolTx(
                tx=tx, height=self.height, gas_wanted=res.gas_wanted, lane=lane
            )
            if sender:
                mtx.senders.add(sender)
            el = self.lanes[lane].push_back(mtx)
            self._tx_map[key] = el
            self._total_bytes += len(tx)
        ingest_stats.record_admitted()
        self._notify_txs_available()

    def _notify_txs_available(self) -> None:
        if self._txs_available is not None and not self._notified_available:
            self._notified_available = True
            self._txs_available.set()

    # -- iteration / reaping ----------------------------------------------

    def _iter_lane_elems(self):
        """Round-robin lanes in priority order, one tx per lane per pass
        (reference: mempool/iterators.go BlockingIterator ordering)."""
        cursors = {l: self.lanes[l].front() for l in self.sorted_lanes}
        while True:
            progressed = False
            for lane in self.sorted_lanes:
                el = cursors[lane]
                while el is not None and el.removed:
                    el = el.next()
                if el is not None:
                    cursors[lane] = el.next()
                    progressed = True
                    yield el
            if not progressed:
                return

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        """Reference: clist_mempool.go:676 ReapMaxBytesMaxGas."""
        with self._mtx:
            txs: list[bytes] = []
            total_bytes = 0
            total_gas = 0
            for el in self._iter_lane_elems():
                mtx: MempoolTx = el.value
                new_bytes = total_bytes + len(mtx.tx)
                if max_bytes > -1 and new_bytes > max_bytes:
                    break
                new_gas = total_gas + mtx.gas_wanted
                if max_gas > -1 and new_gas > max_gas:
                    break
                total_bytes, total_gas = new_bytes, new_gas
                txs.append(mtx.tx)
            return txs

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx:
            out = []
            for el in self._iter_lane_elems():
                if n > -1 and len(out) >= n:
                    break
                out.append(el.value.tx)
            return out

    # -- post-commit update -----------------------------------------------

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def update(
        self,
        height: int,
        txs: Sequence[bytes],
        tx_results: Sequence[at.ExecTxResult],
    ) -> None:
        """Remove committed txs; recheck the rest (reference: :753 Update).
        Caller must hold the lock (consensus does, via blockExec.Commit)."""
        self.height = height
        self._notified_available = False
        if self._txs_available is not None:
            self._txs_available.clear()

        for tx, res in zip(txs, tx_results):
            key = tmhash.sum256(tx)
            if res.ok:
                self.cache.push(key)  # committed: keep in cache forever-ish
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            el = self._tx_map.pop(key, None)
            if el is not None:
                self.lanes[el.value.lane].remove(el)
                self._total_bytes -= len(tx)

        if self._tx_map and self.config.recheck:
            self._recheck_txs()
        if self._tx_map:
            self._notify_txs_available()

    def _recheck_txs(self) -> None:
        """Re-run CheckTx on all remaining txs (reference: :828 recheckTxs).

        With tx ingestion enabled the whole remaining mempool rides ONE
        batched ``check_txs`` round trip — and, behind an envelope-aware
        app, one fused signature pass (all cache hits in the common case)
        — instead of the serial per-tx loop.  ``COMETBFT_TPU_TXINGEST=0``
        restores the loop; verdicts are identical either way because the
        batch is semantically a sequence of independent checks."""
        from cometbft_tpu_torch.txingest.coalescer import ingest_enabled

        items = list(self._tx_map.items())
        reqs = [
            at.CheckTxRequest(tx=el.value.tx, type_=at.CHECK_TX_TYPE_RECHECK)
            for _, el in items
        ]
        if ingest_enabled() and len(items) > 1:
            resps = self._app_check_txs(reqs)
            ingest_stats.record_app_batch(len(reqs))
            ingest_stats.record_recheck(len(reqs))
        else:
            resps = [self.proxy_app.check_tx(r) for r in reqs]
        for (key, el), res in zip(items, resps):
            mtx: MempoolTx = el.value
            if not res.ok:
                ingest_stats.record_reject(res.code)
                self._tx_map.pop(key, None)
                self.lanes[mtx.lane].remove(el)
                self._total_bytes -= len(mtx.tx)
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(key)


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
