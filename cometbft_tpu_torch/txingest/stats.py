"""Process-wide counters for the tx-ingestion pipeline.

Deliberately free of jax imports, exactly like ``verifysched/stats`` and
``ops/dispatch_stats``: ``libs/metrics.NodeMetrics`` reads these through
callback gauges as ``cometbft_mempool_*`` and a /metrics scrape must
never be the thing that initializes an accelerator backend.  The mempool
(cache dedup, rejections), the ingest coalescer (queue/flush/shed) and
the reactor (per-peer accounting) write them.

Counters (one lock):
  * ``cache_hits`` / ``cache_misses`` — tx LRU cache outcomes at admission
    (a hit is a gossip duplicate that cost no queue slot or app call)
  * ``queue_depth``        — txs waiting in the ingest queue (gauge-style)
  * ``enqueued``           — txs admitted to the ingest queue
  * ``shed_to_sync``       — txs that found the queue full and degraded to
    the per-tx synchronous CheckTx path (a shed costs the batching win,
    never a tx verdict)
  * ``flushes`` / ``flush_txs`` — ingest batches and the txs they carried;
    occupancy = flush_txs / (flushes * batch capacity)
  * ``flush_cap_total``    — summed batch capacity across flushes
  * ``app_batches`` / ``app_batch_txs`` — batched CheckTx round trips
    (admission + recheck) and the requests they carried
  * ``sig_prechecked``     — envelope signatures verified node-side before
    any app round trip
  * ``admitted``           — txs that entered the mempool
  * ``rejected[code]``     — CheckTx rejections by code (app codes plus the
    canonical txingest envelope codes)
  * ``errors[kind]``       — admission errors by kind: ``duplicate`` /
    ``full`` / ``too_large`` / ``pre_check``
  * ``recheck_batches`` / ``recheck_txs`` — post-commit rechecks that rode
    one batched round trip, and the txs re-checked
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "cache_hits": 0,
        "cache_misses": 0,
        "queue_depth": 0,
        "enqueued": 0,
        "shed_to_sync": 0,
        "flushes": 0,
        "flush_txs": 0,
        "flush_cap_total": 0,
        "app_batches": 0,
        "app_batch_txs": 0,
        "sig_prechecked": 0,
        "admitted": 0,
        "rejected": {},
        "errors": {},
        "recheck_batches": 0,
        "recheck_txs": 0,
    }


_STATS = _zero()


def record_cache(hit: bool) -> None:
    with _LOCK:
        _STATS["cache_hits" if hit else "cache_misses"] += 1


def record_enqueue(n: int = 1) -> None:
    with _LOCK:
        _STATS["enqueued"] += n
        _STATS["queue_depth"] += n


def record_shed_sync(n: int = 1) -> None:
    with _LOCK:
        _STATS["shed_to_sync"] += n


def record_flush(txs: int, cap: int) -> None:
    with _LOCK:
        _STATS["flushes"] += 1
        _STATS["flush_txs"] += int(txs)
        _STATS["flush_cap_total"] += int(cap)
        _STATS["queue_depth"] = max(0, _STATS["queue_depth"] - int(txs))


def record_app_batch(txs: int) -> None:
    with _LOCK:
        _STATS["app_batches"] += 1
        _STATS["app_batch_txs"] += int(txs)


def record_sig_precheck(n: int) -> None:
    if n:
        with _LOCK:
            _STATS["sig_prechecked"] += int(n)


def record_admitted(n: int = 1) -> None:
    with _LOCK:
        _STATS["admitted"] += n


def record_reject(code: int) -> None:
    with _LOCK:
        key = str(int(code))
        _STATS["rejected"][key] = _STATS["rejected"].get(key, 0) + 1


def record_error(kind: str) -> None:
    with _LOCK:
        _STATS["errors"][kind] = _STATS["errors"].get(kind, 0) + 1


def record_recheck(txs: int) -> None:
    with _LOCK:
        _STATS["recheck_batches"] += 1
        _STATS["recheck_txs"] += int(txs)


def queue_depth() -> int:
    with _LOCK:
        return _STATS["queue_depth"]


def snapshot() -> dict:
    """Deep-enough copy for metrics/tests; adds derived aggregates."""
    with _LOCK:
        out = {
            k: (dict(v) if isinstance(v, dict) else v)
            for k, v in _STATS.items()
        }
    total = out["cache_hits"] + out["cache_misses"]
    out["cache_hit_rate"] = out["cache_hits"] / total if total else 0.0
    out["batch_occupancy"] = (
        out["flush_txs"] / out["flush_cap_total"]
        if out["flush_cap_total"]
        else 0.0
    )
    out["rejected_total"] = sum(out["rejected"].values())
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
