"""Process-wide counters for the verification scheduler; the port's copy
of the JAX package's ``verifysched/stats``.

Imports neither torch nor CUDA, like ``ops/dispatch_stats``: reading them
must never be the thing that initializes a device.
``verifysched/service.py`` writes them (and computes the padded lane count
at flush time, where ``ops.verify`` is already imported).

Counters (all guarded by one lock):
  * ``submitted[class]``     — items admitted to the queue, per priority class
  * ``submit_hits[class]``   — submissions resolved from the sigcache without
    ever occupying a queue slot
  * ``shed[class]``          — submissions rejected by admission control
    (never ``consensus``: that class is exempt from shedding by design)
  * ``queue_depth``          — items currently pending (gauge-style)
  * ``flushes[reason]``      — dispatcher flushes by trigger:
    ``deadline`` / ``full`` / ``shutdown``
  * ``flush_items``          — items drained across all flushes
  * ``flush_misses``         — unique items shipped to the verify seam
    (<= flush_items: duplicates and structural garbage resolve on the host)
  * ``flush_lanes``          — bucket-padded lanes those misses occupy on
    the plain version's ladder (occupancy = flush_misses / flush_lanes;
    the CUDA kernel itself takes a flush unpadded)
  * ``dedup_hits``           — duplicate in-flight triples collapsed into a
    single lane at flush time (concurrent gossip of the same vote)
  * ``verdicts[class]`` / ``latency_seconds[class]`` — resolved futures and
    cumulative submit->verdict latency, per priority class
  * ``inflight_depth`` / ``inflight_hwm`` — flushes dispatched and not yet
    fetched, and the high-water mark

Latency histograms:
  * ``latency_hist[class]``    — submit->verdict, per priority class
    (includes ``record_shed_fallback`` samples)
  * ``queue_wait_hist[class]`` — submit->drain wait, per class
  * ``device_hist[class]``     — drain->verdict (flush execution) share
  * ``flush_interval_hist``    — time between consecutive flush starts
  * ``shed_fallback[class]``   — sync fallbacks that recorded a sample
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.libs.histo import Histo

CLASS_NAMES = ("consensus", "evidence_light", "bulk")
FLUSH_REASONS = ("deadline", "full", "shutdown")

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "submitted": {c: 0 for c in CLASS_NAMES},
        "submit_hits": {c: 0 for c in CLASS_NAMES},
        "shed": {c: 0 for c in CLASS_NAMES},
        "queue_depth": 0,
        "flushes": {r: 0 for r in FLUSH_REASONS},
        "flush_items": 0,
        "flush_misses": 0,
        "flush_lanes": 0,
        "dedup_hits": 0,
        "verdicts": {c: 0 for c in CLASS_NAMES},
        "latency_seconds": {c: 0.0 for c in CLASS_NAMES},
        "queue_wait_seconds": {c: 0.0 for c in CLASS_NAMES},
        "shed_fallback": {c: 0 for c in CLASS_NAMES},
        "latency_hist": {c: Histo() for c in CLASS_NAMES},
        "queue_wait_hist": {c: Histo() for c in CLASS_NAMES},
        "device_hist": {c: Histo() for c in CLASS_NAMES},
        "flush_interval_hist": Histo(),
        "inflight_depth": 0,
        "inflight_hwm": 0,
    }


_STATS = _zero()


def _cls(priority: int) -> str:
    return CLASS_NAMES[min(max(int(priority), 0), len(CLASS_NAMES) - 1)]


def record_submit(priority: int) -> None:
    with _LOCK:
        _STATS["submitted"][_cls(priority)] += 1
        _STATS["queue_depth"] += 1


def record_submit_hit(priority: int) -> None:
    with _LOCK:
        _STATS["submit_hits"][_cls(priority)] += 1


def record_shed(priority: int) -> None:
    with _LOCK:
        _STATS["shed"][_cls(priority)] += 1


def record_flush(
    reason: str,
    items: int,
    misses: int,
    lanes: int,
    interval_s: "float | None" = None,
) -> None:
    with _LOCK:
        _STATS["flushes"][reason] = _STATS["flushes"].get(reason, 0) + 1
        _STATS["flush_items"] += int(items)
        _STATS["flush_misses"] += int(misses)
        _STATS["flush_lanes"] += int(lanes)
        _STATS["queue_depth"] = max(0, _STATS["queue_depth"] - int(items))
        if interval_s is not None:
            _STATS["flush_interval_hist"].observe(float(interval_s))


def record_inflight(depth: int) -> None:
    """Current number of dispatched-but-unfetched flushes — written by the
    dispatcher at dispatch and by the completion thread at fetch."""
    with _LOCK:
        _STATS["inflight_depth"] = int(depth)
        if depth > _STATS["inflight_hwm"]:
            _STATS["inflight_hwm"] = int(depth)


def record_dedup(n: int) -> None:
    if n:
        with _LOCK:
            _STATS["dedup_hits"] += int(n)


def record_verdict(
    priority: int,
    latency_s: float,
    queue_wait_s: "float | None" = None,
    device_s: "float | None" = None,
) -> None:
    """One resolved future.  ``queue_wait_s`` (submit->drain) and
    ``device_s`` (drain->verdict) are recorded as SEPARATE distributions
    when the dispatcher knows them — a latency regression then names the
    guilty half instead of hiding in the conflated total."""
    with _LOCK:
        c = _cls(priority)
        _STATS["verdicts"][c] += 1
        _STATS["latency_seconds"][c] += float(latency_s)
        _STATS["latency_hist"][c].observe(float(latency_s))
        if queue_wait_s is not None:
            _STATS["queue_wait_seconds"][c] += float(queue_wait_s)
            _STATS["queue_wait_hist"][c].observe(float(queue_wait_s))
        if device_s is not None:
            _STATS["device_hist"][c].observe(float(device_s))


def record_shed_fallback(priority: int, latency_s: float) -> None:
    """A shed (or scheduler-inactive-mid-teardown) caller finished its
    synchronous fallback verify: the sample lands in the SAME
    submit->verdict latency record as scheduled work, so shedding can
    never silently improve the histogram it degraded."""
    with _LOCK:
        c = _cls(priority)
        _STATS["shed_fallback"][c] += 1
        _STATS["latency_seconds"][c] += float(latency_s)
        _STATS["latency_hist"][c].observe(float(latency_s))


def _copy(v):
    if isinstance(v, Histo):
        return v.to_dict()
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v


def snapshot() -> dict:
    """Deep-enough copy for metrics/tests; adds derived aggregates.
    Histograms render as their ``Histo.to_dict`` wire shape."""
    with _LOCK:
        out = {k: _copy(v) for k, v in _STATS.items()}
    out["flush_occupancy"] = (
        out["flush_misses"] / out["flush_lanes"] if out["flush_lanes"] else 0.0
    )
    out["verdicts_total"] = sum(out["verdicts"].values())
    out["latency_seconds_total"] = sum(out["latency_seconds"].values())
    out["shed_total"] = sum(out["shed"].values())
    out["shed_fallback_total"] = sum(out["shed_fallback"].values())
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
