"""Process-wide counters of the hashing plane and the proof server.

The port's copy of ``cometbft_tpu/proofserve/stats.py``: the same
counters and the same snapshot keys.  Free of torch, as
``ops/dispatch_stats`` is: reading a counter never initializes a device.
``ops/sha256_tree.py`` writes the tree-pass counters (it knows the padded
lane count of a pass); ``proofserve/service.py`` writes the proof-query
counters.

Counters (all guarded by one lock):

  * ``queries[kind]``      proof queries admitted (``tx`` / ``header`` /
    ``valset``), cache-hit submissions included;
  * ``cache_hits[kind]``   queries answered from the LRU cache without a
    queue slot;
  * ``cache_misses``       coalesced groups that had to build an entry
    (hit rate = hits / (hits + misses));
  * ``shed[kind]``         submissions refused by admission control; the
    caller's serial build answers them (``serial_fallbacks``);
  * ``serial_fallbacks``   ``prove_tx`` calls answered by the serial host
    build after a shed, a timeout or a stopped server;
  * ``queue_depth``        queries pending now (a gauge);
  * ``flushes[reason]``    dispatcher flushes by trigger: ``deadline`` /
    ``full`` / ``shutdown``;
  * ``flush_queries`` / ``flush_groups``  queries drained by all flushes
    and the (kind, height) groups they coalesced into;
  * ``tree_builds[kind]``  builds of a root or proof set (one per
    coalesced group that missed the cache);
  * ``trees_device`` / ``trees_host``  tree passes by path;
  * ``tree_leaves`` / ``tree_lanes``  leaves hashed on the device path and
    the bucket lanes they would occupy (lanes_occupancy = leaves / lanes);
  * ``device_fallbacks``   device tree passes answered by the host after
    the device tier failed.  The JAX package recomputes every failed tree
    pass on the host; the port does so only on the CPU, where the kernel's
    plain version is the device tier.  On a card a failed pass raises
    ``BackendError`` and nothing answers in its place, so this counter
    stays 0 there;
  * ``oversize_host``      trees sent to the host because they exceed the
    bucket ladder (a leaf too long, too many leaves or bytes).
"""

from __future__ import annotations

import threading

KINDS = ("tx", "header", "valset")
FLUSH_REASONS = ("deadline", "full", "shutdown")

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "queries": {k: 0 for k in KINDS},
        "cache_hits": {k: 0 for k in KINDS},
        "cache_misses": 0,
        "shed": {k: 0 for k in KINDS},
        "serial_fallbacks": 0,
        "queue_depth": 0,
        "flushes": {r: 0 for r in FLUSH_REASONS},
        "flush_queries": 0,
        "flush_groups": 0,
        "tree_builds": {k: 0 for k in KINDS},
        "trees_device": 0,
        "trees_host": 0,
        "tree_leaves": 0,
        "tree_lanes": 0,
        "device_fallbacks": 0,
        "oversize_host": 0,
    }


_STATS = _zero()


def _kind(kind: str) -> str:
    return kind if kind in KINDS else KINDS[0]


def record_query(kind: str) -> None:
    with _LOCK:
        _STATS["queries"][_kind(kind)] += 1
        _STATS["queue_depth"] += 1


def record_cache_hit(kind: str) -> None:
    """A submission answered from the LRU cache (it never held a queue
    slot, so ``queue_depth`` does not move)."""
    with _LOCK:
        _STATS["queries"][_kind(kind)] += 1
        _STATS["cache_hits"][_kind(kind)] += 1


def record_cache_miss() -> None:
    with _LOCK:
        _STATS["cache_misses"] += 1


def record_shed(kind: str) -> None:
    with _LOCK:
        _STATS["shed"][_kind(kind)] += 1


def record_serial_fallback() -> None:
    with _LOCK:
        _STATS["serial_fallbacks"] += 1


def record_flush(reason: str, queries: int, groups: int) -> None:
    with _LOCK:
        _STATS["flushes"][reason] = _STATS["flushes"].get(reason, 0) + 1
        _STATS["flush_queries"] += int(queries)
        _STATS["flush_groups"] += int(groups)
        _STATS["queue_depth"] = max(0, _STATS["queue_depth"] - int(queries))


def record_build(kind: str) -> None:
    with _LOCK:
        _STATS["tree_builds"][_kind(kind)] += 1


def record_tree(leaves: int, lanes: int, device: bool) -> None:
    """One whole-tree pass: ``lanes`` is the bucket lane count on the
    device path, 0 on the host path."""
    with _LOCK:
        if device:
            _STATS["trees_device"] += 1
            _STATS["tree_leaves"] += int(leaves)
            _STATS["tree_lanes"] += int(lanes)
        else:
            _STATS["trees_host"] += 1


def record_device_fallback() -> None:
    with _LOCK:
        _STATS["device_fallbacks"] += 1


def record_oversize() -> None:
    with _LOCK:
        _STATS["oversize_host"] += 1


def queue_depth() -> int:
    with _LOCK:
        return _STATS["queue_depth"]


def snapshot() -> dict:
    """A copy of the counters with the derived aggregates."""
    with _LOCK:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in _STATS.items()}
    out["queries_total"] = sum(out["queries"].values())
    out["cache_hits_total"] = sum(out["cache_hits"].values())
    out["shed_total"] = sum(out["shed"].values())
    out["tree_builds_total"] = sum(out["tree_builds"].values())
    lookups = out["cache_hits_total"] + out["cache_misses"]
    out["proof_cache_hit_rate"] = (
        out["cache_hits_total"] / lookups if lookups else 0.0)
    out["lanes_occupancy"] = (
        out["tree_leaves"] / out["tree_lanes"] if out["tree_lanes"] else 0.0)
    flushes = sum(out["flushes"].values())
    out["queries_per_flush"] = (
        out["flush_queries"] / flushes if flushes else 0.0)
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
