"""Process-wide counters for the disk-fault supervisor (libs/diskguard).

Imports neither torch nor CUDA, like ``ops/dispatch_stats``: reading
them (the JAX package's ``cometbft_storage_*`` metrics and its trace
document, which wait for ROADMAP "Node assembly" stage (d)) must never be
the thing that initializes a device.
``libs/diskguard.py`` (and the WAL's boot-time tail repair) write them.

Per surface (wal / privval / state / blackbox / exec_cache / indexer /
status — docs/storage-robustness.md):
  * ``writes``   — guarded durable write/replace/batch operations
  * ``fsyncs``   — guarded fsync/flush-to-disk operations
  * ``retries``  — degraded-surface retry attempts after transient IO errors
  * ``drops``    — degraded-surface operations abandoned after retries
  * ``fatals``   — fail-stop surface IO failures (each one halted a node)
  * ``injected`` — faults the deterministic injector fired (sim/bench only)
  * ``repairs`` / ``repaired_bytes`` — boot-time crash-consistency scrub
    actions (WAL corrupt-tail truncation)
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()

_KEYS = (
    "writes",
    "fsyncs",
    "retries",
    "drops",
    "fatals",
    "injected",
    "repairs",
    "repaired_bytes",
)


def _zero() -> dict:
    return {"surfaces": {}}


_STATS = _zero()


def _surface(name: str) -> dict:
    s = _STATS["surfaces"].get(name)
    if s is None:
        s = {k: 0 for k in _KEYS}
        _STATS["surfaces"][name] = s
    return s


def record_op(surface: str, op: str) -> None:
    with _LOCK:
        s = _surface(surface)
        if op in ("fsync", "flush"):
            s["fsyncs"] += 1
        else:
            s["writes"] += 1


def record_retry(surface: str) -> None:
    with _LOCK:
        _surface(surface)["retries"] += 1


def record_drop(surface: str) -> None:
    with _LOCK:
        _surface(surface)["drops"] += 1


def record_fatal(surface: str) -> None:
    with _LOCK:
        _surface(surface)["fatals"] += 1


def record_injected(surface: str) -> None:
    with _LOCK:
        _surface(surface)["injected"] += 1


def record_repair(surface: str, dropped_bytes: int) -> None:
    with _LOCK:
        s = _surface(surface)
        s["repairs"] += 1
        s["repaired_bytes"] += int(dropped_bytes)


def per_surface(key: str) -> dict:
    """{surface: value} for one counter — the shape
    ``metrics.LabeledCallbackGauge`` reads at scrape time."""
    with _LOCK:
        return {
            name: s[key] for name, s in _STATS["surfaces"].items()
        }


def snapshot() -> dict:
    with _LOCK:
        surfaces = {
            name: dict(s) for name, s in _STATS["surfaces"].items()
        }
    totals = {k: sum(s[k] for s in surfaces.values()) for k in _KEYS}
    totals["fatal"] = totals["fatals"] > 0
    return {"surfaces": surfaces, "totals": totals}


def faulted() -> bool:
    """True when any surface saw injector or real-IO trouble this process
    (retries, drops, fatals, injections, repairs) — the gate for
    attaching a ``storage`` block to sim soak rows."""
    snap = snapshot()["totals"]
    return bool(
        snap["retries"]
        or snap["drops"]
        or snap["fatals"]
        or snap["injected"]
        or snap["repairs"]
    )


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
