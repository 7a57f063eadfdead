"""Process-wide counters for the evidence pool.

Imports neither torch nor CUDA, like ``verifysched/stats``: reading them
(the JAX package's ``libs/metrics`` gauges ``cometbft_evidence_*``, which
wait for ROADMAP "Node assembly" stage (d)) must never be the thing that
initializes a device.

Counters (one lock):
  * ``added``      — evidence verified and admitted to the pending pool
  * ``dedup``      — ingest attempts dropped because the identical evidence
    was already pending or committed (a duplicate-vote flood's common case:
    costs a hash lookup, never a signature check or a pool slot)
  * ``dropped``    — verified evidence dropped because the pool hit its
    size bound (the flood degrades to drops, never unbounded memory)
  * ``rejected``   — evidence that failed verification at ingest
  * ``committed``  — evidence that made it into a committed block
  * ``pruned``     — pending evidence expired by the age bound
  * ``pool_depth`` / ``pool_bytes`` — pending pool occupancy (gauge-style;
    one pool per process in production — in-process multi-node harnesses
    see the last writer's pool)
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "added": 0,
        "dedup": 0,
        "dropped": 0,
        "rejected": 0,
        "committed": 0,
        "pruned": 0,
        "pool_depth": 0,
        "pool_bytes": 0,
    }


_STATS = _zero()


def record(kind: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[kind] += n


def set_depth(depth: int, bytes_: int) -> None:
    with _LOCK:
        _STATS["pool_depth"] = int(depth)
        _STATS["pool_bytes"] = int(bytes_)


def snapshot() -> dict:
    with _LOCK:
        return dict(_STATS)


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
