"""Process-wide counters for the blocksync pool/reactor.

Deliberately free of jax imports, exactly like ``verifysched/stats``:
``libs/metrics.NodeMetrics`` reads these through callback gauges and a
/metrics scrape must never be the thing that initializes an accelerator
backend.  ``blocksync/pool.py`` and ``blocksync/reactor.py`` write them.

Counters (all guarded by one lock):
  * ``requests``        — block requests actually sent to peers
  * ``send_failures``   — requests whose try_send returned False (unwound)
  * ``timeouts``        — in-flight requests expired by the (adaptive)
    per-peer timeout and re-assigned
  * ``bans``            — ban events (timeout or redo), any backoff level
  * ``probes``          — half-open re-admission probes issued to a peer
    whose ban expired (exactly one in-flight block request)
  * ``probe_passes``    — probes answered with a good block: the peer is
    re-admitted at full window share
  * ``redos``           — bad-block redo_request calls (verification or
    validation failure on a served block)
  * ``no_blocks``       — NoBlockResponse replies (peer advertised a range
    it could not serve)
  * ``stall_switches``  — frontier requests force-moved to the fastest
    advertising peer after the stall window elapsed with no progress
  * ``blocks_received`` — blocks accepted into the pool window
  * ``heights_synced``  — frontier blocks verified + applied (pop_request)
  * ``window_depth``    — in-flight requests right now (gauge-style)
  * ``peers``           — peers currently advertising a range (gauge-style)
  * ``synced_base`` / ``synced_head`` / ``sync_seconds`` — first and last
    applied height plus pool-clock seconds between them, for heights/s
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "requests": 0,
        "send_failures": 0,
        "timeouts": 0,
        "bans": 0,
        "probes": 0,
        "probe_passes": 0,
        "redos": 0,
        "no_blocks": 0,
        "stall_switches": 0,
        "blocks_received": 0,
        "heights_synced": 0,
        "window_depth": 0,
        "peers": 0,
        "synced_base": 0,
        "synced_head": 0,
        "sync_seconds": 0.0,
    }


_STATS = _zero()


def record_request(n: int = 1) -> None:
    with _LOCK:
        _STATS["requests"] += int(n)


def record_send_failure(n: int = 1) -> None:
    with _LOCK:
        _STATS["send_failures"] += int(n)


def record_timeout(n: int = 1) -> None:
    with _LOCK:
        _STATS["timeouts"] += int(n)


def record_ban(n: int = 1) -> None:
    with _LOCK:
        _STATS["bans"] += int(n)


def record_probe(n: int = 1) -> None:
    with _LOCK:
        _STATS["probes"] += int(n)


def record_probe_pass(n: int = 1) -> None:
    with _LOCK:
        _STATS["probe_passes"] += int(n)


def record_redo(n: int = 1) -> None:
    with _LOCK:
        _STATS["redos"] += int(n)


def record_no_block(n: int = 1) -> None:
    with _LOCK:
        _STATS["no_blocks"] += int(n)


def record_stall_switch(n: int = 1) -> None:
    with _LOCK:
        _STATS["stall_switches"] += int(n)


def record_block_received(n: int = 1) -> None:
    with _LOCK:
        _STATS["blocks_received"] += int(n)


def record_height_synced(height: int, now_s: float) -> None:
    """One frontier block applied.  ``now_s`` is the POOL's clock (virtual
    in the sim), so heights/s stays deterministic per seed there."""
    with _LOCK:
        _STATS["heights_synced"] += 1
        if _STATS["synced_base"] == 0:
            _STATS["synced_base"] = int(height)
            _STATS["_t0"] = float(now_s)
        _STATS["synced_head"] = int(height)
        _STATS["sync_seconds"] = max(
            0.0, float(now_s) - _STATS.get("_t0", float(now_s))
        )


def record_gauges(window_depth: int, peers: int) -> None:
    with _LOCK:
        _STATS["window_depth"] = int(window_depth)
        _STATS["peers"] = int(peers)


def snapshot() -> dict:
    """Copy for metrics/tests; adds derived aggregates."""
    with _LOCK:
        out = dict(_STATS)
    out.pop("_t0", None)
    out["heights_per_second"] = (
        out["heights_synced"] / out["sync_seconds"]
        if out["sync_seconds"] > 0
        else 0.0
    )
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
