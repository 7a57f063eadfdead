"""Process-wide counters for the encrypted transport data plane.

The port's own copy of the JAX package's ``p2p/transport_stats.py``.  It
imports neither torch nor CUDA, like ``verifysched/stats``: reading the
counters must never be the thing that initializes a device.
``ops/chacha_aead.py`` writes the AEAD dispatch counters (it knows the
padded lane count at dispatch time); ``p2p/transportplane.py`` writes the
frame-routing counters; ``p2p/handshake_pool.py`` and
``ops/x25519_ladder.py`` write the handshake counters.

Counters (all guarded by one lock):

  * ``frames[path]``       — AEAD frames by route: ``batched`` (through a
    coalesced plane call) / ``serial`` (below min batch, plane disabled,
    or a caller without batch support)
  * ``batches[op]``        — coalesced plane calls by op (``seal``/``open``)
  * ``dispatches[tier]``   — AEAD kernel passes by execution tier
    (``device``: the kernel on a card or its plain version on the CPU /
    ``host``: ``aead_ref``; the JAX package's numpy and pure tiers are one
    here); dispatches per 1k frames counts every tier
  * ``aead_frames_device`` / ``aead_lanes`` — frames processed on the
    device tier and the bucket-padded lanes they occupied
    (aead_lanes_occupancy = frames / lanes)
  * ``device_fallbacks``   — device AEAD passes degraded to the host tier
    (the CPU only: on a card a failed pass raises)
  * ``bad_tags``           — frames that failed authentication (a REAL
    reject, confirmed on the reference's Poly1305)
  * ``reject_confirms``    — device-tier tag mismatches re-verified on
    the reference tier before the verdict was allowed out
  * ``handshakes[path]``   — X25519 exchanges by route: ``pool``
    (coalesced ladder dispatch) / ``sync`` (the synchronous dial: one
    direct supervised launch on a card, the host oracle elsewhere)
  * ``hs_shed``            — pool submissions shed by admission control
    (the sync dial answers them — shed costs coalescing, never the
    connection)
  * ``hs_flushes[reason]`` — pool dispatcher flushes by trigger
    (``deadline`` / ``full`` / ``shutdown``)
  * ``hs_flush_items``     — exchanges drained across all flushes
    (handshakes_per_flush = hs_flush_items / hs_flushes)
  * ``hs_queue_depth``     — exchanges currently queued (gauge-style)
  * ``hs_device`` / ``hs_host`` — ladder passes by path (the kernel, its
    plain version or the runner seam vs the per-lane host oracle)
  * ``hs_lanes``           — bucket-padded ladder lanes dispatched
    (hs_lanes_occupancy = pool handshakes dispatched / lanes)
"""

from __future__ import annotations

import threading

FRAME_PATHS = ("batched", "serial")
OPS = ("seal", "open")
TIERS = ("device", "host")
HS_PATHS = ("pool", "sync")
FLUSH_REASONS = ("deadline", "full", "shutdown")

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "frames": {p: 0 for p in FRAME_PATHS},
        "batches": {o: 0 for o in OPS},
        "dispatches": {t: 0 for t in TIERS},
        "aead_frames_device": 0,
        "aead_lanes": 0,
        "device_fallbacks": 0,
        "bad_tags": 0,
        "reject_confirms": 0,
        "handshakes": {p: 0 for p in HS_PATHS},
        "hs_shed": 0,
        "hs_flushes": {r: 0 for r in FLUSH_REASONS},
        "hs_flush_items": 0,
        "hs_queue_depth": 0,
        "hs_device": 0,
        "hs_host": 0,
        "hs_lanes": 0,
        "hs_dispatch_items": 0,
    }


_STATS = _zero()


def record_frames(path: str, n: int) -> None:
    with _LOCK:
        _STATS["frames"][path if path in FRAME_PATHS else "serial"] += int(n)


def record_batch(op: str) -> None:
    with _LOCK:
        _STATS["batches"][op if op in OPS else "seal"] += 1


def record_dispatch(tier: str, frames: int, lanes: int = 0) -> None:
    """One AEAD kernel/host pass over ``frames`` frames.  ``lanes`` is the
    bucket-padded lane count on the device tier, 0 on the host tier (it
    has no padding to waste)."""
    with _LOCK:
        _STATS["dispatches"][tier if tier in TIERS else "host"] += 1
        if tier == "device":
            _STATS["aead_frames_device"] += int(frames)
            _STATS["aead_lanes"] += int(lanes)


def record_device_fallback() -> None:
    with _LOCK:
        _STATS["device_fallbacks"] += 1


def record_bad_tag(n: int = 1) -> None:
    with _LOCK:
        _STATS["bad_tags"] += int(n)


def record_reject_confirm(n: int = 1) -> None:
    with _LOCK:
        _STATS["reject_confirms"] += int(n)


def record_handshake(path: str, n: int = 1) -> None:
    with _LOCK:
        _STATS["handshakes"][path if path in HS_PATHS else "sync"] += int(n)


def record_hs_enqueued(n: int = 1) -> None:
    with _LOCK:
        _STATS["hs_queue_depth"] += int(n)


def record_hs_shed(n: int = 1) -> None:
    with _LOCK:
        _STATS["hs_shed"] += int(n)


def record_hs_flush(reason: str, items: int) -> None:
    with _LOCK:
        _STATS["hs_flushes"][reason] = _STATS["hs_flushes"].get(reason, 0) + 1
        _STATS["hs_flush_items"] += int(items)
        _STATS["hs_queue_depth"] = max(
            0, _STATS["hs_queue_depth"] - int(items)
        )


def record_hs_dispatch(device: bool, items: int, lanes: int = 0) -> None:
    with _LOCK:
        if device:
            _STATS["hs_device"] += 1
            _STATS["hs_lanes"] += int(lanes)
            _STATS["hs_dispatch_items"] += int(items)
        else:
            _STATS["hs_host"] += 1


def hs_queue_depth() -> int:
    with _LOCK:
        return _STATS["hs_queue_depth"]


def snapshot() -> dict:
    """Deep-enough copy for metrics/tests; adds derived aggregates."""
    with _LOCK:
        out = {
            k: (dict(v) if isinstance(v, dict) else v)
            for k, v in _STATS.items()
        }
    out["frames_total"] = sum(out["frames"].values())
    out["dispatches_total"] = sum(out["dispatches"].values())
    out["handshakes_total"] = sum(out["handshakes"].values())
    batches = sum(out["batches"].values())
    out["frames_per_batch"] = (
        out["frames"]["batched"] / batches if batches else 0.0
    )
    out["aead_lanes_occupancy"] = (
        out["aead_frames_device"] / out["aead_lanes"]
        if out["aead_lanes"]
        else 0.0
    )
    flushes = sum(out["hs_flushes"].values())
    out["handshakes_per_flush"] = (
        out["hs_flush_items"] / flushes if flushes else 0.0
    )
    out["hs_lanes_occupancy"] = (
        out["hs_dispatch_items"] / out["hs_lanes"]
        if out["hs_lanes"]
        else 0.0
    )
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
