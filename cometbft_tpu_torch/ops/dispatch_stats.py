"""Process-wide counters for the batched-verify pipeline.

Imports neither torch nor CUDA: reading them must never be the thing that
initializes a device.  ``ops/verify.py`` and ``ops/supervisor.py`` write
them.

Counters:
  * ``dispatches``       — device dispatches (kernel or plain version)
  * ``lanes_total``      — lanes shipped across all dispatches (the CUDA
    kernel takes its batch unpadded; the torch tier pads to a bucket)
  * ``lanes_used``       — lanes carrying a real signature (occupancy)
  * ``fused_batches``    — fused verifies of more than one segment
  * ``fused_segments``   — segments that rode in a fused dispatch
  * ``verify_calls`` / ``verify_seconds`` — commit-verification latency
  * ``inflight_depth`` / ``inflight_hwm`` — supervised dispatches whose
    fetch has not resolved yet, and the high-water mark since reset
  * ``lane_dispatches`` / ``lane_lanes_total`` / ``lane_lanes_used`` — the
    in-flight routing tally per lane (a mesh ordinal or a supervisor tier)
  * ``mesh_width`` / ``mesh_shrinks`` / ``mesh_restores`` — the elastic
    mesh's current membership width (0: no mesh) and its shrink and
    re-admission counts (``parallel/elastic``)
  * ``tier_dispatches`` / ``tier_lanes`` — batches and signatures SERVED
    per key type and tier (``cuda`` on a card; ``torch``, then ``host``
    below it, on the CPU).  A card's batch that the kernel did not serve
    raises and shows under no tier; on the CPU a batch the plain version
    did not serve shows under ``host``.  A BLS12-381 batch
    (``crypto/batch.BlsBatchVerifier``) records its G1 call under the key
    type ``bls12_381``, counting the batch's structurally valid entries
    (the host library answers under ``host``).  The SHA-256 tree plane
    (``ops/sha256_tree``) records its tree passes and leaves under the key
    ``merkle`` (``host`` for the sets it routes to the host), and the
    oversize ones also under ``merkle_oversize``.  The transport plane
    records its AEAD passes and frames under ``aead`` (``ops/chacha_aead``;
    oversize batches also under ``aead_oversize``) and its ladder passes
    and exchanges under ``x25519`` (``ops/x25519_ladder``; oversize under
    ``x25519_oversize``), ``host`` for what the gate, a kill switch or the
    bucket rules route to the host.

Histograms:
  * ``buckets[lanes]``            — dispatch count per lane count
  * ``dispatch_hist[tier-lanes]`` — dispatch wall time per (tier, lanes)
  * ``shard_hist[device]``        — per-ordinal shard fetch wall time on
    the mesh-sharded path (``parallel/mesh.fetch_sharded``): one sick card
    is one outlier series
  * ``verify_hist``               — commit verification latency
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.libs.histo import DISPATCH_BUCKETS_S, Histo

TIERS = ("cuda", "torch", "host")

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "dispatches": 0,
        "lanes_total": 0,
        "lanes_used": 0,
        "fused_batches": 0,
        "fused_segments": 0,
        "verify_calls": 0,
        "verify_seconds": 0.0,
        "buckets": {},  # lanes -> dispatch count
        "dispatch_hist": {},  # "tier-lanes" -> Histo (wall seconds)
        "shard_hist": {},  # device ordinal (str) -> Histo (wall seconds)
        "verify_hist": Histo(),
        # the elastic mesh (parallel/elastic): width the last dispatch
        # targeted (0 = mesh inactive), shrink/restore counts
        "mesh_width": 0,
        "mesh_shrinks": 0,
        "mesh_restores": 0,
        "inflight_depth": 0,
        "inflight_hwm": 0,
        "lane_dispatches": {},  # lane (str) -> dispatches routed there
        "lane_lanes_total": {},  # lane (str) -> lanes shipped
        "lane_lanes_used": {},  # lane (str) -> lanes carrying a signature
        "tier_dispatches": {},  # key type -> tier -> batches served
        "tier_lanes": {},  # key type -> tier -> signatures served
    }


_STATS = _zero()


def record_dispatch(lanes_total: int, lanes_used: int) -> None:
    with _LOCK:
        _STATS["dispatches"] += 1
        _STATS["lanes_total"] += int(lanes_total)
        _STATS["lanes_used"] += int(lanes_used)
        b = _STATS["buckets"]
        b[int(lanes_total)] = b.get(int(lanes_total), 0) + 1


def record_dispatch_time(impl: str, lanes: int, seconds: float) -> None:
    """Wall time of one device dispatch (dispatch + fetch), keyed by
    (supervisor tier, lanes)."""
    key = f"{impl}-{int(lanes)}"
    with _LOCK:
        h = _STATS["dispatch_hist"].get(key)
        if h is None:
            h = _STATS["dispatch_hist"][key] = Histo(DISPATCH_BUCKETS_S)
        h.observe(float(seconds))


def record_shard_time(impl: str, device: int, lanes: int, seconds: float) -> None:
    """Wall time of one per-ordinal shard fetch on the mesh path, keyed by
    the stable ordinal (``cometbft_crypto_shard_dispatch_seconds{device=}``).
    ``impl`` and ``lanes`` ride the span; the series is the device, so a
    sick card is one series whatever its lanes."""
    del impl, lanes
    key = str(int(device))
    with _LOCK:
        h = _STATS["shard_hist"].get(key)
        if h is None:
            h = _STATS["shard_hist"][key] = Histo(DISPATCH_BUCKETS_S)
        h.observe(float(seconds))


def record_mesh_width(width: int) -> None:
    """Width of the elastic mesh's current membership, written by
    ``parallel/elastic`` at every reconfiguration (the
    ``cometbft_crypto_mesh_width`` gauge)."""
    with _LOCK:
        _STATS["mesh_width"] = int(width)


def record_mesh_shrink() -> None:
    with _LOCK:
        _STATS["mesh_shrinks"] += 1


def record_mesh_restore() -> None:
    with _LOCK:
        _STATS["mesh_restores"] += 1


def mesh_width() -> int:
    with _LOCK:
        return _STATS["mesh_width"]


def record_tier(tier: str, n_signatures: int, key_type: str = "ed25519") -> None:
    """One batch of ``n_signatures`` ``key_type`` signatures (or one tree
    pass of as many leaves) answered by ``tier`` of the chain."""
    with _LOCK:
        for k, n in (("tier_dispatches", 1), ("tier_lanes", int(n_signatures))):
            d = _STATS[k].setdefault(key_type, dict.fromkeys(TIERS, 0))
            d[tier] = d.get(tier, 0) + n


def tier_counts(key_type: str = "ed25519") -> dict:
    """{tier: (batches served, signatures served)} for ``key_type``."""
    with _LOCK:
        d = _STATS["tier_dispatches"].get(key_type, dict.fromkeys(TIERS, 0))
        lanes = _STATS["tier_lanes"].get(key_type, {})
        return {t: (d[t], lanes.get(t, 0)) for t in d}


def record_inflight_enter() -> int:
    """A dispatch left for the device without blocking on its verdict.
    Returns the depth INCLUDING this dispatch."""
    with _LOCK:
        _STATS["inflight_depth"] += 1
        d = _STATS["inflight_depth"]
        if d > _STATS["inflight_hwm"]:
            _STATS["inflight_hwm"] = d
        return d


def record_inflight_exit() -> None:
    """The matching fetch resolved (or failed definitively)."""
    with _LOCK:
        _STATS["inflight_depth"] = max(0, _STATS["inflight_depth"] - 1)


def record_lane_dispatch(lane: str, lanes_total: int, lanes_used: int) -> None:
    """Per-lane routing tally of the in-flight pipeline: ``lane`` is a mesh
    ordinal (str) or a supervisor tier name."""
    key = str(lane)
    with _LOCK:
        d = _STATS["lane_dispatches"]
        d[key] = d.get(key, 0) + 1
        t = _STATS["lane_lanes_total"]
        t[key] = t.get(key, 0) + int(lanes_total)
        u = _STATS["lane_lanes_used"]
        u[key] = u.get(key, 0) + int(lanes_used)


def record_fused(n_segments: int) -> None:
    with _LOCK:
        _STATS["fused_batches"] += 1
        _STATS["fused_segments"] += int(n_segments)


def record_verify_latency(seconds: float) -> None:
    with _LOCK:
        _STATS["verify_calls"] += 1
        _STATS["verify_seconds"] += float(seconds)
        _STATS["verify_hist"].observe(float(seconds))


def dispatch_count() -> int:
    """Device dispatches so far: the ordinal a ``verify.dispatch`` span
    names (the triple an anomaly dump attributes a watchdog fire to)."""
    with _LOCK:
        return _STATS["dispatches"]


def snapshot() -> dict:
    with _LOCK:
        out = {}
        for k, v in _STATS.items():
            if isinstance(v, Histo):
                out[k] = v.to_dict()
            elif isinstance(v, dict):
                out[k] = {
                    kk: (vv.to_dict() if isinstance(vv, Histo)
                         else dict(vv) if isinstance(vv, dict) else vv)
                    for kk, vv in v.items()
                }
            else:
                out[k] = v
    out["occupancy"] = (
        out["lanes_used"] / out["lanes_total"] if out["lanes_total"] else 0.0
    )
    out["lane_occupancy"] = {
        lane: (
            out["lane_lanes_used"].get(lane, 0) / total if total else 0.0
        )
        for lane, total in out["lane_lanes_total"].items()
    }
    return out


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
