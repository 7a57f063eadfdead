"""The card's availability as telemetry.

This module folds probe results into the node's own telemetry:

  * ``record_probe(up, ...)`` — fed from a watcher's status file.  Up↔down
    TRANSITIONS are journaled as black-box ``device_probe`` events
    (``tracing.note_event``), so an outage window is reconstructable from
    a dead node's journal.
  * ``cometbft_device_up`` — a /metrics gauge over ``snapshot()``
    (1 up, 0 down, -1 never probed).
  * a ``device`` section in ``tracing.trace_document()`` (the
    ``/debug/verify_trace`` document and the ``cmd trace`` CLI).

An out-of-process watcher writes a small status JSON after every probe; a
node pointed at it via ``COMETBFT_TPU_CHIP_STATUS`` picks changes up on
its sampler loop (``poll_status_file``), so watcher and node never share a
process.  There is no in-process prober.

Free of torch and of every CUDA call, like every forensic surface:
reading the card's health must never be the thing that initializes (or
hangs on) the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

_LOCK = threading.Lock()


def _fresh() -> dict:
    return {
        "up": None,  # None = never probed
        "platform": "",
        "init_s": None,
        "probes": 0,
        "transitions": 0,
        "last_change_t": None,
        "last_probe_t": None,
        "source": "",
        "_file_mtime": 0.0,
        # per-ordinal availability on a multi-card host (stable ordinal ->
        # bool); a down ordinal leaves the elastic mesh (parallel/elastic)
        "ordinals": {},
    }


_S = _fresh()


def record_probe(
    up: bool,
    platform: str = "",
    init_s: Optional[float] = None,
    source: str = "probe",
    t: Optional[float] = None,
    ordinal: Optional[int] = None,
) -> bool:
    """Record one probe result; returns True when the availability state
    CHANGED (first probe, or an up↔down flip).  Transitions are journaled
    as black-box ``device_probe`` events — a no-op without a journal.

    With ``ordinal`` the probe targets ONE card of a multi-card host: the
    per-ordinal state is tracked separately and the journaled event
    carries the ordinal; a transition is folded into the elastic mesh's
    membership (``parallel/elastic.note_probe``: a down card leaves the
    mesh before the next dispatch)."""
    if ordinal is not None:
        return _record_ordinal_probe(int(ordinal), bool(up), source, t)
    t = time.time() if t is None else t
    with _LOCK:
        prev = _S["up"]
        changed = prev is None or prev != bool(up)
        _S["up"] = bool(up)
        _S["platform"] = platform or _S["platform"]
        if init_s is not None:
            _S["init_s"] = init_s
        _S["probes"] += 1
        _S["last_probe_t"] = t
        _S["source"] = source
        if changed:
            if prev is not None:
                _S["transitions"] += 1
            _S["last_change_t"] = t
    if changed:
        from cometbft_tpu_torch.libs import tracing

        tracing.note_event(
            "device_probe",
            up=bool(up),
            platform=platform,
            source=source,
        )
    return changed


def _record_ordinal_probe(
    ordinal: int, up: bool, source: str, t: Optional[float]
) -> bool:
    t = time.time() if t is None else t
    with _LOCK:
        prev = _S["ordinals"].get(ordinal)
        changed = prev is None or prev != up
        _S["ordinals"][ordinal] = up
        _S["probes"] += 1
        _S["last_probe_t"] = t
        _S["source"] = source
        if changed:
            if prev is not None:
                _S["transitions"] += 1
            _S["last_change_t"] = t
    if changed:
        from cometbft_tpu_torch.libs import tracing

        tracing.note_event(
            "device_probe", up=up, ordinal=ordinal, source=source
        )
        # proactive mesh exclusion (a no-op when no mesh is configured or
        # the ordinal is not a member)
        from cometbft_tpu_torch.parallel import elastic

        elastic.note_probe(ordinal, up)
    return changed


def status_file() -> Optional[str]:
    return os.environ.get("COMETBFT_TPU_CHIP_STATUS") or None


def poll_status_file(path: Optional[str] = None) -> bool:
    """Fold the chip watcher's status JSON into the in-process state.
    Cheap (one stat) when unchanged; tolerant of a missing or torn file
    (the watcher may be mid-write).  Returns True on a state change."""
    path = path or status_file()
    if not path:
        return False
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return False
    with _LOCK:
        prev_mtime = _S["_file_mtime"]
        if mtime <= prev_mtime:
            return False
        _S["_file_mtime"] = mtime
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        # torn or mid-write: roll the consumed mark back so the NEXT poll
        # retries this update instead of dropping it forever
        with _LOCK:
            if _S["_file_mtime"] == mtime:
                _S["_file_mtime"] = prev_mtime
        return False
    changed = record_probe(
        up=bool(doc.get("up")),
        platform=str(doc.get("platform") or ""),
        init_s=doc.get("init_s"),
        source="chipwatch",
        t=doc.get("t"),
    )
    # optional per-ordinal statuses ({"ordinals": {"2": false, ...}}): a
    # watcher that can tell WHICH card died records that card alone
    # instead of the whole device gauge
    ords = doc.get("ordinals")
    if isinstance(ords, dict):
        for k, v in sorted(ords.items()):
            try:
                o = int(k)
            except (TypeError, ValueError):
                continue
            if record_probe(
                up=bool(v), source="chipwatch", t=doc.get("t"), ordinal=o
            ):
                changed = True
    return changed


def snapshot() -> dict:
    """The ``device`` section of the forensic document; reads the status
    file first so a scrape is never staler than the watcher."""
    poll_status_file()
    with _LOCK:
        return {
            "up": _S["up"],
            # the gauge encoding: 1 up, 0 down, -1 never probed
            "up_code": -1 if _S["up"] is None else int(_S["up"]),
            "platform": _S["platform"],
            "init_s": _S["init_s"],
            "probes": _S["probes"],
            "transitions": _S["transitions"],
            "last_change_t": _S["last_change_t"],
            "last_probe_t": _S["last_probe_t"],
            "source": _S["source"],
            "status_file": status_file() or "",
            "ordinals": {str(k): v for k, v in sorted(_S["ordinals"].items())},
        }


def reset() -> None:
    global _S
    with _LOCK:
        _S = _fresh()
