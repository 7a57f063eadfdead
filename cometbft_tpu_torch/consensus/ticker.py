"""Timeout ticker (reference: internal/consensus/ticker.go).

A single timer keyed on (height, round, step): scheduling a new timeout for a
later (H,R,S) replaces the pending one; stale fires (for an earlier H,R,S than
the last scheduled) are dropped.  Fired timeouts are delivered to a callback
that enqueues them into the consensus receive loop.

This module is a seam: ``ConsensusState`` accepts any ``ticker_factory``
producing an object with ``schedule_timeout(TimeoutInfo)`` / ``start()`` /
``stop()`` and the one-pending-timeout replacement semantics above.
``TimeoutTicker`` is the wall-clock implementation (threading.Timer);
``sim/clock.py``'s ``SimTicker`` is the virtual-time one used by the
deterministic simulation harness.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.libs.service import BaseService


@dataclass(frozen=True)
class TimeoutInfo:
    duration: float  # seconds
    height: int
    round_: int
    step: int

    def __lt__(self, other: "TimeoutInfo") -> bool:
        return (self.height, self.round_, self.step) < (
            other.height,
            other.round_,
            other.step,
        )


class TimeoutTicker(BaseService):
    """Reference: ticker.go timeoutTicker — one pending timeout max."""

    def __init__(self, on_timeout: Callable[[TimeoutInfo], None]):
        super().__init__("TimeoutTicker")
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._pending: Optional[TimeoutInfo] = None
        self._mtx = threading.Lock()

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        with self._mtx:
            if self._pending is not None and ti < self._pending:
                return  # stale: never roll the clock back
            if self._timer is not None:
                self._timer.cancel()
            self._pending = ti
            self._timer = threading.Timer(ti.duration, self._fire, args=(ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._mtx:
            if self._pending is not ti:
                return  # superseded
            self._pending = None
            self._timer = None
        if self.is_running:
            self.on_timeout(ti)

    def on_stop(self) -> None:
        with self._mtx:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._pending = None
