"""Flow-rate monitoring and limiting (reference: internal/flowrate).

Sliding-window rate monitor used by MConnection channels (send-rate
limiting) and blocksync peers (timeout detection).
"""

from __future__ import annotations

import threading
import time


class Monitor:
    """Tracks transfer rate over an exponentially-weighted window
    (reference: internal/flowrate/flowrate.go Monitor)."""

    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._lock = threading.Lock()
        self.sample_period = sample_period
        self.window = window
        self.start = time.monotonic()
        self.total = 0
        self._rate = 0.0  # EWMA bytes/sec
        self._acc = 0  # bytes since last sample
        self._last_sample = self.start

    def update(self, n: int) -> None:
        with self._lock:
            self.total += n
            self._acc += n
            self._maybe_sample()

    def _maybe_sample(self) -> None:
        now = time.monotonic()
        elapsed = now - self._last_sample
        if elapsed < self.sample_period:
            return
        inst = self._acc / elapsed
        alpha = 1.0 - pow(0.5, elapsed / self.window)
        self._rate += alpha * (inst - self._rate)
        self._acc = 0
        self._last_sample = now

    def rate(self) -> float:
        """Current bytes/sec estimate."""
        with self._lock:
            self._maybe_sample()
            return self._rate

    def avg_rate(self) -> float:
        with self._lock:
            dt = time.monotonic() - self.start
            return self.total / dt if dt > 0 else 0.0

    def limit(self, want: int, max_rate: int) -> int:
        """How many of ``want`` bytes may be sent now to stay under
        ``max_rate`` bytes/sec; sleeps briefly when over budget
        (reference: flowrate.go Limit)."""
        if max_rate <= 0:
            return want
        while self.rate() > max_rate:
            time.sleep(self.sample_period / 2)
        return want
