"""Minimal latency histogram — the shared data shape of the hot-path stats
modules (``verifysched/stats``, ``ops/dispatch_stats``); the port's copy
of the JAX package's ``libs/histo``.

``Histo.observe`` is a linear bucket scan (the bound lists are about a
dozen entries), guarded by the CALLER's lock: the stats modules already
serialize their counters behind one lock each.
"""

from __future__ import annotations

# Submit->verdict / queue-wait style latencies: sub-millisecond coalescing
# up through multi-second degraded-host tails.
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 10.0,
)

# Device dispatch wall times: kernel launches up through watchdog-deadline
# territory.
DISPATCH_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 30.0,
)


class Histo:
    """Fixed-bound histogram: per-bucket counts + sum + count.  Not
    thread-safe by itself: callers observe under their own stats lock."""

    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(self, bounds=LATENCY_BUCKETS_S):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.n += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def to_dict(self) -> dict:
        """Non-cumulative per-bucket counts aligned with ``bounds`` (+1
        overflow), sum and count, plus approximate p50/p99 (bucket upper
        bounds)."""
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.n,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 when
        empty; the overflow bucket reports the largest finite bound)."""
        if self.n == 0:
            return 0.0
        target = max(1, int(q * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]
