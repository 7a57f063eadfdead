"""Virtual time: the deterministic heart of the simulation.

``VirtualClock`` is a seeded-order event heap; time advances only when the
driver pops the next event, so a 10-minute partition scenario runs in
milliseconds of wall time and two runs with the same seed pop events in the
same order.  ``SimTicker`` implements the ``consensus/ticker.py`` seam on
top of it, so ``ConsensusState`` timeouts fire on virtual time.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from cometbft_tpu_torch.consensus.ticker import TimeoutInfo


class SimTimer:
    """Handle for a scheduled callback; ``cancel`` is O(1) (lazy removal)."""

    __slots__ = ("when", "seq", "fn", "label", "cancelled")

    def __init__(self, when: float, seq: int, fn: Callable[[], None], label: str):
        self.when = when
        self.seq = seq
        self.fn = fn
        self.label = label
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "SimTimer") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class VirtualClock:
    """Single-threaded discrete-event clock.

    Events at equal times fire in scheduling order (a monotonically
    increasing sequence number breaks ties), which keeps the pop order a
    pure function of the schedule calls — the determinism proof relies on
    this.  The instance is callable so it can be handed directly to
    ``ConsensusState(clock=...)``.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._seq = 0
        self._heap: list[SimTimer] = []

    def now(self) -> float:
        return self._now

    def __call__(self) -> float:
        return self._now

    def call_at(self, when: float, fn: Callable[[], None], label: str = "") -> SimTimer:
        # never schedule into the past: clamp to now (still strictly ordered
        # after anything already popped)
        timer = SimTimer(max(when, self._now), self._seq, fn, label)
        self._seq += 1
        heapq.heappush(self._heap, timer)
        return timer

    def call_later(self, delay: float, fn: Callable[[], None], label: str = "") -> SimTimer:
        return self.call_at(self._now + delay, fn, label)

    def pending(self) -> int:
        return sum(1 for t in self._heap if not t.cancelled)

    def advance_to(self, when: float) -> None:
        """Advance idle time WITHOUT firing events.  Callers must ensure no
        pending event is scheduled before ``when`` (the statesync sleeper
        drains those through ``tick`` first); time never moves backwards."""
        nxt = self.next_event_time()
        if nxt is not None and nxt < when:
            raise ValueError(
                f"advance_to({when}) would skip an event at {nxt}"
            )
        self._now = max(self._now, float(when))

    def next_event_time(self) -> Optional[float]:
        self._drop_cancelled()
        return self._heap[0].when if self._heap else None

    def _drop_cancelled(self) -> None:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)

    def tick(self) -> Optional[SimTimer]:
        """Advance to and fire the next event; None when the heap is dry."""
        self._drop_cancelled()
        if not self._heap:
            return None
        timer = heapq.heappop(self._heap)
        self._now = timer.when
        timer.fn()
        return timer


class SimTicker:
    """``TimeoutTicker`` semantics (one pending timeout, later (H,R,S)
    replaces, stale fires dropped) on a ``VirtualClock``.

    Construct via ``ticker_factory=lambda tock: SimTicker(clock, tock,
    name=...)`` when building a ``ConsensusState``.
    """

    def __init__(
        self,
        clock: VirtualClock,
        on_timeout: Callable[[TimeoutInfo], None],
        name: str = "sim",
    ):
        self.clock = clock
        self.on_timeout = on_timeout
        self.name = name
        self._pending: Optional[TimeoutInfo] = None
        self._timer: Optional[SimTimer] = None
        self._running = False

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._pending = None

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        if self._pending is not None and ti < self._pending:
            return  # stale: never roll the clock back
        if self._timer is not None:
            self._timer.cancel()
        self._pending = ti
        self._timer = self.clock.call_later(
            ti.duration,
            lambda: self._fire(ti),
            label="%s timeout h=%d r=%d s=%d"
            % (self.name, ti.height, ti.round_, ti.step),
        )

    def _fire(self, ti: TimeoutInfo) -> None:
        if self._pending is not ti:
            return  # superseded
        self._pending = None
        self._timer = None
        if self._running:
            self.on_timeout(ti)
