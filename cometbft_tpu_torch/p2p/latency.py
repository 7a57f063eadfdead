"""WAN latency emulation for testnets: per-link one-way delay injection.

The reference emulates geographic latency with kernel ``tc`` rules driven
by a zone/RTT matrix (test/e2e/pkg/latency/, QA method
docs/references/qa/CometBFT-QA-v1.md:67-89).  This process-level harness
cannot program qdiscs, so the delay lives in the transport instead: a
``DelayedSocket`` wraps each peer connection and holds every outbound
write in a timer queue for the link's one-way delay (half the zone-pair
RTT — both endpoints delay their own sends, so the full RTT emerges).

Zone wiring: each node's config names its ``zone``; the zone matrix maps
(zone_a, zone_b) -> RTT ms.  The peer's zone is known only after the
handshake identifies it, so the wrapper starts with zero delay and the
transport arms it post-handshake (handshakes run undelayed — a documented
simplification; steady-state consensus/gossip traffic is what the QA
saturation method measures).

Send-side queuing preserves ordering per connection and never blocks the
caller beyond the real socket's own backpressure: the writer thread is
the only place the delay is paid.

The port's copy of the JAX package's ``p2p/latency.py``.  The port's
``Transport`` wraps each raw socket in a ``DelayedSocket`` innermost, so
the delayed bytes are the AEAD plane's sealed frames, and arms it once the
handshake names the peer (``p2p/transport._upgrade``); ``node/node.py``
builds the transport's ``latency`` from ``p2p.zone``, ``p2p.zone_rtt_ms``
and ``p2p.peer_zones``.
"""

from __future__ import annotations

import collections
import socket
import threading
import time
from typing import Dict, Optional


class ZoneMatrix:
    """RTT table between named zones; symmetric lookup with a default."""

    def __init__(self, rtt_ms: Dict[str, Dict[str, float]], default_ms: float = 0.0):
        self.rtt_ms = rtt_ms or {}
        self.default_ms = default_ms

    def one_way_s(self, zone_a: str, zone_b: str) -> float:
        if not zone_a or not zone_b:
            return self.default_ms / 2e3
        row = self.rtt_ms.get(zone_a, {})
        rtt = row.get(zone_b)
        if rtt is None:
            rtt = self.rtt_ms.get(zone_b, {}).get(zone_a, self.default_ms)
        return float(rtt) / 2e3

    @staticmethod
    def from_config(d: dict, default_ms: float = 0.0) -> "ZoneMatrix":
        return ZoneMatrix(
            {str(a): {str(b): float(v) for b, v in row.items()}
             for a, row in (d or {}).items()},
            default_ms,
        )


class DelayedSocket:
    """Socket proxy that delays outbound bytes by a settable one-way
    latency.  Reads and socket controls pass straight through, so it can
    wrap a connection BEFORE the peer (and hence the delay) is known."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._delay_s = 0.0
        self._queue = collections.deque()  # (due_monotonic, bytes)
        self._queued_ever = False  # once armed, never take the fast path
        self._cv = threading.Condition()
        self._closed = False
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # -- latency control ---------------------------------------------------

    def set_delay(self, delay_s: float) -> None:
        with self._cv:
            self._delay_s = max(0.0, float(delay_s))

    @property
    def delay_s(self) -> float:
        return self._delay_s

    # -- socket interface used by SecretConnection / MConnection -----------

    def sendall(self, data: bytes) -> None:
        with self._cv:
            if self._err is not None:
                raise self._err
            if self._closed:
                raise OSError("socket closed")
            if self._delay_s <= 0.0 and not self._queued_ever:
                # fast path: emulation never armed, no reordering risk.
                # Once ANY byte has been queued the writer thread may still
                # hold a popped-but-unwritten chunk, so direct sendall could
                # reorder — from then on everything queues (ADVICE r4).
                pass
            else:
                self._queued_ever = True
                self._queue.append((time.monotonic() + self._delay_s, bytes(data)))
                self._cv.notify()
                return
        self._sock.sendall(data)

    def _writer(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                due, data = self._queue[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(timeout=due - now)
                    continue
                self._queue.popleft()
            try:
                self._sock.sendall(data)
            except OSError as e:
                with self._cv:
                    self._err = e
                    self._queue.clear()
                return

    def recv(self, n: int) -> bytes:
        return self._sock.recv(n)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()

    def getsockname(self):
        return self._sock.getsockname()

    def getpeername(self):
        return self._sock.getpeername()

    def setsockopt(self, *a):
        return self._sock.setsockopt(*a)

    def shutdown(self, how) -> None:
        try:
            self._sock.shutdown(how)
        except OSError:
            pass
