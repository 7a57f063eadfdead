"""Fault-injecting connection wrapper (reference: p2p/fuzz.go:14
FuzzedConnection) — randomly drops, delays, or errors reads/writes, for
resilience testing.  Wraps a raw socket before the secret-connection
upgrade, like the reference wraps net.Conn.

The port's copy of the JAX package's ``p2p/fuzz.py``: the same draws from
the ``rng`` it is given, so the same drops and delays for a seed.  It is a
``Transport`` ``conn_wrapper``; neither package builds it from the config.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass


@dataclass
class FuzzConnConfig:
    """Reference: config/config.go:897 FuzzConnConfig."""

    mode: str = "drop"  # "drop" | "delay"
    prob_drop_rw: float = 0.01
    prob_drop_conn: float = 0.0
    prob_sleep: float = 0.0
    max_delay_s: float = 0.3


class FuzzedConnection:
    """Duck-types the socket interface SecretConnection needs."""

    def __init__(self, sock, config: FuzzConnConfig | None = None, rng=None):
        self._sock = sock
        self.config = config or FuzzConnConfig()
        self._rng = rng or random.Random()
        self._dead = False

    def _fuzz(self) -> bool:
        """-> True when this op should be swallowed."""
        c = self.config
        if self._dead:
            raise OSError("fuzz: connection killed")
        if c.prob_drop_conn and self._rng.random() < c.prob_drop_conn:
            self._dead = True
            self._sock.close()
            raise OSError("fuzz: connection dropped")
        if c.prob_sleep and self._rng.random() < c.prob_sleep:
            time.sleep(self._rng.random() * c.max_delay_s)
        if c.mode == "drop" and self._rng.random() < c.prob_drop_rw:
            return True
        if c.mode == "delay" and self._rng.random() < c.prob_drop_rw:
            time.sleep(self._rng.random() * c.max_delay_s)
        return False

    def sendall(self, data: bytes) -> None:
        if self._fuzz():
            return  # silently dropped
        self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        if self._fuzz():
            # "drop" inbound data by reading and discarding it — the stream
            # desyncs and the AEAD layer detects corruption, like real loss
            self._sock.recv(n)
            return self._sock.recv(n)
        return self._sock.recv(n)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        self._sock.close()

    def shutdown(self, how) -> None:
        self._sock.shutdown(how)
