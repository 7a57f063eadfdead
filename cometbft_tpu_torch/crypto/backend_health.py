"""Crypto-backend health: circuit breakers + degradation bookkeeping.

The state half of the backend supervisor (``ops/supervisor.py`` is the
dispatch half): per-backend circuit breakers with exponential-backoff
half-open probes, plus the process-wide counters of the degradation
chain.  It imports neither torch nor CUDA: reading health must never be
the thing that initializes a device.

Failure taxonomy: everything recorded here is an INFRASTRUCTURE failure —
a dispatch that raised, wedged past the watchdog, or returned a malformed
result.  A signature that verifies False is a *verdict* and never touches
this module; conversely nothing recorded here may ever surface as a False
accept bit (the supervisor re-verifies on the next backend down instead).

Breaker state machine (per backend):

    CLOSED --(>= threshold consecutive failures)--> OPEN
    OPEN   --(backoff elapsed)--> HALF_OPEN (one probe dispatch allowed)
    HALF_OPEN --probe success--> CLOSED   (re-promotion; backoff resets)
    HALF_OPEN --probe failure--> OPEN     (backoff doubles, capped)

Environment, as in the JAX package:
  * ``COMETBFT_TPU_BREAKER_THRESHOLD``      consecutive failures to open
    (default 3);
  * ``COMETBFT_TPU_BREAKER_BACKOFF_MS``     initial open->half-open delay
    (default 1000);
  * ``COMETBFT_TPU_BREAKER_BACKOFF_MAX_MS`` backoff cap (default 30000).

The clock is injectable (``HealthRegistry.set_clock``) so tests drive the
backoff with a fake clock; the default is ``time.monotonic``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

DEFAULT_THRESHOLD = 3
DEFAULT_BACKOFF_MS = 1000.0
DEFAULT_BACKOFF_MAX_MS = 30000.0

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# the ed25519 chain's tiers (ops/supervisor.device_chain: the kernel and
# the plain version) share the "breaker_open" anomaly kind, as the JAX
# package's pallas/xla tiers do; any other breaker gets its own kind
_ED25519_CHAIN_TIERS = ("cuda", "torch")
# The breaker of the secp256k1 device path (``ops/supervisor``'s
# ``supervised_device_call``), beside the verify chain's ``cuda``/``torch``.
SECP_DEVICE = "secp_device"
# ... and of the SHA-256 Merkle tree kernel (``ops/sha256_tree``).
MERKLE_DEVICE = "merkle_device"
# ... and of the BLS12-381 G1 scalar-multiplication kernel
# (``crypto/batch.BlsBatchVerifier``; the JAX package's breaker name).
BLS_G1 = "bls_g1"
# ... and of the transport plane's kernels: ChaCha20-Poly1305
# (``ops/chacha_aead``) and the X25519 ladder (``ops/x25519_ladder``).
AEAD_DEVICE = "aead_device"
X25519_DEVICE = "x25519_device"


class BackendError(RuntimeError):
    """Base class for infrastructure failures the supervisor attributes to
    a backend (never to a signature)."""


class DispatchTimeoutError(BackendError):
    """A device dispatch wedged past the watchdog deadline."""


class BackendOutputError(BackendError):
    """A dispatch returned, but with a malformed result (wrong shape or
    dtype) — treated exactly like a raise: infrastructure, not verdict."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class CircuitBreaker:
    """Per-backend breaker; all methods are thread-safe.

    ``allow()`` is the admission check the supervisor runs before every
    dispatch: True in CLOSED, True exactly once per backoff window in
    HALF_OPEN (the probe), False in OPEN.  ``record_success`` /
    ``record_failure`` resolve the attempt.
    """

    def __init__(
        self,
        name: str,
        threshold: Optional[int] = None,
        backoff_s: Optional[float] = None,
        backoff_max_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.threshold = max(
            1,
            int(
                threshold
                if threshold is not None
                else _env_float("COMETBFT_TPU_BREAKER_THRESHOLD", DEFAULT_THRESHOLD)
            ),
        )
        self.backoff_initial_s = (
            backoff_s
            if backoff_s is not None
            else _env_float("COMETBFT_TPU_BREAKER_BACKOFF_MS", DEFAULT_BACKOFF_MS)
            / 1000.0
        )
        self.backoff_max_s = (
            backoff_max_s
            if backoff_max_s is not None
            else _env_float(
                "COMETBFT_TPU_BREAKER_BACKOFF_MAX_MS", DEFAULT_BACKOFF_MAX_MS
            )
            / 1000.0
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive
        self._backoff_s = self.backoff_initial_s
        self._open_until = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        # cumulative stats
        self._opens = 0
        self._probes = 0
        self._repromotions = 0
        self._failures_total = 0
        self._successes_total = 0
        self._last_error: str = ""

    # -- admission ---------------------------------------------------------

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self.clock()
            if self._state == OPEN:
                if now < self._open_until:
                    return False
                self._state = HALF_OPEN
                self._probe_inflight = True
                self._probe_started = now
                self._probes += 1
                return True
            # HALF_OPEN: one probe at a time — but a probe whose caller
            # died before resolving must not wedge the breaker forever:
            # past the cap window the probe slot is reclaimed
            if (
                self._probe_inflight
                and now - self._probe_started < self.backoff_max_s
            ):
                return False
            self._probe_inflight = True
            self._probe_started = now
            self._probes += 1
            return True

    # -- resolution --------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            repromoted = self._state != CLOSED
            self._state = CLOSED
            self._failures = 0
            self._backoff_s = self.backoff_initial_s
            self._probe_inflight = False
            self._successes_total += 1
            if repromoted:
                self._repromotions += 1
        if repromoted:
            # the close half of the breaker's state transitions: opens are
            # journaled through the anomaly path; re-promotions are not
            # anomalies, so they go straight to the black box (no-op
            # without a journal) — outside the breaker lock, like the open
            from cometbft_tpu_torch.libs import tracing

            tracing.note_event(
                "breaker_close",
                backend=self.name,
                repromotions=self._repromotions,
            )

    def _open_locked(self) -> bool:
        """The OPEN transition, under the lock — shared by organic
        failures (``record_failure``) and proactive trips (``trip``) so
        the two can never drift.  Returns True when this call NEWLY
        opened the breaker (an already-open, unelapsed window only has
        its backoff refreshed, without re-counting the open)."""
        already_open = self._state == OPEN and self.clock() < self._open_until
        self._state = OPEN
        if not already_open:
            self._opens += 1
        self._open_until = self.clock() + self._backoff_s
        # exponential backoff for the NEXT half-open window
        self._backoff_s = min(self._backoff_s * 2, self.backoff_max_s)
        return not already_open

    def record_failure(self, err: Optional[BaseException] = None) -> None:
        opened = False
        with self._lock:
            self._failures += 1
            self._failures_total += 1
            if err is not None:
                self._last_error = repr(err)[:200]
            was_probe = self._state == HALF_OPEN
            if was_probe or (
                self._state == CLOSED and self._failures >= self.threshold
            ):
                opened = self._open_locked()
            self._probe_inflight = False
        if opened:
            self._emit_open_anomaly()

    def trip(self, reason: str = "") -> None:
        """Force the breaker OPEN immediately — proactive exclusion: an
        out-of-band health signal reported the backend dead, so the next
        dispatch must not pay a failure to find out.  Counts as one
        failure; re-admission rides the normal half-open backoff."""
        with self._lock:
            self._failures += 1
            self._failures_total += 1
            if reason:
                self._last_error = reason[:200]
            opened = self._open_locked()
            self._probe_inflight = False
        if opened:
            self._emit_open_anomaly()

    def _emit_open_anomaly(self) -> None:
        # flight-recorder anomaly, recorded OUTSIDE the breaker lock: the
        # first open since reset dumps the span ring for postmortem.  The
        # ed25519 chain's tiers share one taxonomy kind (one chain, one
        # story); every OTHER breaker — secp_device, bls_g1, the tree and
        # transport kernels' — gets its own ``breaker_open_<name>`` kind,
        # so its first open still dumps after an ed25519-tier open latched
        # the shared kind.
        from cometbft_tpu_torch.libs import tracing

        kind = (
            "breaker_open"
            if self.name in _ED25519_CHAIN_TIERS
            else f"breaker_open_{self.name}"
        )
        tracing.record_anomaly(
            kind,
            backend=self.name,
            opens=self._opens,
            error=self._last_error,
        )

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            # surface the would-be transition so observers see HALF_OPEN as
            # soon as the backoff elapses, not only after the next allow()
            if self._state == OPEN and self.clock() >= self._open_until:
                return HALF_OPEN
            return self._state

    def stats(self) -> dict:
        with self._lock:
            # the same mapped view as ``state`` (elapsed-OPEN reads as
            # HALF_OPEN), so two readers never disagree about a tier
            st = self._state
            if st == OPEN and self.clock() >= self._open_until:
                st = HALF_OPEN
            return {
                "state": st,
                "state_code": _STATE_CODE[st],
                "consecutive_failures": self._failures,
                "failures_total": self._failures_total,
                "successes_total": self._successes_total,
                "opens": self._opens,
                "probes": self._probes,
                "repromotions": self._repromotions,
                "backoff_s": self._backoff_s,
                "last_error": self._last_error,
            }


class HealthRegistry:
    """All breakers + the cross-backend degradation counters, in one place
    so readers take one snapshot."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}
        self._counters = {
            "demotions": 0,  # a batch fell through to a lower backend
            "watchdog_fires": 0,  # dispatches abandoned past the deadline
            "fallback_signatures": 0,  # signatures verified on the host ref
            "quarantined": 0,  # poisoned inputs isolated by bisection
        }

    def breaker(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(name, clock=self._clock)
                self._breakers[name] = br
            return br

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Swap the time source (tests) for the registry AND every
        existing breaker; pass ``time.monotonic`` to restore."""
        with self._lock:
            self._clock = clock
            for br in self._breakers.values():
                br.clock = clock

    # -- counters ----------------------------------------------------------

    def record_demotion(self, backend: str) -> None:
        with self._lock:
            self._counters["demotions"] += 1

    def record_watchdog_fire(self, backend: str) -> None:
        with self._lock:
            self._counters["watchdog_fires"] += 1

    def record_fallback(self, n_signatures: int) -> None:
        with self._lock:
            self._counters["fallback_signatures"] += int(n_signatures)

    def record_quarantine(self, backend: str) -> None:
        with self._lock:
            self._counters["quarantined"] += 1

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            breakers = dict(self._breakers)
        out["breakers"] = {n: b.stats() for n, b in breakers.items()}
        # re-promotions live in each breaker's state machine (a half-open
        # probe passing); the cross-backend total is their sum
        out["repromotions"] = sum(
            s["repromotions"] for s in out["breakers"].values()
        )
        out["open_breakers"] = sum(
            1 for s in out["breakers"].values() if s["state"] == OPEN
        )
        out["half_open_breakers"] = sum(
            1 for s in out["breakers"].values() if s["state"] == HALF_OPEN
        )
        return out

    def breaker_states(self) -> dict:
        """{backend: state_code} for the labeled metrics gauge
        (0=closed, 1=half-open, 2=open)."""
        with self._lock:
            breakers = dict(self._breakers)
        return {n: _STATE_CODE[b.state] for n, b in breakers.items()}


_REGISTRY: Optional[HealthRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> HealthRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = HealthRegistry()
    return _REGISTRY


def reset() -> None:
    """Fresh registry (tests, between phases of a run); also restores the
    real clock and re-reads the environment on next breaker creation."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = None


def snapshot() -> dict:
    return registry().snapshot()
