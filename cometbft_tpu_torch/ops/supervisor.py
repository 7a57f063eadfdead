"""Backend supervisor for the verify hot path: watchdog + breakers + chain.

Every device dispatch of the commit-verification hot path routes through
this module (``ops/verify.verify_batch`` / ``verify_batches_overlapped`` /
``verify_segments`` / ``dispatch_segments`` / ``verify_pipelined``).  It
guarantees one property above all others: an INFRASTRUCTURE failure — a
raised CUDA error, a dispatch wedged past the watchdog deadline, a
malformed result array — is NEVER converted into a ``False`` accept bit,
and nothing of a failed dispatch reaches the signature cache.

The chain of device tiers (``device_chain``) is ``cuda`` (the Hopper
kernel) on a card and ``torch`` (the kernel's plain version) on the CPU.
What answers below it differs:

  * on the CPU, the host reference (``crypto/ed25519_ref.verify_zip215``,
    ``host_verify``) re-verifies a batch the torch tier could not serve;
  * on a card, nothing does: a card serves verdicts from its kernel alone,
    so a batch the cuda tier could not serve — it raised, wedged, returned
    a malformed result, or its breaker is open — raises ``BackendError``.
    The JAX package steps down to its XLA version and then the host; the
    port's rule is that a CUDA request is answered by the kernel or raises.

The per-backend circuit breakers in ``crypto/backend_health`` decide when
subsequent batches stop probing a dead device (open), when to probe it
again (half-open, exponential backoff), and when to re-promote (probe
passes).  Every tier implements the same ZIP-215 accept set.

No step is hidden: every batch records the tier that served it
(``last_tier()`` on the calling thread, ``tier`` on an in-flight handle,
and ``ops/dispatch_stats`` per tier), every failed dispatch logs a
WARNING, and a batch served below the chain's first tier logs one too.
Outside the chain, and raising as before: a failed build or load of a
library (loaded before any tier is tried), a failed known-answer
self-check, a CUDA request without a card.

Watchdog: device work runs on a fresh worker thread with a deadline
(``COMETBFT_TPU_DISPATCH_TIMEOUT_MS``, default 120000; 0 disables), so a
wedged kernel cannot block the consensus thread.  A kernel cannot be
cancelled: the worker is abandoned, and its flight keeps its page-locked
buffers and device tensors referenced until it unwedges.

Bisection: a *single poisoned input* that reproducibly kills the kernel
would otherwise demote the whole backend.  When a dispatch raises fast
(not a timeout) and the backend was healthy, the supervisor bisects the
batch on the same backend and quarantines the one input that keeps
failing; the backend stays in service.  On the CPU the host reference
verifies the quarantined input; on a card the batch raises
``PoisonedInputError`` naming it.  If more than one input "is poisoned"
the failure is systematic and the backend demotes.

Deterministic fault injection: ``set_fault_injector`` installs a hook
consulted inside every supervised dispatch; ``FaultyBackend`` is the
standard shim (modes: raise / hang / wrong_shape / flap).
``set_device_runner`` swaps the device tiers' execution for a stand-in
(tests), leaving every mechanism above it unchanged.

Kill switch: ``COMETBFT_TPU_SUPERVISOR=0`` restores the raw dispatch path.

The JAX package's spans and anomaly records (``libs/tracing``) are left
out until that module is ported (ROADMAP §1 item 10); so is its elastic
mesh routing (``parallel/elastic``, item 4).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from cometbft_tpu_torch.crypto import backend_health
from cometbft_tpu_torch.crypto.backend_health import (
    BackendError,
    BackendOutputError,
    DispatchTimeoutError,
)
from cometbft_tpu_torch.ops import dispatch_stats

logger = logging.getLogger("cometbft_tpu_torch.crypto")

DEFAULT_TIMEOUT_MS = 120000.0
HOST_BACKEND = "host"


def enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_SUPERVISOR", "1") != "0"


def dispatch_timeout_s() -> float:
    """Watchdog deadline in seconds; <= 0 disables (dispatch runs inline).
    The default is far above any legitimate dispatch: it exists to catch
    a *wedge*, not a slow kernel."""
    try:
        ms = float(
            os.environ.get("COMETBFT_TPU_DISPATCH_TIMEOUT_MS", "")
            or DEFAULT_TIMEOUT_MS
        )
    except ValueError:
        ms = DEFAULT_TIMEOUT_MS
    return ms / 1000.0


def _on_card(device) -> bool:
    """Whether ``device`` (``None``: the card) is a CUDA device.  Reads the
    device type only: it never touches CUDA."""
    import torch

    return torch.device("cuda" if device is None else device).type == "cuda"


def device_chain(device=None) -> tuple:
    """Device tiers to try, best first: ``("cuda",)`` on a card
    (``device=None`` means the card), ``("torch",)`` on the CPU.  Below
    the chain the host reference answers on the CPU and nothing on a card
    (``_below_chain``)."""
    return ("cuda",) if _on_card(device) else ("torch",)


class PoisonedInputError(BackendError):
    """On a card: bisection isolated one input of the batch that
    reproducibly fails the kernel (``index``, into the batch).  The
    kernel stays in service; the batch has no verdicts."""

    def __init__(self, index: int, n: int):
        super().__init__(
            f"input {index} of a batch of {n} fails the cuda tier every "
            f"time; quarantined (a card has no tier below the kernel)"
        )
        self.index = index


def active_backend(device=None) -> Optional[str]:
    """The device backend a new dispatch would currently target, or None
    when every device tier's breaker is open (fully degraded to host).
    Read-only: does NOT consume a half-open probe slot."""
    reg = backend_health.registry()
    for b in device_chain(device):
        if reg.breaker(b).state != backend_health.OPEN:
            return b
    return None


# -- which tier served --------------------------------------------------------

_TLS = threading.local()


def last_tier() -> Optional[str]:
    """The tier that served the last supervised verify resolved on this
    thread (``cuda``, ``torch`` or ``host``), or None."""
    return getattr(_TLS, "tier", None)


def _served(tier: str, n: int, dev) -> None:
    """Record the tier that answered a batch of ``n`` signatures; a tier
    below the chain's first is a step down, and says so."""
    _TLS.tier = tier
    dispatch_stats.record_tier(tier, n)
    first = device_chain(dev)[0]
    if tier != first:
        logger.warning(
            "verify batch of %d signatures served by the %s tier, not %s",
            n, tier, first,
        )


# -- device runner seam ------------------------------------------------------

_DEVICE_RUNNER: Optional[Callable] = None


def set_device_runner(fn: Optional[Callable]) -> None:
    """Swap the device tiers' execution for ``fn(backend, pubs, msgs,
    sigs, lanes) -> (lanes,) bool`` (padding lanes False).  Tests install
    a host-backed stand-in here: every supervisor mechanism under test
    (watchdog, breaker, fault injector, bisection, attribution) sits above
    this seam and runs unchanged.  ``None`` clears."""
    global _DEVICE_RUNNER
    _DEVICE_RUNNER = fn


def clear_device_runner() -> None:
    set_device_runner(None)


# -- fault injection ---------------------------------------------------------

_FAULT_INJECTOR: Optional[Callable] = None


def set_fault_injector(fn: Optional[Callable]) -> None:
    """Install ``fn(backend, pubs, msgs, sigs) -> Optional[transform]``,
    consulted inside every supervised device dispatch (on the watchdog
    worker, so a hanging injector exercises the real deadline path).  It
    may raise (simulated dispatch error), sleep (simulated wedge), or
    return a callable applied to the result array (simulated corruption,
    e.g. wrong shape).  ``None`` clears."""
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = fn


def clear_fault_injector() -> None:
    set_fault_injector(None)


class FaultyBackend:
    """Deterministic fault shim for ``set_fault_injector``.

    Modes:
      * ``raise``       — every matching dispatch raises immediately;
      * ``hang``        — sleep ``hang_s`` then raise (a watchdog shorter
        than ``hang_s`` fires first; longer sees a plain raise);
      * ``wrong_shape`` — dispatch succeeds but the result loses a lane
        (the supervisor must treat this as infrastructure, not verdicts);
      * ``flap``        — bursty: ``fail_n`` failing dispatches, then
        ``pass_n`` clean ones, repeating (counter-based, deterministic).

    ``backends`` restricts which chain tiers are affected (the host tier
    is never injectable — it is the refuge).
    """

    def __init__(
        self,
        mode: str,
        backends: Sequence[str] = ("cuda", "torch"),
        hang_s: float = 30.0,
        fail_n: int = 4,
        pass_n: int = 2,
    ):
        if mode not in ("raise", "hang", "wrong_shape", "flap"):
            raise ValueError(f"unknown fault mode: {mode}")
        self.mode = mode
        self.backends = tuple(backends)
        self.hang_s = hang_s
        self.fail_n = fail_n
        self.pass_n = pass_n
        self.calls = 0
        self.faults = 0
        self._lock = threading.Lock()

    def __call__(self, backend, pubs, msgs, sigs):
        if backend not in self.backends:
            return None
        with self._lock:
            seq = self.calls
            self.calls += 1
            if self.mode == "flap":
                cycle = self.fail_n + self.pass_n
                if seq % cycle >= self.fail_n:
                    return None  # pass phase of the burst cycle
            self.faults += 1
        if self.mode == "hang":
            time.sleep(self.hang_s)
            raise RuntimeError("injected fault: backend wedge (unwedged)")
        if self.mode == "wrong_shape":
            return lambda out: out[:-1]
        raise RuntimeError(f"injected fault: {self.mode} on {backend}")


# -- watchdog ----------------------------------------------------------------


class _Watchdog:
    """Per-call dispatch thread with a deadline.

    ``call(fn, timeout_s)`` runs ``fn`` on a fresh daemon thread and waits
    up to the deadline.  One thread PER CALL rather than a shared worker:
    queueing behind another caller's healthy-but-slow dispatch would count
    against this caller's deadline and demote a healthy backend.  Each
    worker names its CUDA device and stream itself (``ops/verify``): the
    current device and stream are per thread in PyTorch.

    On timeout the thread is abandoned — it finishes (or stays wedged) in
    the background and its result is discarded.  Abandoned threads are
    bounded by the circuit breaker: after ``threshold`` timeouts the
    backend is not dispatched until a half-open probe."""

    @staticmethod
    def _run(fn: Callable, box: dict, done: threading.Event) -> None:
        try:
            box["val"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["err"] = e
        done.set()

    def call(self, fn: Callable, timeout_s: float):
        done = threading.Event()
        box: dict = {}
        threading.Thread(
            target=self._run,
            args=(fn, box, done),
            name="crypto-dispatch",
            daemon=True,
        ).start()
        if not done.wait(timeout_s):
            raise DispatchTimeoutError(
                f"device dispatch exceeded {timeout_s:.3f}s watchdog deadline"
            )
        if "err" in box:
            raise box["err"]
        return box["val"]


_WATCHDOG = _Watchdog()


def watchdog_call(fn: Callable, timeout_s: Optional[float] = None, backend: str = ""):
    """Run ``fn`` under the dispatch watchdog: any device call a consensus
    thread must survive goes through here.  (The JAX package also records
    a "watchdog_fire" anomaly; that waits for libs/tracing.)"""
    t = dispatch_timeout_s() if timeout_s is None else timeout_s
    if not t or t <= 0:
        return fn()
    try:
        return _WATCHDOG.call(fn, t)
    except DispatchTimeoutError:
        backend_health.registry().record_watchdog_fire(backend)
        raise


def supervised_device_call(
    backend: str,
    fn: Callable,
    validate: Optional[Callable] = None,
    fallback_units: int = 0,
):
    """One breaker-gated, watchdogged device call — the shared protocol
    for single-tier device paths (secp256k1 and BLS G1 once ported,
    ROADMAP §1 items 8-9).  Returns the call's result, or None when the
    breaker is open or the call failed (the caller then takes its host
    fallback; ``fallback_units`` signatures are recorded as degraded host
    work in that case).  ``validate(result)`` may raise
    ``BackendOutputError`` to classify a malformed result as infra."""
    reg = backend_health.registry()
    br = reg.breaker(backend)
    if br.allow():
        try:
            out = watchdog_call(fn, backend=backend)
            if validate is not None:
                validate(out)
            br.record_success()
            return out
        except Exception as e:  # noqa: BLE001 — any device error demotes
            br.record_failure(e)
            reg.record_demotion(backend)
            logger.warning(
                "crypto backend %s call failed (%r); host fallback "
                "(breaker recorded the failure)",
                backend,
                e,
            )
    if fallback_units:
        reg.record_fallback(fallback_units)
    return None


# -- supervised ed25519 verification ----------------------------------------


def _validate_accept(accept, n: int) -> np.ndarray:
    """Wrong-shape/dtype output is an infrastructure failure (a kernel
    regression or memory corruption), never a verdict."""
    accept = np.asarray(accept)
    if accept.shape != (n,) or accept.dtype != np.bool_:
        raise BackendOutputError(
            f"backend returned shape {accept.shape} dtype {accept.dtype}, "
            f"want ({n},) bool"
        )
    return accept


def _lanes(backend: str, n: int) -> int:
    """Lanes a batch of ``n`` occupies on ``backend``: the kernel takes it
    unpadded, the plain version pads it to a bucket."""
    from cometbft_tpu_torch.ops import verify as ov

    return n if backend == "cuda" else ov.bucket_size(max(n, 1), ov._BUCKETS[0])


class _Ready:
    """A device-runner result, which exists as soon as it is dispatched."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = bits


def _launch(backend: str, pubs, msgs, sigs, dev):
    """The dispatch half of one device attempt, on a watchdog worker:
    (flight, transform).  The injector runs first, as a device fault
    would."""
    from cometbft_tpu_torch.ops import verify as ov

    inj = _FAULT_INJECTOR
    runner = _DEVICE_RUNNER
    transform = inj(backend, pubs, msgs, sigs) if inj is not None else None
    n = len(pubs)
    lanes = _lanes(backend, n)
    dispatch_stats.record_dispatch(lanes, n)
    if runner is not None:
        raw = _validate_accept(np.asarray(runner(backend, pubs, msgs, sigs, lanes)),
                               lanes)
        structural = np.fromiter(
            (len(p) == 32 and len(s) == 64 for p, s in zip(pubs, sigs)),
            dtype=bool, count=n,
        )
        return _Ready(raw[:n] & structural), transform
    return ov._dispatch(pubs, msgs, sigs, dev), transform


def _collect(flight, transform):
    """The fetch half, on a watchdog worker: the (n,) bits, transformed."""
    from cometbft_tpu_torch.ops import verify as ov

    bits = flight.bits if isinstance(flight, _Ready) else ov._fetch(flight)
    return transform(bits) if transform is not None else bits


def _attempt(backend: str, pubs, msgs, sigs, dev) -> np.ndarray:
    """One supervised dispatch on one device backend.  Raises
    ``DispatchTimeoutError`` / ``BackendOutputError`` / whatever the kernel
    raised; never returns partial results.  (The JAX package's
    "verify.dispatch" span goes here with libs/tracing.)"""
    n = len(pubs)
    t0 = time.perf_counter()
    try:
        bits = watchdog_call(
            lambda: _collect(*_launch(backend, pubs, msgs, sigs, dev)),
            backend=backend,
        )
    finally:
        dispatch_stats.record_dispatch_time(
            backend, _lanes(backend, n), time.perf_counter() - t0
        )
    return _validate_accept(bits, n)


def host_verify(pubs, msgs, sigs) -> np.ndarray:
    """The CPU's terminal tier: pure-host ZIP-215 reference verification —
    bitwise the accept set of the device tiers (it is their differential
    oracle), with no device to fail.  Orders of magnitude slower per
    signature; the breakers' half-open probes exist to leave it again.
    Never reached for a card (``_below_chain``)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    n = len(pubs)
    if n:
        backend_health.registry().record_fallback(n)
    # (the JAX package's "supervisor.host_fallback" span goes here)
    _TLS.tier = HOST_BACKEND
    dispatch_stats.record_tier(HOST_BACKEND, n)
    logger.warning("verify batch of %d signatures served by the host tier", n)
    return np.fromiter(
        (ref.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)),
        dtype=bool,
        count=n,
    )


def _below_chain(pubs, msgs, sigs, dev, cause=None) -> np.ndarray:
    """What answers a batch once every device tier failed it or is open:
    the host reference on the CPU.  On a card nothing does — its verdicts
    come from the kernel or not at all — so the batch raises
    ``BackendError``, chained to the tier's last failure."""
    if not _on_card(dev):
        return host_verify(pubs, msgs, sigs)
    _TLS.tier = None
    why = "its breaker is open" if cause is None else f"it failed: {cause!r}"
    raise BackendError(
        f"the cuda tier did not verify a batch of {len(pubs)} signatures "
        f"({why}); a card has no tier below the kernel"
    ) from cause


class _GiveUp(Exception):
    pass


def _bisect_quarantine(
    backend: str, pubs: list, msgs: list, sigs: list, dev
) -> Optional[tuple]:
    """Isolate a single poisoned input that reproducibly kills the kernel.

    Recursively re-dispatches halves on the SAME backend: halves that
    succeed keep their device verdicts; the subtree that keeps failing
    narrows to one index, which is quarantined.  On the CPU the host
    reference verifies it (its verdict may well be True: killing the
    kernel is not evidence against the signature); on a card its bit is
    left False and the caller raises ``PoisonedInputError`` instead of
    returning the bits.  Returns (bits, quarantined indices: none or
    one).  Gives up (returns None -> normal demotion) on a second
    poisoned index (systematic failure), on a timeout (too slow to bisect
    a wedge), or past the dispatch budget."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    n = len(pubs)
    reg = backend_health.registry()
    budget = [2 * max(1, n.bit_length()) + 8]
    quarantined: list = []

    def solve(lo: int, hi: int) -> list:
        if budget[0] <= 0:
            raise _GiveUp
        budget[0] -= 1
        try:
            return list(
                _attempt(backend, pubs[lo:hi], msgs[lo:hi], sigs[lo:hi], dev)
            )
        except DispatchTimeoutError:
            raise _GiveUp
        except _GiveUp:
            raise
        except Exception:
            if hi - lo == 1:
                quarantined.append(lo)
                if len(quarantined) > 1:
                    raise _GiveUp
                if _on_card(dev):
                    return [False]  # never returned: the batch raises
                return [bool(ref.verify_zip215(pubs[lo], msgs[lo], sigs[lo]))]
            mid = (lo + hi) // 2
            return solve(lo, mid) + solve(mid, hi)

    try:
        # (the JAX package's "supervisor.bisect" span goes here)
        bits = np.asarray(solve(0, n), dtype=bool)
    except _GiveUp:
        return None
    # record only on commit: an abandoned bisect (systematic failure) must
    # not masquerade as a quarantine in the counters
    if quarantined:
        reg.record_quarantine(backend)
        # (the JAX package's "quarantine" anomaly goes here)
        if _on_card(dev):
            logger.warning(
                "crypto backend %s: quarantined input %d of %d (kills the "
                "kernel); the batch raises", backend, quarantined[0], n,
            )
        else:
            reg.record_fallback(1)
            dispatch_stats.record_tier(HOST_BACKEND, 1)
            logger.warning(
                "crypto backend %s: quarantined a poisoned input "
                "(kills the kernel; host-verified instead)",
                backend,
            )
    return bits, quarantined


def _demote(backend: str, err: BaseException, what: str) -> None:
    """A device tier failed a batch: count it against its breaker and the
    demotions, and say so."""
    reg = backend_health.registry()
    reg.breaker(backend).record_failure(err)
    reg.record_demotion(backend)
    logger.warning(
        "crypto backend %s %s failed (%r)", backend, what, err,
    )


def _load_libraries(dev) -> None:
    """Build or load the host library and, on a card, the kernel before
    any tier is tried: a failed build or load is a fault of the
    installation, not of a tier, and raises instead of stepping down."""
    from cometbft_tpu_torch import native

    native.lib()
    if dev.type == "cuda":
        from cometbft_tpu_torch.ops import cuda_verify

        cuda_verify._launcher()


def verify_supervised(
    pubs, msgs, sigs, device=None, skip: tuple = (), cause=None
) -> np.ndarray:
    """The supervised ed25519 batch verify: walk the chain, return (n,)
    bool accept bits.  On the CPU it cannot raise for infrastructure
    reasons — the host tier always answers.  On a card a batch the kernel
    did not serve raises ``BackendError`` (``PoisonedInputError`` for a
    quarantined input); so does a CUDA request without a card, before any
    tier is tried.  ``skip`` names tiers that already failed this batch,
    ``cause`` their failure."""
    from cometbft_tpu_torch.ops import verify as ov

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    dev = ov.resolve_device(device)
    _load_libraries(dev)
    n = len(pubs)
    reg = backend_health.registry()
    err = cause
    # (the JAX package's "verify.batch" span, naming the tier, covers this)
    for backend in device_chain(dev):
        if backend in skip:
            continue
        br = reg.breaker(backend)
        if not br.allow():
            continue
        try:
            bits = _attempt(backend, pubs, msgs, sigs, dev)
        except Exception as e:  # noqa: BLE001 — any dispatch error demotes
            if (
                n >= 2
                and not isinstance(e, DispatchTimeoutError)
                and br.stats()["consecutive_failures"] == 0
            ):
                try:
                    solved = _bisect_quarantine(backend, pubs, msgs, sigs, dev)
                except Exception:  # noqa: BLE001 — bisect is best-effort
                    solved = None
                if solved is not None:
                    bits, quarantined = solved
                    br.record_success()
                    if quarantined and _on_card(dev):
                        _TLS.tier = None
                        raise PoisonedInputError(quarantined[0], n) from e
                    _served(backend, n - len(quarantined), dev)
                    return bits
            _demote(backend, e, "dispatch")
            err = e
            continue
        br.record_success()
        _served(backend, n, dev)
        return bits
    return _below_chain(pubs, msgs, sigs, dev, err)


def _first_allowed(dev) -> Optional[str]:
    reg = backend_health.registry()
    for b in device_chain(dev):
        if reg.breaker(b).allow():
            return b
    return None


def verify_batches_overlapped_supervised(work, device=None, inflight: int = 2) -> list:
    """Supervised ``ops.verify.verify_batches_overlapped``: the same
    host/device overlap when healthy (at most ``inflight`` batches
    dispatched and not fetched, fetched in order), but every dispatch AND
    fetch is watchdogged, and a failure re-runs the affected batch below
    the failed tier (the host on the CPU; on a card it raises) — later
    batches in the window skip the failed tier."""
    from cometbft_tpu_torch.ops import verify as ov

    work = [(list(p), list(m), list(s)) for p, m, s in work]
    if not work:
        return []
    dev = ov.resolve_device(device)
    _load_libraries(dev)
    backend = _first_allowed(dev)
    if backend is None:
        # fully degraded: per-batch host verification on the CPU, no
        # device to overlap; on a card the first batch raises
        return [_below_chain(*w, dev) for w in work]
    br = backend_health.registry().breaker(backend)
    depth = max(int(inflight), 1)
    out: list = [None] * len(work)
    pending: deque = deque()  # (index, flight or None, transform)
    dead = wedged = False
    failure = None  # the tier's failure, for the batches re-verified below

    def fetch_oldest() -> None:
        nonlocal wedged, failure
        i, flight, transform = pending.popleft()
        w = work[i]
        if flight is None or wedged:
            # wedged: once one fetch times out the device is stuck, and
            # every remaining fetch of the window would pay the full
            # deadline for the same answer
            out[i] = verify_supervised(*w, dev, skip=(backend,), cause=failure)
            return
        n = len(w[0])
        try:
            # (the JAX package's "verify.fetch" span goes here)
            t0 = time.perf_counter()
            got = watchdog_call(lambda: _collect(flight, transform), backend=backend)
            dispatch_stats.record_dispatch_time(
                backend, _lanes(backend, n), time.perf_counter() - t0
            )
            bits = _validate_accept(got, n)
        except Exception as e:  # noqa: BLE001 — fetch failure demotes
            _demote(backend, e, "overlapped fetch")
            wedged = wedged or isinstance(e, DispatchTimeoutError)
            failure = e
            out[i] = verify_supervised(*w, dev, skip=(backend,), cause=e)
            return
        br.record_success()
        _served(backend, n, dev)
        out[i] = bits

    for i, w in enumerate(work):
        while len(pending) >= depth:
            fetch_oldest()
        if dead:
            pending.append((i, None, None))
            continue
        try:
            # (the JAX package's "verify.dispatch" span goes here)
            flight, transform = watchdog_call(
                lambda w=w: _launch(backend, *w, dev), backend=backend
            )
        except Exception as e:  # noqa: BLE001 — dispatch failure demotes
            _demote(backend, e, "overlapped dispatch")
            dead = True
            failure = e
            pending.append((i, None, None))
            continue
        pending.append((i, flight, transform))
    while pending:
        fetch_oldest()
    return out


# -- in-flight dispatch/fetch seam --------------------------------------------
#
# The async half of ``verify_supervised``: ``dispatch_verify`` routes one
# batch to the chain WITHOUT blocking on its verdict, and ``fetch_verify``
# resolves it later (the verify scheduler's completion thread,
# ``ops.verify.fetch_segments``).  Every failure mode at fetch time
# degrades exactly like the synchronous path: the failed backend is
# demoted and the batch re-verifies below it (the host floor on the CPU,
# ``BackendError`` on a card), so the bits stay definitive verdicts.


class _InflightVerify:
    """One supervised verify in flight between dispatch and fetch.

    Kinds:
      * ``chip``       — a real dispatch already on the device (the
        ``cuda`` tier's launch; the ``torch`` tier's packed batch, which
        runs at fetch) plus the injector's transform;
      * ``deferred``   — the device-runner seam is installed (tests): the
        whole ``_attempt`` runs at fetch, so the injector's raise/hang
        happen where a real device fault would surface;
      * ``supervised`` — fully degraded at dispatch time (or the dispatch
        itself failed): fetch walks ``verify_supervised`` with ``skip``.

    ``tier`` is the tier that served it, set at fetch.
    """

    __slots__ = (
        "kind", "pubs", "msgs", "sigs", "n", "lanes", "backend", "dev",
        "flight", "transform", "skip", "error", "tier",
    )

    def __init__(self, pubs, msgs, sigs, dev):
        self.kind = "supervised"
        self.pubs = pubs
        self.msgs = msgs
        self.sigs = sigs
        self.n = len(pubs)
        self.lanes = 0
        self.backend = None
        self.dev = dev
        self.flight = None
        self.transform = None
        self.skip = ()
        self.error = None  # the failure of the tier in ``skip``
        self.tier = None


def dispatch_verify(pubs, msgs, sigs, lane=None, device=None) -> _InflightVerify:
    """Route one batch without blocking on its verdict: the first
    breaker-allowed device backend takes it.  ``lane`` pins a mesh
    ordinal in the JAX package; with no mesh (ROADMAP §1 item 4) the chain
    takes the batch, as there when the mesh is inactive.  Pair every
    handle with exactly one ``fetch_verify`` — in-flight depth accounting
    balances on fetch."""
    from cometbft_tpu_torch.ops import verify as ov

    del lane  # no elastic mesh: the single-card chain
    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    h = _InflightVerify(pubs, msgs, sigs, ov.resolve_device(device))
    _load_libraries(h.dev)
    n = h.n
    dispatch_stats.record_inflight_enter()
    try:
        backend = _first_allowed(h.dev)
        if backend is None:
            # fully degraded: fetch walks the chain (on the CPU the host
            # answers; on a card the fetch raises)
            dispatch_stats.record_lane_dispatch(HOST_BACKEND, max(n, 1), n)
            return h
        h.backend = backend
        h.lanes = _lanes(backend, n)
        if _DEVICE_RUNNER is not None:
            h.kind = "deferred"
            dispatch_stats.record_lane_dispatch(backend, h.lanes, n)
            return h
        try:
            # (the JAX package's "verify.dispatch" span goes here)
            h.flight, h.transform = watchdog_call(
                lambda: _launch(backend, pubs, msgs, sigs, h.dev), backend=backend
            )
        except Exception as e:  # noqa: BLE001 — dispatch failure demotes;
            # the batch re-verifies below it at fetch time (on a card: raises)
            _demote(backend, e, "pipelined dispatch")
            h.backend = None
            h.skip, h.error = (backend,), e
            return h
        h.kind = "chip"
        dispatch_stats.record_lane_dispatch(backend, h.lanes, n)
        return h
    except BaseException:
        # a dispatch that never produced a handle must not leak depth
        dispatch_stats.record_inflight_exit()
        raise


def fetch_verify(h: _InflightVerify) -> np.ndarray:
    """Resolve one in-flight verify: (n,) bool accept bits.  Every failure
    mode demotes the failed backend and re-verifies the batch below it: on
    the CPU the host ZIP-215 oracle answers, so it cannot raise for
    infrastructure reasons; on a card it raises ``BackendError``."""
    try:
        bits = None
        if h.kind == "deferred":
            try:
                bits = _attempt(h.backend, h.pubs, h.msgs, h.sigs, h.dev)
            except Exception as e:  # noqa: BLE001 — any dispatch error
                _demote(h.backend, e, "pipelined verify")
                h.skip, h.error = (h.backend,), e
        elif h.kind == "chip":
            try:
                # (the JAX package's "verify.fetch" span goes here)
                t0 = time.perf_counter()
                got = watchdog_call(
                    lambda: _collect(h.flight, h.transform), backend=h.backend
                )
                dispatch_stats.record_dispatch_time(
                    h.backend, h.lanes, time.perf_counter() - t0
                )
                bits = _validate_accept(got, h.n)
            except Exception as e:  # noqa: BLE001 — fetch failure demotes
                _demote(h.backend, e, "pipelined fetch")
                h.skip, h.error = (h.backend,), e
        if bits is not None:
            backend_health.registry().breaker(h.backend).record_success()
            _served(h.backend, h.n, h.dev)
        else:
            bits = verify_supervised(
                h.pubs, h.msgs, h.sigs, h.dev, skip=h.skip, cause=h.error
            )
        h.tier = last_tier()
        return bits
    finally:
        dispatch_stats.record_inflight_exit()
