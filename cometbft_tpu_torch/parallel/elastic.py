"""Elastic mesh supervision: per-shard fault isolation for multi-card
verify.  The port of the JAX package's ``parallel/elastic.py``.

``parallel/mesh.py`` shards one verify batch over CUDA ordinals, one
launch of the Ed25519 kernel per shard; a sharded dispatch is only
production-grade when one sick card costs a LANE, not the fleet.  This
module is the torch-free brain of that guarantee, the mesh analog of
``crypto/backend_health`` + ``ops/supervisor``:

  * **per-device circuit breakers**: every stable ordinal gets a
    ``mesh_dev{N}`` breaker in the shared ``backend_health`` registry, so
    the backoff/half-open/re-promotion machinery (and the
    ``cometbft_crypto_backend_breaker_state{backend=}`` gauge) covers
    mesh lanes;
  * **shrink ladder**: a shard failure (raise, watchdog fire, malformed
    shard) records a breaker failure for THAT ordinal and re-dispatches
    once on the surviving devices (N -> N-1 -> ... -> 2); at width < 2
    the batch falls to the single-card chain (``ops/supervisor``).  Its
    floor is the port's rule: on the CPU the plain version, then the host
    reference; on a card the kernel, or ``BackendError``.  No torch or
    host tier answers a card's batch, so an infrastructure failure never
    becomes a wrong verdict and never hides the kernel;
  * **proactive exclusion**: an OPEN ``mesh_dev*`` breaker (or an
    ``ops/device_health`` down-probe for that ordinal, which trips the
    breaker out of band) removes the card from membership BEFORE the next
    dispatch; re-admission happens through a one-signature probe dispatch
    when the breaker's backoff elapses (HALF_OPEN), so a still-dead card
    costs one tiny probe, never a full production batch;
  * **deterministic fault seam**: ``set_fault_injector`` + ``FaultyDevice``
    raise/hang/wrong-shape/flap a CHOSEN ordinal (counter-based, so the
    sim's chip-death / mesh-brownout scenarios are deterministic per
    seed), and ``set_mesh_runner`` swaps the real per-shard device work
    for the host oracle exactly like ``ops/supervisor.set_device_runner``
    does for the single-card path.

Everything lands on the observability rails: ``mesh.reconfig`` black-box
events, ``mesh_shrink`` / ``mesh_restore`` / ``shard_watchdog_fire``
anomalies (``libs/tracing``), the ``cometbft_crypto_mesh_width`` gauge (via
``ops/dispatch_stats``), and ``mesh.shard`` spans keyed by stable ordinal.

Activation: ``configure()`` is called by the sim and tests (virtual
ordinals) or by ``ops/verify._maybe_enable_mesh`` (two or more CUDA
devices, or ``COMETBFT_TPU_MESH=1``), so a one-card machine keeps the
single-card path exactly.  Kill switch ``COMETBFT_TPU_MESH_SUPERVISOR=0``
restores the single-card chain bit for bit.

Free of torch imports at module level: metrics scrapes and the verify
scheduler's dispatcher read ``healthy_width()`` and must never be the
thing that initializes a device.  The device path is imported lazily
inside the dispatch (``parallel/mesh.dispatch_elastic``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from cometbft_tpu_torch.crypto import backend_health
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import dispatch_stats

logger = logging.getLogger("cometbft_tpu_torch.crypto")

BREAKER_PREFIX = "mesh_dev"


def breaker_name(ordinal: int) -> str:
    return f"{BREAKER_PREFIX}{int(ordinal)}"


def enabled() -> bool:
    """``COMETBFT_TPU_MESH_SUPERVISOR=0`` is the kill switch: the
    single-card chain comes back bit for bit."""
    return os.environ.get("COMETBFT_TPU_MESH_SUPERVISOR", "1") != "0"


class ShardFailure(backend_health.BackendError):
    """One shard of a mesh dispatch failed, attributable to a stable
    physical ordinal — the typed seam between ``parallel/mesh`` (which
    detects it at fetch time) and the shrink ladder here (which removes
    the ordinal and re-dispatches).  Always wraps the underlying error."""

    def __init__(self, ordinal: int, err: BaseException):
        super().__init__(f"mesh shard on ordinal {ordinal} failed: {err!r}")
        self.ordinal = int(ordinal)
        self.err = err


# -- membership state ---------------------------------------------------------

_LOCK = threading.Lock()
_ORDINALS: "Optional[tuple[int, ...]]" = None  # None = mesh inactive


def configure(ordinals: "Sequence[int]") -> None:
    """Declare the full mesh membership as stable ordinals.  The sim and
    tests pass virtual ordinals; production passes the ordinals
    ``parallel/mesh.register_devices`` gave the CUDA devices, from
    ``ops/verify``'s one-time probe.

    Per-ordinal health state recorded BEFORE configuration is folded in:
    a chip the watcher already marked down (a boot-time outage — the
    exact case proactive exclusion exists for) must not join membership
    just because its down-probe predated the mesh."""
    global _ORDINALS
    with _LOCK:
        _ORDINALS = tuple(int(o) for o in ordinals)
    _note_width(len(_ORDINALS))
    tracing.note_event(
        "mesh.reconfig", width=len(_ORDINALS), reason="configure"
    )
    from cometbft_tpu_torch.ops import device_health

    for key, up in device_health.snapshot().get("ordinals", {}).items():
        if not up:
            note_probe(int(key), False)


def clear() -> None:
    """Deactivate the mesh and drop the injector/runner seams (tests, sim
    teardown).  Breaker state lives in ``backend_health`` and is reset by
    its own ``reset()``."""
    global _ORDINALS, _RUNNER, _FAULT_INJECTOR
    with _LOCK:
        _ORDINALS = None
        _RUNNER = None
        _FAULT_INJECTOR = None
    _note_width(0)


def configured() -> bool:
    return _ORDINALS is not None


def total_width() -> int:
    """Full configured membership (breakers ignored)."""
    o = _ORDINALS
    return len(o) if o is not None else 0


def active() -> bool:
    """Whether supervised verify should take the mesh path at all: the
    kill switch is on and >= 2 devices are configured.  Membership can
    still shrink below 2 at dispatch time — that falls into the
    single-card chain per batch."""
    o = _ORDINALS
    return o is not None and len(o) >= 2 and enabled()


DEFAULT_MIN_BATCH = 256


def min_batch() -> int:
    """Smallest batch the supervised path routes through the mesh
    (``COMETBFT_TPU_MESH_MIN_BATCH``, default 256): a single gossip vote
    must not pay W launches and per-shard fetches for work one card's
    launch absorbs: sharding only wins once the batch outgrows a single
    card.  The sim and the tests set 1 (or call ``verify_elastic``
    directly) to exercise the machinery on tiny batches."""
    try:
        return int(
            os.environ.get("COMETBFT_TPU_MESH_MIN_BATCH", "")
            or DEFAULT_MIN_BATCH
        )
    except ValueError:
        return DEFAULT_MIN_BATCH


def healthy_width() -> int:
    """Devices a new dispatch would currently target (CLOSED breakers
    only — a read, never a probe).  0 when the mesh is inactive.  The
    verifysched dispatcher sizes its flush target from this, so bucket
    targeting follows the live mesh width through shrinks and restores."""
    o = _ORDINALS
    if o is None or not enabled():
        return 0
    reg = backend_health.registry()
    return sum(
        1
        for ordinal in o
        if reg.breaker(breaker_name(ordinal)).state == backend_health.CLOSED
    )


def healthy_ordinals() -> "list[int]":
    """Ordinals a new lane dispatch may target (CLOSED breakers only — a
    read, never a probe; the mesh-wide ``_membership`` walk owns probe
    slots).  Empty when the mesh is inactive.  torch-free: the verifysched
    dispatcher round-robins its in-flight flushes over this list."""
    o = _ORDINALS
    if o is None or not enabled():
        return []
    reg = backend_health.registry()
    return [
        ordinal
        for ordinal in o
        if reg.breaker(breaker_name(ordinal)).state == backend_health.CLOSED
    ]


def admit_ordinals() -> "list[int]":
    """Ordinals a NEW lane dispatch may target, probes included: the
    same membership walk a mesh-wide dispatch runs (``_membership``) —
    CLOSED breakers join directly, a HALF_OPEN ordinal spends its probe
    slot on the one-bucket re-admission probe and joins only if it
    passes.  This is what the pipelined verifysched dispatcher calls per
    flush: without it, lane round-robin would orbit the healthy subset
    forever and an excluded chip could never re-earn its lane.  Empty
    when the mesh is inactive."""
    if _ORDINALS is None or not enabled():
        return []
    return _membership(set())


def _note_width(w: int) -> None:
    # unconditionally (one locked int store): a change-detection cache
    # here would desync from dispatch_stats.reset(), leaving the gauge at
    # 0 for an active mesh until the width next happened to change
    dispatch_stats.record_mesh_width(w)


# -- fault injection + runner seams ------------------------------------------

_RUNNER: Optional[Callable] = None
_FAULT_INJECTOR: Optional[Callable] = None


def host_oracle_runner(ordinal, pubs, msgs, sigs, lanes) -> np.ndarray:
    """THE reference per-shard runner for ``set_mesh_runner`` — the host
    ZIP-215 oracle over one shard, padding lanes False.  Sim scenarios,
    the bench stage and the test suite all share this single definition
    (the "verdict-identical by construction" argument needs ONE oracle,
    not five copies); the first argument is ignored so it also serves as
    a single-card device-runner stand-in."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    out = np.zeros(int(lanes), dtype=bool)
    out[: len(pubs)] = [
        ref.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)
    ]
    return out


def set_mesh_runner(fn: Optional[Callable]) -> None:
    """Swap per-shard device work for ``fn(ordinal, pubs, msgs, sigs,
    lanes) -> (lanes,) bool`` (padding lanes False) — the mesh analog of
    ``ops/supervisor.set_device_runner``: the sim installs the host
    ZIP-215 oracle here on the CPU so the mesh scenarios never pay a
    plain-version verify per shard, while every elastic mechanism under
    test (breakers,
    membership, shrink ladder, probes, injector) runs unchanged above
    this seam.  ``None`` clears."""
    global _RUNNER
    _RUNNER = fn


def clear_mesh_runner() -> None:
    set_mesh_runner(None)


def set_fault_injector(fn: Optional[Callable]) -> None:
    """Install ``fn(ordinal, pubs, msgs, sigs) -> Optional[transform]``,
    consulted once per shard per dispatch (and per re-admission probe).
    It may raise (simulated shard error), sleep (simulated chip wedge —
    the shard watchdog fires), or return a callable applied to the
    shard's result (simulated corruption).  On the real device path the
    per-shard triples are not reconstructed at fetch time, so the
    injector is called with ``None`` batch args there; ``FaultyDevice``
    only keys on the ordinal.  ``None`` clears."""
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = fn


def clear_fault_injector() -> None:
    set_fault_injector(None)


class FaultyDevice:
    """Deterministic per-ordinal fault shim for ``set_fault_injector`` —
    the mesh-granular sibling of ``ops/supervisor.FaultyBackend``.

    Modes:
      * ``raise``       — every dispatch touching a chosen ordinal raises
        (chip death);
      * ``hang``        — sleep ``hang_s`` then raise (a shard watchdog
        shorter than ``hang_s`` fires first);
      * ``wrong_shape`` — the shard's result loses a lane (must read as
        infrastructure, never as verdicts);
      * ``flap``        — bursty per-ordinal: ``fail_n`` failing calls,
        then ``pass_n`` clean ones, repeating (counter-based per ordinal,
        so sim brownouts are deterministic).
    """

    def __init__(
        self,
        mode: str,
        ordinals: Sequence[int] = (0,),
        hang_s: float = 30.0,
        fail_n: int = 4,
        pass_n: int = 2,
    ):
        assert mode in ("raise", "hang", "wrong_shape", "flap"), mode
        self.mode = mode
        self.ordinals = tuple(int(o) for o in ordinals)
        self.hang_s = hang_s
        self.fail_n = fail_n
        self.pass_n = pass_n
        self.calls = 0
        self.faults = 0
        self._per_ordinal: dict = {}
        self._lock = threading.Lock()

    def __call__(self, ordinal, pubs, msgs, sigs):
        if int(ordinal) not in self.ordinals:
            return None
        with self._lock:
            self.calls += 1
            if self.mode == "flap":
                seq = self._per_ordinal.get(int(ordinal), 0)
                self._per_ordinal[int(ordinal)] = seq + 1
                cycle = self.fail_n + self.pass_n
                if seq % cycle >= self.fail_n:
                    return None  # pass phase of the burst cycle
            self.faults += 1
        if self.mode == "hang":
            time.sleep(self.hang_s)
            raise RuntimeError(
                f"injected fault: mesh ordinal {ordinal} wedge (unwedged)"
            )
        if self.mode == "wrong_shape":
            return lambda out: out[:-1]
        raise RuntimeError(
            f"injected fault: {self.mode} on mesh ordinal {ordinal}"
        )


# -- device-health integration ------------------------------------------------


def note_probe(ordinal: int, up: bool) -> None:
    """Fold an out-of-band health probe (``ops/device_health`` — the
    in-process prober or the chip watcher's status file) into mesh
    membership.  A DOWN probe trips the ordinal's breaker so the chip
    leaves the mesh BEFORE the next dispatch; re-admission rides the
    breaker's own half-open probe on backoff (an UP probe does not force
    re-admission — the probe dispatch is the arbiter)."""
    o = _ORDINALS
    if o is None or int(ordinal) not in o:
        return
    if up:
        return
    br = backend_health.registry().breaker(breaker_name(ordinal))
    # only a chip still IN membership (CLOSED breaker) is a new
    # exclusion; an already-excluded chip (OPEN, or HALF_OPEN awaiting
    # its probe) stays on the breaker's own backoff schedule — re-tripping
    # would double the backoff, overcount shrinks, and journal a
    # membership change that never happened
    if br.state == backend_health.CLOSED:
        br.trip(f"device_probe reported ordinal {ordinal} down")
        dispatch_stats.record_mesh_shrink()
        tracing.record_anomaly(
            "mesh_shrink", ordinal=int(ordinal), reason="probe-down"
        )
        tracing.note_event(
            "mesh.reconfig",
            width=healthy_width(),
            excluded=int(ordinal),
            reason="probe-down",
        )
        logger.warning(
            "mesh ordinal %d excluded: health probe reported it down",
            ordinal,
        )


# -- re-admission probe -------------------------------------------------------

_PROBE_BATCH: "Optional[tuple]" = None


def _probe_batch() -> tuple:
    """One deterministic known-good (pub, msg, sig) triple — the
    one-bucket probe dispatch a HALF_OPEN ordinal must pass to rejoin the
    mesh.  A wrong verdict on it is an infrastructure failure: the
    signature is valid by construction."""
    global _PROBE_BATCH
    if _PROBE_BATCH is None:
        from cometbft_tpu_torch.crypto import ed25519_ref as ref

        seed = b"\x5a" * 32
        msg = b"mesh-readmission-probe"
        _PROBE_BATCH = (
            [ref.pubkey_from_seed(seed)],
            [msg],
            [ref.sign(seed, msg)],
        )
    return _PROBE_BATCH


def _probe_ordinal(ordinal: int, br) -> bool:
    """Run the re-admission probe on one ordinal (the breaker's half-open
    slot is already claimed).  Success re-promotes the breaker and the
    chip rejoins membership; failure re-opens with doubled backoff."""
    reg = backend_health.registry()
    pubs, msgs, sigs = _probe_batch()
    try:
        with tracing.span("mesh.probe", device=int(ordinal)) as sp:
            out = np.asarray(_run_shard(ordinal, pubs, msgs, sigs, 1))
            if out.shape != (1,) or out.dtype != np.bool_:
                raise backend_health.BackendOutputError(
                    f"probe on mesh ordinal {ordinal} returned shape "
                    f"{out.shape} dtype {out.dtype}, want (1,) bool"
                )
            if not bool(out[0]):
                raise backend_health.BackendOutputError(
                    f"probe on mesh ordinal {ordinal} rejected a known-"
                    "good signature (device computing wrong results)"
                )
            sp.set(ok=True)
    except Exception as e:  # noqa: BLE001 — a failed probe re-opens
        br.record_failure(e)
        reg.record_demotion(breaker_name(ordinal))
        return False
    br.record_success()
    tracing.record_anomaly("mesh_restore", ordinal=int(ordinal))
    tracing.note_event(
        "mesh.reconfig",
        width=healthy_width(),
        restored=int(ordinal),
        reason="probe-pass",
    )
    dispatch_stats.record_mesh_restore()
    logger.info("mesh ordinal %d re-admitted (probe passed)", ordinal)
    return True


def _membership(banned: set) -> "list[int]":
    """Devices the NEXT dispatch targets: CLOSED breakers join directly;
    a HALF_OPEN breaker spends its probe slot on the one-bucket probe
    (never on a production batch) and joins only if it passes; OPEN (and
    locally banned) ordinals are excluded."""
    reg = backend_health.registry()
    out: "list[int]" = []
    for o in _ORDINALS or ():
        if o in banned:
            continue
        br = reg.breaker(breaker_name(o))
        st = br.state
        if st == backend_health.CLOSED:
            out.append(o)
        elif st == backend_health.HALF_OPEN and br.allow():
            if _probe_ordinal(o, br):
                out.append(o)
    return out


# -- per-shard execution ------------------------------------------------------


def _run_shard(ordinal: int, pubs, msgs, sigs, lanes: int) -> np.ndarray:
    """One shard's device work under the shard watchdog, with the fault
    injector consulted first (inside the watchdog worker, so a hanging
    injector exercises the real deadline path)."""
    from cometbft_tpu_torch.ops import supervisor

    inj = _FAULT_INJECTOR
    runner = _RUNNER

    def run():
        transform = (
            inj(ordinal, pubs, msgs, sigs) if inj is not None else None
        )
        if runner is not None:
            out = np.asarray(runner(ordinal, pubs, msgs, sigs, lanes))
        else:
            from cometbft_tpu_torch.parallel import mesh as pmesh

            out = pmesh.run_single_shard(ordinal, pubs, msgs, sigs, lanes)
        if transform is not None:
            out = transform(out)
        return out

    return supervisor.watchdog_call(
        run, backend=breaker_name(ordinal), note_anomaly=False
    )


def _attempt(devs: "list[int]", pubs, msgs, sigs) -> np.ndarray:
    """One elastic mesh attempt at the current width.  Raises
    ``ShardFailure`` (ordinal-attributed) on any shard problem; the
    caller shrinks and re-dispatches."""
    runner = _RUNNER
    if runner is None:
        from cometbft_tpu_torch.parallel import mesh as pmesh

        return pmesh.dispatch_elastic(
            devs, pubs, msgs, sigs, injector=_FAULT_INJECTOR
        )

    # runner seam (sim/tests): host-side sharding mirrors the mesh layout
    # — bucket-padded lanes split contiguously across the width, one
    # ``mesh.shard`` span per ordinal, padding lanes False
    from cometbft_tpu_torch.ops import verify as ov

    n = len(pubs)
    w = len(devs)
    lanes = ov.bucket_size(max(n, 1), ov._BUCKETS[0])
    lanes += (-lanes) % w
    per = lanes // w
    dispatch_stats.record_dispatch(lanes, n)
    seq = dispatch_stats.dispatch_count()
    bits = np.zeros(lanes, dtype=bool)
    t0 = time.perf_counter()
    with tracing.span(
        "verify.dispatch",
        tier="oracle",
        lanes=lanes,
        n=n,
        dispatch=seq,
        mesh=w,
    ):
        for i, o in enumerate(devs):
            lo = min(i * per, n)
            hi = min((i + 1) * per, n)
            ts = time.perf_counter()
            with tracing.span(
                "mesh.shard", device=o, lanes=per, tier="oracle"
            ) as sp:
                try:
                    out = np.asarray(
                        _run_shard(o, pubs[lo:hi], msgs[lo:hi],
                                   sigs[lo:hi], per)
                    )
                    if out.shape != (per,) or out.dtype != np.bool_:
                        raise backend_health.BackendOutputError(
                            f"mesh shard {o} returned shape {out.shape} "
                            f"dtype {out.dtype}, want ({per},) bool"
                        )
                except ShardFailure:
                    raise
                except Exception as e:
                    raise ShardFailure(o, e) from e
                sp.set(ok=int(out.sum()))
            bits[i * per : (i + 1) * per] = out
            dispatch_stats.record_shard_time(
                "oracle", o, per, time.perf_counter() - ts
            )
    dispatch_stats.record_dispatch_time(
        "oracle", lanes, time.perf_counter() - t0
    )
    return bits[:n]


# -- single-lane dispatch/fetch seam (in-flight pipeline) ---------------------


class _LaneHandle:
    """One lane's deferred shard work.  ``run_single_shard`` launches and
    waits for its shard, so the device work itself runs at ``fetch_lane``
    time on the scheduler's completion thread: the dispatch records the
    routing decision and returns at once, which is what lets the
    dispatcher keep K lanes busy concurrently."""

    __slots__ = ("ordinal", "pubs", "msgs", "sigs", "n", "lanes", "t0")

    def __init__(self, ordinal, pubs, msgs, sigs, n, lanes, t0):
        self.ordinal = ordinal
        self.pubs = pubs
        self.msgs = msgs
        self.sigs = sigs
        self.n = n
        self.lanes = lanes
        self.t0 = t0


def dispatch_lane(ordinal: int, pubs, msgs, sigs) -> _LaneHandle:
    """Route one batch at a single mesh lane without blocking on its
    verdict.  Pair with ``fetch_lane``; a failed/wedged lane surfaces
    there as ``ShardFailure`` so the fetcher can degrade THAT lane alone
    (``note_lane_failure``) and re-verify on the single-card chain."""
    from cometbft_tpu_torch.ops import verify as ov

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    n = len(pubs)
    lanes = ov.bucket_size(max(n, 1), ov._BUCKETS[0])
    dispatch_stats.record_dispatch(lanes, n)
    return _LaneHandle(
        int(ordinal), pubs, msgs, sigs, n, lanes, time.perf_counter()
    )


def fetch_lane(h: _LaneHandle) -> np.ndarray:
    """Resolve one lane dispatch: the shard runs under the shard watchdog
    with the fault injector consulted, exactly like a shard of a mesh-wide
    dispatch.  Returns (n,) bool accept bits; raises ``ShardFailure``
    (ordinal-attributed) on any infrastructure problem."""
    ts = time.perf_counter()
    with tracing.span(
        "mesh.shard", device=h.ordinal, lanes=h.lanes, tier="lane"
    ) as sp:
        try:
            out = np.asarray(
                _run_shard(h.ordinal, h.pubs, h.msgs, h.sigs, h.lanes)
            )
            if out.shape != (h.lanes,) or out.dtype != np.bool_:
                raise backend_health.BackendOutputError(
                    f"mesh lane {h.ordinal} returned shape {out.shape} "
                    f"dtype {out.dtype}, want ({h.lanes},) bool"
                )
        except ShardFailure:
            raise
        except Exception as e:
            raise ShardFailure(h.ordinal, e) from e
        sp.set(ok=int(out.sum()))
    dt = time.perf_counter() - ts
    dispatch_stats.record_shard_time("lane", h.ordinal, h.lanes, dt)
    dispatch_stats.record_dispatch_time("lane", h.lanes, dt)
    # a clean lane resets the ordinal's consecutive-failure count, exactly
    # like a participant in a clean mesh-wide dispatch
    backend_health.registry().breaker(
        breaker_name(h.ordinal)
    ).record_success()
    return out[: h.n]


def note_lane_failure(ordinal: int, err: BaseException, width: int) -> None:
    """Record one lane/shard failure on every observability rail: breaker
    failure + demotion for THAT ordinal, shrink counters, anomalies and
    the ``mesh.reconfig`` journal event.  Shared by the mesh-wide shrink
    ladder (``verify_elastic``) and the in-flight pipeline's per-lane
    degradation (``ops/supervisor.fetch_verify``).  ``width`` is the
    healthy width the NEXT dispatch will see (after this exclusion)."""
    name = breaker_name(ordinal)
    reg = backend_health.registry()
    if isinstance(err, backend_health.DispatchTimeoutError):
        tracing.record_anomaly(
            "shard_watchdog_fire", ordinal=int(ordinal), width=width
        )
    reg.breaker(name).record_failure(err)
    reg.record_demotion(name)
    dispatch_stats.record_mesh_shrink()
    tracing.record_anomaly(
        "mesh_shrink",
        ordinal=int(ordinal),
        width=width,
        error=type(err).__name__,
    )
    tracing.note_event(
        "mesh.reconfig",
        width=width,
        excluded=int(ordinal),
        reason="shard-failure",
    )
    logger.warning(
        "mesh shard on ordinal %d failed (%r); shrinking to %d devices",
        ordinal,
        err,
        width,
    )


# -- the elastic verify entry -------------------------------------------------


def verify_elastic(pubs, msgs, sigs, device=None) -> np.ndarray:
    """Mesh-sharded supervised verify with the shrink ladder: returns
    (n,) bool accept bits.  Every shard failure shrinks the mesh and
    re-dispatches; below width 2, or on a failure no ordinal is to blame
    for, the batch falls to the single-card chain on ``device`` (None:
    the card), which on the CPU cannot raise for infrastructure reasons
    and on a card answers with the kernel or raises ``BackendError``.
    ``banned`` is per-call: a failed ordinal is out of THIS batch at once
    whatever its breaker's threshold, while the breaker decides when
    future dispatches stop probing it.  A batch the mesh served counts
    under the chain's first tier (``cuda`` on a card, ``torch`` on the
    CPU) in ``ops/dispatch_stats``."""
    from cometbft_tpu_torch.ops import supervisor

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    reg = backend_health.registry()
    banned: set = set()
    while True:
        devs = _membership(banned)
        _note_width(len(devs))
        if len(devs) < 2:
            # the bottom of the ladder: the single-card chain takes the
            # whole batch
            return supervisor.verify_supervised(
                pubs, msgs, sigs, device, mesh=False
            )
        try:
            bits = _attempt(devs, pubs, msgs, sigs)
            # a clean dispatch resets every participant's consecutive-
            # failure count (flap bursts below the threshold must not
            # accumulate across healthy dispatches)
            for o in devs:
                reg.breaker(breaker_name(o)).record_success()
            supervisor._served(
                supervisor.device_chain(device)[0], len(pubs), device
            )
            return bits
        except ShardFailure as e:
            banned.add(e.ordinal)
            note_lane_failure(e.ordinal, e.err, len(devs) - 1)
            continue
        except Exception as e:  # noqa: BLE001 — non-attributable mesh
            # failure (a launch outside every shard): no ordinal to blame,
            # so the whole batch falls to the single-card chain
            logger.warning(
                "mesh dispatch failed without shard attribution (%r); "
                "falling back to the single-card chain for this batch",
                e,
            )
            return supervisor.verify_supervised(
                pubs, msgs, sigs, device, mesh=False
            )
