"""Process-wide disk-fault supervisor: the durable-IO seam.

The supervisor chain (docs/backend-supervisor.md) guarantees that COMPUTE
infrastructure failures never become wrong verdicts; this module extends
the same invariant to the STORAGE plane.  Every durable write / fsync /
rename in the codebase — the consensus WAL, the privval last-sign state,
the SqliteKV chain store, the black-box journal, the exec cache, the
indexer, chip-watch status files — routes through one guarded seam that
applies:

  * a deterministic IO fault injector (``FaultPlan``: ENOSPC / EIO /
    torn-write-then-crash / slow-disk latency, count-windowed rules the
    sim scripts drive on the virtual clock — same-seed runs consume the
    same rule windows on the same operations, byte-deterministically);

  * an explicit per-surface durability policy:

      - **fail-stop** surfaces (``wal``, ``privval``, ``state``): an IO
        failure raises a typed ``StorageFatal`` that halts the node
        BEFORE it can vote or commit on unpersisted state — equivocation
        is the one fault BFT cannot forgive, so a validator that cannot
        persist its sign-state or WAL must stop, not guess.  The failure
        is journaled as a ``disk_fatal`` anomaly with surface / op /
        errno attribution.

      - **degradable** surfaces (``blackbox``, ``exec_cache``,
        ``indexer``, ``status``): an IO failure degrades to counted
        drops — transient errors (EIO and friends) get a bounded
        exponential-backoff retry first — and never touches consensus.
        The original ``OSError`` is re-raised after the retry budget so
        each surface's existing local degrade handler (the blackbox
        writer's drop counter, the exec cache's ``unwritable`` status)
        keeps working; the guard adds injection, retries, per-surface
        stats (``libs/storage_stats``) and a ``disk_fault`` anomaly.

Kill switch: ``COMETBFT_TPU_DISKGUARD=0`` makes every guard a direct
pass-through (no injection, no retries, no stats, no boot-time WAL tail
repair) — current behavior restored bit-for-bit.

Imports no torch: the storage plane must keep its safety argument
exactly when the accelerator stack is the thing that fell over.  The
port's copy of the JAX package's ``libs/diskguard.py``; in the port the
block and state stores (``store/kv.SqliteKV``, surface ``state``) are
its callers so far.
"""

from __future__ import annotations

import errno as _errno
import os
import tempfile
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from cometbft_tpu_torch.libs import storage_stats

# -- surfaces & policy --------------------------------------------------------

FAIL_STOP = "fail-stop"
DEGRADE = "degrade"

#: surface -> durability policy (docs/storage-robustness.md).  Unknown
#: surfaces default to DEGRADE: a new subsystem must opt IN to halting
#: the node, never get it by accident.
POLICIES: dict = {
    "wal": FAIL_STOP,       # consensus replay correctness
    "privval": FAIL_STOP,   # double-sign protection
    "state": FAIL_STOP,     # block/state store (commit durability)
    "blackbox": DEGRADE,    # forensics must never be a second failure
    "exec_cache": DEGRADE,  # losing the cache loses an optimization
    "indexer": DEGRADE,     # query-side convenience, not consensus
    "status": DEGRADE,      # chip-watch / operator status files
    "light": DEGRADE,       # light-client trust cache (re-verifiable)
}

#: errnos treated as transient on degradable surfaces (retried with
#: exponential backoff before the op degrades to a counted drop).
#: ENOSPC is deliberately absent — a full disk does not heal in
#: milliseconds, retrying it only burns the budget.
TRANSIENT_ERRNOS = frozenset(
    (_errno.EIO, _errno.EAGAIN, _errno.EINTR, _errno.EBUSY)
)

DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_MS = 1.0
DEFAULT_BACKOFF_MAX_MS = 50.0


class StorageFatal(OSError):
    """An IO failure on a fail-stop surface.  Whoever catches this must
    HALT the node — the persistent state backing consensus safety can no
    longer be trusted to advance."""

    def __init__(self, surface: str, op: str, err: "BaseException | str"):
        self.surface = surface
        self.op = op
        self.err = err
        self.io_errno = getattr(err, "errno", None)
        super().__init__(
            f"storage fatal on {surface}/{op}: {err!r}"
        )


def enabled() -> bool:
    """``COMETBFT_TPU_DISKGUARD=0`` is the kill switch; default on.
    With it off every guard is a direct pass-through — no injection, no
    retry, no stats, no boot-time repair — bit-for-bit the pre-diskguard
    behavior."""
    return os.environ.get("COMETBFT_TPU_DISKGUARD", "1") != "0"


def policy(surface: str) -> str:
    return POLICIES.get(surface, DEGRADE)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def retries() -> int:
    return max(int(_env_float("COMETBFT_TPU_DISKGUARD_RETRIES", DEFAULT_RETRIES)), 0)


def _backoff_s(attempt: int) -> float:
    base = _env_float("COMETBFT_TPU_DISKGUARD_BACKOFF_MS", DEFAULT_BACKOFF_MS)
    cap = _env_float(
        "COMETBFT_TPU_DISKGUARD_BACKOFF_MAX_MS", DEFAULT_BACKOFF_MAX_MS
    )
    return min(base * (2.0 ** attempt), cap) / 1000.0


# the retry backoff sleeper: wall sleep by default; the sim swaps in a
# no-op so retries stay a pure function of the injector's count windows
# instead of coupling virtual time to wall time
_SLEEPER: "list[Callable[[float], None]]" = [_time.sleep]


def set_sleeper(fn: Optional[Callable[[float], None]]) -> None:
    _SLEEPER[0] = fn if fn is not None else _time.sleep


def sleep_backoff(attempt: int) -> None:
    """One step of the seam's bounded exponential backoff, through the
    sim-swappable sleeper — for surface-local retry loops (e.g. sqlite
    lock contention) that back off like the guard does."""
    _SLEEPER[0](_backoff_s(attempt))


# -- deterministic fault injection -------------------------------------------

KIND_ERRNO = "errno"
KIND_TORN = "torn"
KIND_LATENCY = "latency"


@dataclass
class FaultRule:
    """One scripted fault window.  The rule counts every guarded
    operation matching (surface, op, path_substr); it FIRES while the
    match ordinal lies in ``[begin, begin + count)``.  Count-windowed
    matching is what makes injection deterministic: the sequence of
    guarded operations is a pure function of the seed, so the same runs
    trip the same faults regardless of wall-clock scheduling."""

    surface: Optional[str] = None      # None matches every surface
    op: Optional[str] = None           # None matches every op
    path_substr: Optional[str] = None  # substring of the target path
    kind: str = KIND_ERRNO
    err: int = _errno.EIO
    begin: int = 0
    count: float = float("inf")
    latency_s: float = 0.0
    torn_keep: int = 8                 # bytes of the payload that land
    seen: int = field(default=0, compare=False)

    def matches(self, surface: str, op: str, path: Optional[str]) -> bool:
        if self.surface is not None and self.surface != surface:
            return False
        if self.op is not None and self.op != op:
            return False
        if self.path_substr is not None and (
            path is None or self.path_substr not in path
        ):
            return False
        return True


class FaultPlan:
    """A live set of fault rules.  Thread-safe; scenario actions add and
    remove rules at scripted virtual times."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: "list[FaultRule]" = []

    def add(self, **kw) -> FaultRule:
        rule = FaultRule(**kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove(self, rule: FaultRule) -> None:
        with self._lock:
            try:
                self._rules.remove(rule)
            except ValueError:
                pass

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def check(
        self, surface: str, op: str, path: Optional[str]
    ) -> Optional[FaultRule]:
        """Advance every matching rule's ordinal; return the first rule
        whose window covers this operation (or None)."""
        with self._lock:
            fired = None
            for rule in self._rules:
                if not rule.matches(surface, op, path):
                    continue
                idx = rule.seen
                rule.seen += 1
                if fired is None and rule.begin <= idx < rule.begin + rule.count:
                    fired = rule
            return fired


_PLAN: "list[Optional[FaultPlan]]" = [None]


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    prev = _PLAN[0]
    _PLAN[0] = plan
    return prev


def get_fault_plan() -> Optional[FaultPlan]:
    return _PLAN[0]


def clear_fault_plan() -> None:
    _PLAN[0] = None


# -- anomaly reporting ----------------------------------------------------------


def _anomaly(kind: str, **attrs) -> None:
    """Where the JAX package records a flight-recorder anomaly
    (``libs/tracing.record_anomaly``, latched against re-entry from the
    black-box journal).  The port's ``libs/tracing`` waits for ROADMAP
    "Node assembly" stage (d); until then a fault is seen in
    ``libs/storage_stats`` and in the exception the guard raises."""


def _err_attrs(err: BaseException) -> dict:
    code = getattr(err, "errno", None)
    return {
        "errno": code if code is not None else -1,
        "error": type(err).__name__,
    }


# -- the guard ----------------------------------------------------------------


def guard(
    surface: str,
    op: str,
    thunk: Callable[[], object],
    path: Optional[str] = None,
    exc_types: tuple = (OSError,),
    tear: Optional[Callable[[FaultRule], None]] = None,
):
    """Run one durable-IO operation under the disk-fault policy.

    Fail-stop surfaces raise ``StorageFatal`` on the first failure;
    degradable surfaces retry transient errors with bounded exponential
    backoff, then record a counted drop + ``disk_fault`` anomaly and
    re-raise the original error for the caller's local degrade handler.
    ``tear`` lets byte-writers land a torn prefix before the injected
    crash (``file_write`` wires it; thunk-level callers skip it)."""
    if not enabled():
        return thunk()
    degrade = policy(surface) == DEGRADE
    budget = retries() if degrade else 0
    attempt = 0
    while True:
        err: Optional[BaseException] = None
        torn = False
        plan = _PLAN[0]
        rule = plan.check(surface, op, path) if plan is not None else None
        if rule is not None:
            if rule.kind == KIND_LATENCY:
                storage_stats.record_injected(surface)
                _SLEEPER[0](rule.latency_s)
                rule = None  # slow, not broken: the op itself proceeds
            elif rule.kind == KIND_TORN:
                storage_stats.record_injected(surface)
                if tear is not None:
                    try:
                        tear(rule)
                    except OSError:
                        pass
                # a torn write models a CRASH, not a transient error: it
                # is never retried — a retry would land the full payload
                # after the flushed torn prefix (mid-stream garbage no
                # real crash leaves behind)
                torn = True
                err = OSError(rule.err, "injected torn write")
            else:
                storage_stats.record_injected(surface)
                err = OSError(rule.err, "injected " + os.strerror(rule.err))
        if err is None:
            try:
                result = thunk()
            except StorageFatal:
                raise
            except exc_types as e:
                err = e
            else:
                storage_stats.record_op(surface, op)
                return result
        if not degrade:
            storage_stats.record_fatal(surface)
            _anomaly(
                "disk_fatal", surface=surface, op=op, **_err_attrs(err)
            )
            raise StorageFatal(surface, op, err) from err
        code = getattr(err, "errno", None)
        if attempt < budget and code in TRANSIENT_ERRNOS and not torn:
            attempt += 1
            storage_stats.record_retry(surface)
            _SLEEPER[0](_backoff_s(attempt - 1))
            continue
        storage_stats.record_drop(surface)
        _anomaly("disk_fault", surface=surface, op=op, **_err_attrs(err))
        raise err


def file_write(
    surface: str, f, data: bytes, op: str = "write", path: Optional[str] = None
) -> None:
    """Guarded ``f.write(data)`` — the byte-level write seam.  Supports
    torn-write injection: a ``torn`` rule lands ``torn_keep`` bytes of
    the payload (flushed, so they are really on disk) before raising —
    exactly the mid-frame tail a crashed process leaves behind."""

    def tear(rule: FaultRule) -> None:
        keep = max(min(rule.torn_keep, len(data) - 1), 0)
        if keep:
            f.write(data[:keep])
        f.flush()

    guard(surface, op, lambda: f.write(data), path=path, tear=tear)


def fsync(surface: str, f, path: Optional[str] = None) -> None:
    """Guarded ``os.fsync(f.fileno())``."""
    guard(surface, "fsync", lambda: os.fsync(f.fileno()), path=path)


def flush(surface: str, f, path: Optional[str] = None) -> None:
    """Guarded ``f.flush()``."""
    guard(surface, "flush", f.flush, path=path)


def replace(surface: str, src: str, dst: str) -> None:
    """Guarded ``os.replace(src, dst)`` (atomic publish)."""
    guard(surface, "replace", lambda: os.replace(src, dst), path=dst)


def atomic_write(
    surface: str, path: str, data: bytes, do_fsync: bool = True
) -> None:
    """Write-temp / (flush+fsync) / rename-into-place, each step guarded.
    Readers only ever see the old file or the complete new one; a torn
    or failed write leaves only an unlinked temp behind."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    # the ".tmp" suffix marks abandoned temps (a killed writer) for the
    # surfaces' own GC sweeps (e.g. aot_cache.evict_stale)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            file_write(surface, f, data, op="write", path=path)
            flush(surface, f, path=path)
            if do_fsync:
                fsync(surface, f, path=path)
        replace(surface, tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
