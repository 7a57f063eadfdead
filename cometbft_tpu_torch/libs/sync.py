"""Lock factories with an opt-in deadlock-detecting mode.

Reference: libs/sync/deadlock.go — the ``deadlock`` build tag swaps
sync.Mutex/RWMutex for go-deadlock's watchdog variants in every package
that imports libs/sync.  Here the swap is environmental:

    COMETBFT_TPU_DEADLOCK=1            enable watchdog locks
    COMETBFT_TPU_DEADLOCK_TIMEOUT=30   seconds before declaring deadlock

When enabled, ``lock()``/``rlock()`` return wrappers whose blocking
acquire gives up after the timeout, dumps every live thread's stack (the
evidence needed to find the cycle), and raises ``DeadlockError`` —
turning a silent hang into a diagnosable failure, exactly what
go-deadlock does for the reference's race CI.
"""

from __future__ import annotations

import io
import os
import sys
import threading
import traceback


class DeadlockError(RuntimeError):
    pass


def _enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_DEADLOCK", "") not in ("", "0")


def _timeout() -> float:
    return float(os.environ.get("COMETBFT_TPU_DEADLOCK_TIMEOUT", "30"))


def _all_stacks() -> str:
    out = io.StringIO()
    threads = {t.ident: t for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        t = threads.get(ident)
        out.write(f"\n--- {(t.name if t else ident)} ---\n")
        out.write("".join(traceback.format_stack(frame)))
    return out.getvalue()


class _WatchdogLock:
    """Wraps a Lock/RLock; blocking acquires time out loudly."""

    def __init__(self, inner, name: str = ""):
        self._inner = inner
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            return self._inner.acquire(False)
        limit = _timeout() if timeout in (-1, None) else min(timeout, _timeout())
        if self._inner.acquire(True, limit):
            return True
        if timeout not in (-1, None) and timeout <= _timeout():
            return False  # caller asked for a shorter timeout; not a deadlock
        raise DeadlockError(
            f"lock {self._name or repr(self._inner)} not acquired within "
            f"{limit}s — likely deadlock.  All thread stacks:{_all_stacks()}"
        )

    def release(self) -> None:
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    # RLock introspection passthroughs some callers use
    def _is_owned(self):
        return self._inner._is_owned()


def lock(name: str = ""):
    """A mutex; watchdog-wrapped when COMETBFT_TPU_DEADLOCK is set."""
    inner = threading.Lock()
    return _WatchdogLock(inner, name) if _enabled() else inner


def rlock(name: str = ""):
    """A re-entrant mutex; watchdog-wrapped when enabled."""
    inner = threading.RLock()
    return _WatchdogLock(inner, name) if _enabled() else inner


def condition(lk=None):
    """A Condition over a (possibly watchdog) lock.  Conditions need the
    raw primitive, so watchdog mode unwraps transparently."""
    if isinstance(lk, _WatchdogLock):
        lk = lk._inner
    return threading.Condition(lk)
