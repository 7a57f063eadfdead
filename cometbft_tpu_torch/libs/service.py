"""Service lifecycle (reference: libs/service/service.go).

Every long-lived object embeds a ``BaseService``: Start/Stop are idempotent
state transitions guarded by atomic flags; ``on_start``/``on_stop`` hooks do
the real work; ``wait`` blocks until stopped.  Unlike the reference's
goroutine-per-service model, threads are created only by services that need
them — the lifecycle contract is the shared part.
"""

from __future__ import annotations

import threading


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class BaseService:
    """Reference: libs/service/service.go BaseService."""

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self._started = False
        self._stopped = False
        self._quit = threading.Event()
        self._lifecycle_mtx = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle_mtx:
            if self._stopped:
                raise AlreadyStoppedError(self.name)
            if self._started:
                raise AlreadyStartedError(self.name)
            self._started = True
        self.on_start()

    def stop(self) -> None:
        with self._lifecycle_mtx:
            if self._stopped:
                return
            self._stopped = True
        self._quit.set()
        self.on_stop()

    def reset(self) -> None:
        with self._lifecycle_mtx:
            if not self._stopped:
                raise ServiceError(f"cannot reset running service {self.name}")
            self._started = False
            self._stopped = False
            self._quit = threading.Event()
        self.on_reset()

    # -- hooks ------------------------------------------------------------

    def on_start(self) -> None:  # pragma: no cover - default no-op
        pass

    def on_stop(self) -> None:  # pragma: no cover - default no-op
        pass

    def on_reset(self) -> None:  # pragma: no cover - default no-op
        pass

    # -- state ------------------------------------------------------------

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    def quit_event(self) -> threading.Event:
        return self._quit

    def wait(self, timeout: float | None = None) -> bool:
        return self._quit.wait(timeout)
