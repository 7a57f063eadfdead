"""Structured key-value logger (reference: libs/log).

TMFmt-style lines: ``LEVEL[time] message key=value ...`` with a module label.
Lazy values: pass a zero-arg callable and it is only rendered when the line is
actually emitted (reference: log.NewLazyBlockHash, state.go:1866).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Optional, TextIO

DEBUG, INFO, WARN, ERROR, NONE = 0, 1, 2, 3, 4
_NAMES = {DEBUG: "DBUG", INFO: "INFO", WARN: "WARN", ERROR: "ERRO"}
_LEVELS = {"debug": DEBUG, "info": INFO, "warn": WARN, "error": ERROR, "none": NONE}

_write_lock = threading.Lock()


def parse_level(s: str) -> int:
    return _LEVELS.get(s.lower(), INFO)


def _render(v: Any) -> str:
    if callable(v):
        v = v()
    if isinstance(v, bytes):
        v = v.hex()[:16].upper()
    s = str(v)
    if " " in s:
        return repr(s)
    return s


class Logger:
    def __init__(
        self,
        level: int = INFO,
        out: Optional[TextIO] = None,
        module: str = "",
        **bound: Any,
    ):
        self.level = level
        self.out = out if out is not None else sys.stderr
        self.module = module
        self.bound = bound

    def with_(self, module: str = "", **kv: Any) -> "Logger":
        return Logger(
            self.level,
            self.out,
            module or self.module,
            **{**self.bound, **kv},
        )

    def _log(self, level: int, msg: str, kv: dict[str, Any]) -> None:
        if level < self.level:
            return
        ts = time.strftime("%H:%M:%S", time.localtime())
        parts = [f"{_NAMES[level]}[{ts}] {msg}"]
        if self.module:
            parts.append(f"module={self.module}")
        for k, v in {**self.bound, **kv}.items():
            parts.append(f"{k}={_render(v)}")
        with _write_lock:
            try:
                print(" ".join(parts), file=self.out)
            except ValueError:
                # daemon threads may log during interpreter shutdown after
                # the sink (pytest capture, a closed pipe) is gone; dropping
                # the line beats a traceback storm on teardown
                pass

    def debug(self, msg: str, **kv: Any) -> None:
        self._log(DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(INFO, msg, kv)

    def warn(self, msg: str, **kv: Any) -> None:
        self._log(WARN, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log(ERROR, msg, kv)


def nop_logger() -> Logger:
    return Logger(level=NONE)


def test_logger() -> Logger:
    return Logger(level=_LEVELS.get("info", INFO), out=sys.stdout)
