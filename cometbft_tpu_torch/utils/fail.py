"""Crash-point fault injection (reference: internal/fail/fail.go).

``FAIL_TEST_INDEX=<n>`` makes the process exit at the n-th marked point in
the commit path — used to test that WAL/store fsync ordering survives a crash
at every interleaving (reference call sites: internal/consensus/state.go:1872-
1941, state/execution.go:267-322).
"""

from __future__ import annotations

import os

_call_index = 0


def reset() -> None:
    global _call_index
    _call_index = 0


def fail_point(_label: int = 0) -> None:
    """Exit hard if FAIL_TEST_INDEX matches the running call count."""
    env = os.environ.get("FAIL_TEST_INDEX")
    if env is None:
        return
    global _call_index
    if _call_index == int(env):
        os._exit(111)
    _call_index += 1
