"""Process-wide counters of the build cache and the warm-boot pass.

The port's counterpart of ``cometbft_tpu/ops/warm_stats.py``.  Free of
torch, as ``ops/dispatch_stats`` is.  ``ops/_build.py`` writes the build
cache's counters and ``ops/warmboot.py`` the warm pass's.

Counters (all guarded by one lock):

  * ``libs_hit``        libraries found built in the build directory;
  * ``libs_built`` / ``build_seconds``  libraries compiled in this
    process, and the seconds until each finished (the compilers run in
    parallel, so the seconds overlap);
  * ``build_failures``  builds that failed (a missing compiler included);
  * ``warm_runs`` / ``warm_seconds``  warm-boot passes and their wall time;
  * ``shapes_warmed``   libraries a pass loaded and self-checked;
  * ``shapes_pruned``   0 in the port: it builds one library per kernel
    whatever the lanes, so there is no compile matrix to prune (the JAX
    package counts the bucket shapes its collapsed matrix skips);
  * ``warm_failures``   families whose build, load or self-check failed.

The JAX package's executable-cache counters (``compiles``,
``exec_hits``, ``exec_stale``, ...) become the four build counters: the
port caches libraries, not executables.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def _zero() -> dict:
    return {
        "libs_hit": 0,
        "libs_built": 0,
        "build_seconds": 0.0,
        "build_failures": 0,
        "warm_runs": 0,
        "warm_seconds": 0.0,
        "shapes_warmed": 0,
        "shapes_pruned": 0,
        "warm_failures": 0,
    }


_STATS = _zero()


def record_build(outcome: str, seconds: "float | None" = None) -> None:
    """One library's build outcome: ``hit``, ``built`` (with its seconds)
    or ``error:<Type>``."""
    with _LOCK:
        if outcome == "hit":
            _STATS["libs_hit"] += 1
        elif outcome == "built":
            _STATS["libs_built"] += 1
            _STATS["build_seconds"] += float(seconds or 0.0)
        else:
            _STATS["build_failures"] += 1


def record_warm_run(seconds: float, warmed: int, pruned: int,
                    failures: int) -> None:
    with _LOCK:
        _STATS["warm_runs"] += 1
        _STATS["warm_seconds"] += float(seconds)
        _STATS["shapes_warmed"] += int(warmed)
        _STATS["shapes_pruned"] += int(pruned)
        _STATS["warm_failures"] += int(failures)


def snapshot() -> dict:
    with _LOCK:
        return dict(_STATS)


def reset() -> None:
    global _STATS
    with _LOCK:
        _STATS = _zero()
