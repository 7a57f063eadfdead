"""Profiling HTTP server behind ``rpc.pprof_laddr``.

Reference: node/node.go:592-595 serves Go's net/http/pprof when the
config key is set.  The Python-runtime equivalents exposed here, same
path layout (``/debug/pprof/...``):

  * ``/debug/pprof/``          — index of available profiles
  * ``/debug/pprof/profile``   — sampling CPU profile over all threads
    for ``?seconds=N`` (default 5), self/cumulative hit counts
  * ``/debug/pprof/heap``      — tracemalloc snapshot (top allocations);
    starts tracemalloc on first use
  * ``/debug/pprof/goroutine`` — stack dump of every live thread (the
    goroutine-dump analog; what the debug CLI collects)
  * ``/debug/pprof/cmdline``   — process argv
  * ``/debug/pprof/threadcreate`` — thread inventory
"""

from __future__ import annotations


import io

import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from cometbft_tpu_torch.libs import log as liblog


def thread_dump() -> str:
    """All live thread stacks (goroutine-dump analog)."""
    out = io.StringIO()
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    for ident, frame in frames.items():
        t = threads.get(ident)
        name = t.name if t else f"thread-{ident}"
        daemon = " daemon" if (t and t.daemon) else ""
        out.write(f"\n--- {name} (ident={ident}{daemon}) ---\n")
        out.write("".join(traceback.format_stack(frame)))
    return out.getvalue()


def heap_snapshot(top: int = 50) -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return "tracemalloc started; fetch again for a populated snapshot\n"
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    out = [f"total traced: {total} B; top {len(stats)} by line:"]
    out += [str(s) for s in stats]
    return "\n".join(out) + "\n"


def cpu_profile(seconds: float, hz: int = 100) -> str:
    """Statistical CPU profile across ALL threads.

    cProfile instruments only the calling thread — which here would be
    the HTTP handler asleep in time.sleep, observing nothing.  Instead,
    sample every live thread's stack via ``sys._current_frames()`` at
    ``hz`` and aggregate self/cumulative hit counts — the shape of Go's
    sampling pprof, which profiles all goroutines."""
    self_hits: dict = {}
    cum_hits: dict = {}
    me = threading.get_ident()
    nticks = 0
    deadline = time.monotonic() + seconds
    interval = 1.0 / hz
    while time.monotonic() < deadline:
        nticks += 1
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            f = frame
            leaf = f"{f.f_code.co_filename}:{f.f_lineno} {f.f_code.co_name}"
            self_hits[leaf] = self_hits.get(leaf, 0) + 1
            seen = set()
            while f is not None:
                key = f"{f.f_code.co_filename} {f.f_code.co_name}"
                if key not in seen:
                    seen.add(key)
                    cum_hits[key] = cum_hits.get(key, 0) + 1
                f = f.f_back
        time.sleep(interval)
    out = [f"samples: {nticks} ticks @ {hz} Hz over {seconds}s, all threads"]
    out.append("\ntop 40 by self samples (thread was exactly here):")
    for k, v in sorted(self_hits.items(), key=lambda kv: -kv[1])[:40]:
        out.append(f"  {v:6d} {k}")
    out.append("\ntop 40 by cumulative samples (frame anywhere on stack):")
    for k, v in sorted(cum_hits.items(), key=lambda kv: -kv[1])[:40]:
        out.append(f"  {v:6d} {k}")
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # route into our logger, not stderr
        self.server.logger.debug("pprof", path=self.path)  # type: ignore[attr-defined]

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        parsed = urlparse(self.path)
        path = parsed.path.rstrip("/") or "/debug/pprof"
        qs = parse_qs(parsed.query)
        try:
            if path == "/debug/pprof":
                body = (
                    "available profiles:\n"
                    "  /debug/pprof/profile?seconds=N (CPU)\n"
                    "  /debug/pprof/heap\n"
                    "  /debug/pprof/goroutine\n"
                    "  /debug/pprof/threadcreate\n"
                    "  /debug/pprof/cmdline\n"
                )
            elif path == "/debug/pprof/profile":
                seconds = float(qs.get("seconds", ["5"])[0])
                body = cpu_profile(min(seconds, 60.0))
            elif path == "/debug/pprof/heap":
                body = heap_snapshot()
            elif path == "/debug/pprof/goroutine":
                body = thread_dump()
            elif path == "/debug/pprof/threadcreate":
                body = "\n".join(
                    f"{t.name} ident={t.ident} daemon={t.daemon} alive={t.is_alive()}"
                    for t in threading.enumerate()
                )
            elif path == "/debug/pprof/cmdline":
                body = "\x00".join(sys.argv)
            else:
                self.send_error(404)
                return
        except Exception as e:  # noqa: BLE001
            self.send_error(500, str(e))
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class PprofServer:
    """Serves the profiling endpoints; bound_port is 0-port friendly."""

    def __init__(self, laddr: str, logger=None):
        host, _, port = laddr.replace("tcp://", "").rpartition(":")
        self._httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), _Handler)
        self._httpd.logger = logger or liblog.nop_logger()  # type: ignore[attr-defined]
        self.bound_port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # start tracemalloc with the server so the first /heap fetch is a
        # real snapshot (debug-kill collects exactly once, then SIGKILLs)
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pprof", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
