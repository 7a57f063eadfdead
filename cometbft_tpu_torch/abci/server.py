"""ABCI socket server: serve an Application over TCP or unix sockets.

Reference: abci/server/socket_server.go — one handler thread per accepted
connection (the node opens 4: consensus/mempool/query/snapshot), requests
processed in order per connection, app calls serialized by a shared lock.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
from typing import Optional

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.abci.application import Application


class ABCIServer:
    def __init__(self, app: Application, address: str):
        self.app = app
        self.address = address
        self._app_lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._running = False

    def start(self) -> None:
        if self.address.startswith("unix://"):
            path = self.address[len("unix://"):]
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
        else:
            hostport = (
                self.address[len("tcp://"):]
                if self.address.startswith("tcp://")
                else self.address
            )
            host, port = hostport.rsplit(":", 1)
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, int(port)))
        self._listener.listen(16)
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    @property
    def bound_port(self) -> Optional[int]:
        """TCP port actually bound, or None for unix-socket listeners."""
        assert self._listener is not None
        if self._listener.family == socket.AF_UNIX:
            return None
        return self._listener.getsockname()[1]

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1) \
                if conn.family != socket.AF_UNIX else None
            t = threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        method = "<none>"
        try:
            while self._running:
                method, req = codec.read_request(rfile)
                if method == "echo":
                    resp = at.EchoResponse(message=req.message)
                else:
                    with self._app_lock:
                        resp = getattr(self.app, method)(req)
                conn.sendall(codec.encode_response(method, resp))
        except (EOFError, OSError) as e:
            # orderly client disconnect is normal; anything else is worth a
            # trace on stderr (the app process's log) before dropping the
            # conn — a silent close here surfaces to the node only as an
            # opaque "ABCI stream closed"
            if not isinstance(e, EOFError):
                print(
                    f"abci server: conn error after {method}: {e!r}",
                    file=sys.stderr,
                    flush=True,
                )
        except Exception as e:  # app error: report and close (ref kills node)
            print(
                f"abci server: app error in {method}: {e!r}",
                file=sys.stderr,
                flush=True,
            )
            try:
                conn.sendall(codec.encode_error("error", str(e)))
            except OSError:
                pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
