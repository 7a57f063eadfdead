"""ABCI clients: in-process (local) and socket.

Reference: abci/client/{local_client.go,socket_client.go}.  The local client
serializes calls through one lock, matching the reference's semantics that an
ABCI app sees at most one concurrent request per connection.  The socket
client speaks the framed codec in abci/codec.py against a SocketServer
(possibly in another process), with async CheckTx pipelining for the mempool
path (reference: socket_client.go request queue + response routing).  The
gRPC client is ``abci/grpc_abci.GRPCClient``.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable, Optional

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.abci.application import Application

_METHODS = (
    "echo",
    "info",
    "query",
    "check_tx",
    "check_txs",
    "init_chain",
    "prepare_proposal",
    "process_proposal",
    "finalize_block",
    "extend_vote",
    "verify_vote_extension",
    "commit",
    "list_snapshots",
    "offer_snapshot",
    "load_snapshot_chunk",
    "apply_snapshot_chunk",
)


class ABCIClientError(Exception):
    pass


class Client:
    """Synchronous call surface + async check_tx for mempool pipelining."""

    def echo(self, message: str) -> at.EchoResponse:
        raise NotImplementedError

    def call(self, method: str, req) -> object:
        raise NotImplementedError

    def check_tx_async(self, req: at.CheckTxRequest, cb: Callable) -> None:
        """Fire CheckTx; invoke cb(response) when it completes."""
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # Convenience wrappers
    def info(self, req=None):
        return self.call("info", req or at.InfoRequest())

    def query(self, req):
        return self.call("query", req)

    def check_tx(self, req):
        return self.call("check_tx", req)

    def check_txs(
        self, reqs: "list[at.CheckTxRequest]"
    ) -> "list[at.CheckTxResponse]":
        """Batched CheckTx: one round trip for a whole gossip burst
        (docs/tx-ingest.md).  Falls back to a per-tx loop — and remembers —
        when the remote end predates the batched method, so callers can
        always use the batch surface and only the round-trip count varies.
        """
        if not reqs:
            return []
        if not getattr(self, "_no_check_txs", False):
            try:
                resp = self.call("check_txs", at.CheckTxsRequest(requests=reqs))
            except NotImplementedError:
                self._no_check_txs = True
            except AttributeError:
                app = getattr(self, "app", None)
                if app is not None and hasattr(app, "check_txs"):
                    raise  # a genuine bug inside the app's own check_txs
                # duck-typed app without the method
                self._no_check_txs = True
            except ABCIClientError:
                # remote end predates the batched method (a legacy socket
                # server errors on the unknown frame): degrade to per-tx
                # calls — if the connection is actually dead, the per-tx
                # path surfaces that immediately instead of masking it
                self._no_check_txs = True
            else:
                if len(resp.responses) != len(reqs):
                    raise ABCIClientError(
                        "check_txs returned %d responses for %d requests"
                        % (len(resp.responses), len(reqs))
                    )
                return list(resp.responses)
        return [self.call("check_tx", r) for r in reqs]

    def init_chain(self, req):
        return self.call("init_chain", req)

    def prepare_proposal(self, req):
        return self.call("prepare_proposal", req)

    def process_proposal(self, req):
        return self.call("process_proposal", req)

    def finalize_block(self, req):
        return self.call("finalize_block", req)

    def extend_vote(self, req):
        return self.call("extend_vote", req)

    def verify_vote_extension(self, req):
        return self.call("verify_vote_extension", req)

    def commit(self, req=None):
        return self.call("commit", req or at.CommitRequest())

    def list_snapshots(self, req=None):
        return self.call("list_snapshots", req or at.ListSnapshotsRequest())

    def offer_snapshot(self, req):
        return self.call("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self.call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self.call("apply_snapshot_chunk", req)


class LocalClient(Client):
    """In-process client over a shared mutex (reference: local_client.go).

    All local clients for one app share a single lock, so consensus/mempool/
    query/snapshot connections never interleave inside the app.
    """

    def __init__(self, app: Application, lock: Optional[threading.Lock] = None):
        self.app = app
        self.lock = lock if lock is not None else threading.Lock()

    def echo(self, message: str) -> at.EchoResponse:
        return at.EchoResponse(message=message)

    def call(self, method: str, req):
        if method not in _METHODS:
            raise ABCIClientError(f"unknown ABCI method {method}")
        with self.lock:
            return getattr(self.app, method)(req)

    def check_txs(
        self, reqs: "list[at.CheckTxRequest]"
    ) -> "list[at.CheckTxResponse]":
        # An app that overrides check_txs opted into one batched call and
        # holds the shared four-connection lock for it.  The base-class
        # loop gains nothing from that — release the lock between txs so
        # consensus-connection calls can interleave with a gossip burst
        # (the batch stays a sequence of independent checks either way).
        from cometbft_tpu_torch.abci.application import Application

        if getattr(type(self.app), "check_txs", None) in (
            Application.check_txs,
            None,
        ):
            return [self.call("check_tx", r) for r in reqs]
        return super().check_txs(reqs)

    def check_tx_async(self, req, cb):
        cb(self.call("check_tx", req))


class SocketClient(Client):
    """Framed-socket client with a dedicated send thread and response router
    (reference: abci/client/socket_client.go)."""

    def __init__(self, address: str, timeout: float = 10.0):
        self.address = address
        self.timeout = timeout
        self._sock = _dial(address, timeout)
        self._wlock = threading.Lock()
        self._pending: "queue.Queue[tuple[str, Optional[Callable], Optional[queue.Queue]]]" = queue.Queue()
        self._closed = False
        self._err: Optional[Exception] = None
        self._recv_thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._recv_thread.start()

    def _enqueue_and_send(
        self,
        method: str,
        req,
        cb: Optional[Callable],
        q: Optional[queue.Queue],
    ) -> None:
        # Enqueue + send must be atomic: responses come back in wire order and
        # are matched to pending entries in queue order, so the two orders
        # must agree.
        data = codec.encode_request(method, req)
        with self._wlock:
            self._pending.put((method, cb, q))
            self._sock.sendall(data)

    def _recv_loop(self) -> None:
        try:
            rfile = self._sock.makefile("rb")
            while not self._closed:
                method, resp = codec.read_response(rfile)
                try:
                    _, cb, q = self._pending.get_nowait()
                except queue.Empty:
                    raise ABCIClientError("unsolicited ABCI response")
                if cb is not None:
                    cb(resp)
                if q is not None:
                    q.put(resp)
        except Exception as e:  # socket closed or protocol error
            self._err = e
            self._closed = True
            # Fail all waiters — sync callers get the exception, async
            # callbacks are invoked with it so no check_tx result is lost.
            while True:
                try:
                    _, cb, q = self._pending.get_nowait()
                except queue.Empty:
                    break
                if q is not None:
                    q.put(e)
                if cb is not None:
                    try:
                        cb(e)
                    except Exception:
                        pass

    def call(self, method: str, req):
        if self._closed:
            raise ABCIClientError(f"client closed: {self._err}")
        q: queue.Queue = queue.Queue()
        self._enqueue_and_send(method, req, None, q)
        try:
            resp = q.get(timeout=self.timeout)
        except queue.Empty:
            raise ABCIClientError(
                f"ABCI {method} timed out after {self.timeout}s"
            ) from None
        if isinstance(resp, Exception):
            raise ABCIClientError(str(resp)) from resp
        return resp

    def check_tx_async(self, req, cb):
        if self._closed:
            raise ABCIClientError(f"client closed: {self._err}")
        self._enqueue_and_send("check_tx", req, cb, None)

    def echo(self, message: str) -> at.EchoResponse:
        return self.call("echo", at.EchoRequest(message=message))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


def _dial(address: str, timeout: float) -> socket.socket:
    """address: 'tcp://host:port' or 'unix:///path'."""
    if address.startswith("unix://"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(address[len("unix://"):])
    else:
        hostport = address[len("tcp://"):] if address.startswith("tcp://") else address
        host, port = hostport.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.settimeout(None)
    return s
