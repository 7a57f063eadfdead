"""The ABCI client surface and the in-process client.

Reference: abci/client/local_client.go.  The local client serializes calls
through one lock, matching the reference's semantics that an ABCI app sees
at most one concurrent request per connection.  The JAX package's
``SocketClient`` (the framed codec of ``abci/codec.py``) and ``grpc_abci``
wait for ROADMAP "Node assembly" stage (b).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

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
