"""Multi-app-conn proxy: 4 named ABCI connections.

Reference: proxy/multi_app_conn.go:19-160 — the node talks to the app over
four logical connections (consensus, mempool, query, snapshot) so a slow
query can never head-of-line-block consensus.  For the builtin (in-process)
app all four share one lock (reference local client semantics); for a socket
app each is a separate TCP/unix connection.

The mempool connection additionally carries the batched-CheckTx surface
(``Client.check_txs``, docs/tx-ingest.md): the ingest coalescer admits a
whole gossip burst in one round trip, with a per-tx loop fallback for
clients/apps that predate the batch method.

``remote_client_creator`` makes ``abci/grpc_abci.GRPCClient``s for the gRPC
transport (importing ``grpc`` only then) and ``SocketClient``s otherwise.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from cometbft_tpu_torch.abci.application import Application
from cometbft_tpu_torch.abci.client import Client, LocalClient, SocketClient

ClientCreator = Callable[[], Client]


def local_client_creator(app: Application) -> ClientCreator:
    """All connections share one mutex (reference: proxy/client.go
    NewLocalClientCreator)."""
    lock = threading.Lock()

    def create() -> Client:
        return LocalClient(app, lock)

    return create


def remote_client_creator(address: str, transport: str = "socket") -> ClientCreator:
    """Socket (length-prefixed framing) or gRPC flavor, per the reference's
    abci config key (abci/client: socketClient vs grpcClient)."""

    def create() -> Client:
        if transport == "grpc" or address.startswith("grpc://"):
            from cometbft_tpu_torch.abci.grpc_abci import GRPCClient

            return GRPCClient(address)
        return SocketClient(address)

    return create


class AppConns:
    """Holds the 4 connections; start() performs the Echo handshake on each."""

    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self.consensus: Optional[Client] = None
        self.mempool: Optional[Client] = None
        self.query: Optional[Client] = None
        self.snapshot: Optional[Client] = None

    def start(self) -> None:
        self.query = self._creator()
        self.snapshot = self._creator()
        self.mempool = self._creator()
        self.consensus = self._creator()
        for c in (self.query, self.snapshot, self.mempool, self.consensus):
            c.echo("multi_app_conn-handshake")

    def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            if c is not None:
                c.close()


def new_multi_app_conn(creator: ClientCreator) -> AppConns:
    return AppConns(creator)
