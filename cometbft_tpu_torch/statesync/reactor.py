"""Statesync reactor (reference: statesync/reactor.go).

Two channels: snapshot discovery 0x60 and chunk transfer 0x61
(reference: reactor.go:23-25).  Serves the local app's snapshots to
bootstrapping peers and feeds responses into the Syncer.
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.statesync.syncer import SnapshotKey, Syncer

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

_MSG_SNAPSHOTS_REQUEST = 1
_MSG_SNAPSHOTS_RESPONSE = 2
_MSG_CHUNK_REQUEST = 3
_MSG_CHUNK_RESPONSE = 4

MAX_SNAPSHOTS_ADVERTISED = 10  # reference: recentSnapshots


def _enc(kind: int, body: bytes = b"") -> bytes:
    return bytes([kind]) + body


class StatesyncReactor(Reactor):
    """Reference: statesync/reactor.go Reactor."""

    def __init__(self, proxy_app, syncer: Optional[Syncer] = None, logger=None):
        super().__init__("StatesyncReactor")
        self.proxy_app = proxy_app  # for serving snapshots
        self.syncer = syncer  # present only while this node is syncing
        self.logger = logger or liblog.nop_logger()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                SNAPSHOT_CHANNEL,
                priority=5,
                send_queue_capacity=10,
                recv_message_capacity=64 * 1024,
            ),
            ChannelDescriptor(
                CHUNK_CHANNEL,
                priority=3,
                send_queue_capacity=4,
                recv_message_capacity=16 * 1024 * 1024,
            ),
        ]

    def add_peer(self, peer) -> None:
        if self.syncer is not None:
            peer.try_send(SNAPSHOT_CHANNEL, _enc(_MSG_SNAPSHOTS_REQUEST))

    def remove_peer(self, peer, reason) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    def request_snapshots(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(SNAPSHOT_CHANNEL, _enc(_MSG_SNAPSHOTS_REQUEST))

    def request_chunk(
        self, peer_id: str, height: int, format_: int, index: int
    ) -> bool:
        sw = self.switch
        if sw is None:
            return False
        peer = sw.get_peer(peer_id)
        if peer is None:
            return False
        body = (
            pe.t_varint(1, height)
            + pe.t_varint(2, format_)
            + pe.t_varint(3, index + 1)
        )
        return peer.try_send(CHUNK_CHANNEL, _enc(_MSG_CHUNK_REQUEST, body))

    # -- receive -----------------------------------------------------------

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, body = msg_bytes[0], msg_bytes[1:]
        if chan_id == SNAPSHOT_CHANNEL:
            if kind == _MSG_SNAPSHOTS_REQUEST:
                self._serve_snapshots(peer)
            elif kind == _MSG_SNAPSHOTS_RESPONSE and self.syncer is not None:
                f = pe.fields_dict(body)
                self.syncer.add_snapshot(
                    peer.id,
                    SnapshotKey(
                        height=pe.to_int64(f.get(1, [0])[-1]),
                        format=f.get(2, [0])[-1],
                        hash=bytes(f.get(4, [b""])[-1]),
                        chunks=f.get(3, [0])[-1],
                        metadata=bytes(f.get(5, [b""])[-1]),
                    ),
                )
        elif chan_id == CHUNK_CHANNEL:
            if kind == _MSG_CHUNK_REQUEST:
                self._serve_chunk(peer, body)
            elif kind == _MSG_CHUNK_RESPONSE and self.syncer is not None:
                f = pe.fields_dict(body)
                self.syncer.add_chunk(
                    height=pe.to_int64(f.get(1, [0])[-1]),
                    format_=f.get(2, [0])[-1],
                    index=f.get(3, [0])[-1] - 1,
                    chunk=bytes(f.get(4, [b""])[-1]),
                )

    def _serve_snapshots(self, peer) -> None:
        """Reference: reactor.go Receive's ListSnapshots path."""
        try:
            res = self.proxy_app.snapshot.list_snapshots(
                at.ListSnapshotsRequest()
            )
        except Exception as e:  # noqa: BLE001
            self.logger.error("list snapshots failed", err=repr(e))
            return
        for s in res.snapshots[-MAX_SNAPSHOTS_ADVERTISED:]:
            body = (
                pe.t_varint(1, s.height)
                + pe.t_varint(2, s.format)
                + pe.t_varint(3, s.chunks)
                + pe.t_bytes(4, s.hash)
                + pe.t_bytes(5, s.metadata)
            )
            peer.try_send(SNAPSHOT_CHANNEL, _enc(_MSG_SNAPSHOTS_RESPONSE, body))

    def _serve_chunk(self, peer, body: bytes) -> None:
        f = pe.fields_dict(body)
        height = pe.to_int64(f.get(1, [0])[-1])
        format_ = f.get(2, [0])[-1]
        index = f.get(3, [0])[-1] - 1
        try:
            res = self.proxy_app.snapshot.load_snapshot_chunk(
                at.LoadSnapshotChunkRequest(
                    height=height, format=format_, chunk=index
                )
            )
        except Exception as e:  # noqa: BLE001
            self.logger.error("load chunk failed", err=repr(e))
            return
        out = (
            pe.t_varint(1, height)
            + pe.t_varint(2, format_)
            + pe.t_varint(3, index + 1)
            + pe.t_bytes(4, res.chunk or b"")
        )
        peer.try_send(CHUNK_CHANNEL, _enc(_MSG_CHUNK_RESPONSE, out))
