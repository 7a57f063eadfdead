"""Peer: an upgraded connection + MConnection + metadata.

Reference: p2p/peer.go peer.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from cometbft_tpu_torch.p2p.conn import ChannelDescriptor, MConnection
from cometbft_tpu_torch.p2p.node_info import NetAddress, NodeInfo


class Peer:
    """Reference: p2p/peer.go."""

    def __init__(
        self,
        upgraded,  # transport.UpgradedConn
        channel_descs: list[ChannelDescriptor],
        on_receive: Callable[["Peer", int, bytes], None],
        on_error: Callable[["Peer", Exception], None],
        send_rate: int = 0,
        recv_rate: int = 0,
        is_persistent: bool = False,
    ):
        self.node_info: NodeInfo = upgraded.node_info
        self.is_outbound: bool = upgraded.outbound
        self.is_persistent = is_persistent
        self.remote_addr = upgraded.remote_addr
        self._secret_conn = upgraded.secret_conn
        self.conn = MConnection(
            upgraded.secret_conn,
            channel_descs,
            on_receive=lambda cid, msg: on_receive(self, cid, msg),
            on_error=lambda e: on_error(self, e),
            send_rate=send_rate,
            recv_rate=recv_rate,
        )
        # channels the REMOTE advertises: don't send on channels it lacks
        # (reference: peer.Send checks hasChannel)
        self._remote_channels = set(self.node_info.channels)
        # scratch space for reactors (reference: peer.Set/Get)
        self._data: dict[str, object] = {}
        self._data_lock = threading.Lock()

    # -- identity ----------------------------------------------------------

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def node_id(self) -> str:
        return self.node_info.node_id

    def remote_ip(self) -> str:
        return self.remote_addr[0] if self.remote_addr else ""

    def socket_addr(self) -> Optional[NetAddress]:
        if not self.remote_addr:
            return None
        return NetAddress(self.id, self.remote_addr[0], self.remote_addr[1])

    def dial_addr(self) -> Optional[NetAddress]:
        """The address to redial this peer: its self-reported listen addr."""
        la = self.node_info.listen_addr
        if not la:
            return None
        try:
            na = NetAddress.parse(la)
        except Exception:  # noqa: BLE001
            return None
        na.id = self.id
        if na.host in ("0.0.0.0", "::", ""):
            na.host = self.remote_ip()
        return na

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.conn.start()

    def stop(self) -> None:
        self.conn.stop()

    @property
    def is_running(self) -> bool:
        return self.conn.is_running

    # -- messaging ---------------------------------------------------------

    def send(self, chan_id: int, msg: bytes) -> bool:
        if self._remote_channels and chan_id not in self._remote_channels:
            return False
        return self.conn.send(chan_id, msg)

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if self._remote_channels and chan_id not in self._remote_channels:
            return False
        return self.conn.try_send(chan_id, msg)

    # -- reactor scratch ---------------------------------------------------

    def set(self, key: str, value) -> None:
        with self._data_lock:
            self._data[key] = value

    def get(self, key: str, default=None):
        with self._data_lock:
            return self._data.get(key, default)

    def status(self) -> dict:
        return self.conn.status()

    def __repr__(self) -> str:  # pragma: no cover
        d = "out" if self.is_outbound else "in"
        return f"Peer{{{self.id[:12]} {d}}}"
