"""Reactor base class (reference: p2p/base_reactor.go).

A reactor owns a set of channels on the switch; the switch dispatches
incoming messages by channel ID and notifies reactors of peer lifecycle.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor

if TYPE_CHECKING:  # pragma: no cover
    from cometbft_tpu_torch.p2p.peer import Peer
    from cometbft_tpu_torch.p2p.switch import Switch


class Reactor(BaseService):
    """Reference: p2p/base_reactor.go BaseReactor."""

    def __init__(self, name: str):
        super().__init__(name)
        self.switch: Optional["Switch"] = None

    def set_switch(self, switch: "Switch") -> None:
        self.switch = switch

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    def add_peer(self, peer: "Peer") -> None:
        """Called when a peer is fully connected."""

    def remove_peer(self, peer: "Peer", reason: object) -> None:
        """Called when a peer disconnects."""

    def receive(self, chan_id: int, peer: "Peer", msg_bytes: bytes) -> None:
        """Called (from the peer's recv routine) for each complete message."""

    def on_start(self) -> None:  # most reactors are passive
        pass

    def on_stop(self) -> None:
        pass
