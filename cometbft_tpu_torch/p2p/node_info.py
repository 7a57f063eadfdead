"""NodeInfo + NetAddress (reference: p2p/node_info.go, p2p/netaddress.go).

Exchanged right after the secret-connection handshake; peers are rejected
on network (chain-id) mismatch, p2p protocol mismatch, no common channels,
or a node ID that doesn't match the authenticated handshake key.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from cometbft_tpu_torch.version import P2P_PROTOCOL


class NodeInfoError(Exception):
    pass


_ID_RE = re.compile(r"^[0-9a-f]{40}$")


@dataclass
class NetAddress:
    """id@host:port (reference: p2p/netaddress.go)."""

    id: str
    host: str
    port: int

    @staticmethod
    def parse(s: str) -> "NetAddress":
        if "@" in s:
            id_, _, hostport = s.partition("@")
        else:
            id_, hostport = "", s
        host, _, port = hostport.rpartition(":")
        if not host or not port:
            raise NodeInfoError(f"malformed address {s!r}")
        if id_ and not _ID_RE.match(id_):
            raise NodeInfoError(f"malformed node id in {s!r}")
        return NetAddress(id=id_, host=host.strip("[]"), port=int(port))

    def __str__(self) -> str:
        return f"{self.id}@{self.host}:{self.port}" if self.id else f"{self.host}:{self.port}"

    def dial_string(self) -> tuple[str, int]:
        return self.host, self.port


@dataclass
class NodeInfo:
    """Reference: p2p/node_info.go DefaultNodeInfo."""

    node_id: str
    network: str  # chain id
    listen_addr: str = ""
    version: str = ""  # set from version.CMT_SEMVER at construction
    channels: bytes = b""
    moniker: str = ""
    p2p_protocol: int = P2P_PROTOCOL
    block_protocol: int = 0
    rpc_address: str = ""

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "network": self.network,
                "listen_addr": self.listen_addr,
                "version": self.version,
                "channels": self.channels.hex(),
                "moniker": self.moniker,
                "p2p_protocol": self.p2p_protocol,
                "block_protocol": self.block_protocol,
                "rpc_address": self.rpc_address,
            },
            sort_keys=True,
        ).encode()

    @staticmethod
    def from_json(raw: bytes) -> "NodeInfo":
        d = json.loads(raw.decode())
        return NodeInfo(
            node_id=d["node_id"],
            network=d["network"],
            listen_addr=d.get("listen_addr", ""),
            version=d.get("version", ""),
            channels=bytes.fromhex(d.get("channels", "")),
            moniker=d.get("moniker", ""),
            p2p_protocol=d.get("p2p_protocol", 0),
            block_protocol=d.get("block_protocol", 0),
            rpc_address=d.get("rpc_address", ""),
        )

    def validate_basic(self) -> None:
        if not _ID_RE.match(self.node_id):
            raise NodeInfoError(f"invalid node id {self.node_id!r}")
        if not self.network:
            raise NodeInfoError("empty network")
        if len(self.channels) > 64:
            raise NodeInfoError("too many channels")

    def compatible_with(self, other: "NodeInfo") -> None:
        """Reference: node_info.go CompatibleWith."""
        if self.network != other.network:
            raise NodeInfoError(
                f"network mismatch: {self.network!r} vs {other.network!r}"
            )
        if self.p2p_protocol != other.p2p_protocol:
            raise NodeInfoError(
                f"p2p protocol mismatch: {self.p2p_protocol} vs "
                f"{other.p2p_protocol}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise NodeInfoError("no common channels")
