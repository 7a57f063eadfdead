"""TCP transport: listen/dial + connection upgrade.

Reference: p2p/transport.go MultiplexTransport — upgrade means the
secret-connection handshake followed by a NodeInfo exchange, with timeout
and identity checks (dialed ID must match the authenticated key).

``device`` (None: the card) goes to every ``SecretConnection`` the
transport builds, so each dial's ladders run through the handshake pool
and each frame through the AEAD plane on that device (on the card the
transport opens the gate when it is built: the batch seam's self-check);
built with no card, the transport raises unless ``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` names the CPU
(``types/validation.require_device``).  ``latency`` (``(my_zone,
ZoneMatrix, peer_zones)``) wraps each raw socket in ``p2p/latency``'s
``DelayedSocket``, innermost, and arms it with the zone pair's one-way
delay once the handshake names the peer; ``conn_wrapper`` (for example
``p2p/fuzz.FuzzedConnection``) wraps outside it, as in the JAX package.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.p2p.node_info import NetAddress, NodeInfo, NodeInfoError
from cometbft_tpu_torch.p2p.secret_connection import (
    SecretConnection,
    SecretConnectionError,
)
from cometbft_tpu_torch.types.validation import entry_device


class TransportError(Exception):
    pass


def parse_laddr(laddr: str) -> tuple[str, int]:
    s = laddr
    if "://" in s:
        s = s.split("://", 1)[1]
    host, _, port = s.rpartition(":")
    return host or "0.0.0.0", int(port)


@dataclass
class UpgradedConn:
    secret_conn: SecretConnection
    node_info: NodeInfo
    remote_addr: tuple[str, int]
    outbound: bool


class Transport:
    """Reference: p2p/transport.go:137 MultiplexTransport."""

    def __init__(
        self,
        node_key,
        node_info_fn: Callable[[], NodeInfo],
        handshake_timeout: float = 20.0,
        dial_timeout: float = 3.0,
        conn_wrapper: Optional[Callable] = None,  # e.g. FuzzedConnection
        latency: Optional[tuple] = None,  # (my_zone, ZoneMatrix, peer_zones)
        device=None,
    ):
        self.device = entry_device(device)  # the gate open for the first dial
        self.node_key = node_key
        self.node_info_fn = node_info_fn
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        self.conn_wrapper = conn_wrapper
        self.latency = latency if latency and latency[0] else None
        self._listener: Optional[socket.socket] = None
        self.listen_addr: Optional[tuple[str, int]] = None
        self._closed = threading.Event()

    # -- listening ---------------------------------------------------------

    def listen(self, laddr: str) -> tuple[str, int]:
        host, port = parse_laddr(laddr)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(64)
        self._listener = s
        self.listen_addr = s.getsockname()
        return self.listen_addr

    def accept_raw(self) -> tuple[socket.socket, tuple]:
        """Block for one inbound TCP connection (not yet upgraded) — lets
        the switch run the (slow, attacker-timed) upgrade off the accept
        loop (reference: transport.go acceptPeers' per-conn goroutine)."""
        if self._listener is None:
            raise TransportError("not listening")
        return self._listener.accept()

    def upgrade_inbound(self, sock: socket.socket, addr) -> UpgradedConn:
        return self._upgrade(sock, addr, outbound=False, expected_id="")

    def accept(self) -> UpgradedConn:
        """Block for one inbound connection, fully upgraded."""
        sock, addr = self.accept_raw()
        return self._upgrade(sock, addr, outbound=False, expected_id="")

    # -- dialing -----------------------------------------------------------

    def dial(self, na: NetAddress) -> UpgradedConn:
        try:
            sock = socket.create_connection(
                na.dial_string(), timeout=self.dial_timeout
            )
        except OSError as e:
            raise TransportError(f"dial {na} failed: {e}") from e
        return self._upgrade(
            sock, na.dial_string(), outbound=True, expected_id=na.id
        )

    # -- upgrade (reference: transport.go:410 upgrade, :538 handshake) -----

    def _upgrade(
        self, sock: socket.socket, addr, outbound: bool, expected_id: str
    ) -> UpgradedConn:
        sock.settimeout(self.handshake_timeout)
        delayed = None
        if self.latency is not None:
            # innermost wrapper: emulated WAN delay applies to the final
            # bytes; armed after the handshake identifies the peer's zone
            from cometbft_tpu_torch.p2p.latency import DelayedSocket

            sock = delayed = DelayedSocket(sock)
        if self.conn_wrapper is not None:
            sock = self.conn_wrapper(sock)
        try:
            sc = SecretConnection(sock, self.node_key.priv_key, self.device)
            remote_id = sc.remote_pub_key.address().hex()
            if expected_id and remote_id != expected_id:
                raise TransportError(
                    f"dialed {expected_id} but peer authenticated as {remote_id}"
                )
            # NodeInfo exchange
            sc.write_msg(self.node_info_fn().to_json())
            their_info = NodeInfo.from_json(sc.read_msg())
            their_info.validate_basic()
            if their_info.node_id != remote_id:
                raise TransportError(
                    "peer's claimed node id does not match its handshake key"
                )
            self.node_info_fn().compatible_with(their_info)
            if delayed is not None:
                my_zone, matrix, peer_zones = self.latency
                peer_zone = peer_zones.get(their_info.node_id, "")
                delayed.set_delay(matrix.one_way_s(my_zone, peer_zone))
            # back to blocking IO for the MConnection routines
            try:
                sock.settimeout(None)
            except AttributeError:
                pass
            return UpgradedConn(
                secret_conn=sc,
                node_info=their_info,
                remote_addr=addr if isinstance(addr, tuple) else tuple(addr),
                outbound=outbound,
            )
        except (
            SecretConnectionError,
            NodeInfoError,
            OSError,
            TimeoutError,
            ValueError,  # malformed node-info JSON / hex
            KeyError,  # node-info missing required fields
        ) as e:
            try:
                sock.close()
            except OSError:
                pass
            raise TransportError(f"upgrade failed: {e}") from e

    def close(self) -> None:
        self._closed.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
