"""The p2p switch: peer lifecycle + reactor registry.

Reference: p2p/switch.go:72 Switch — accept loop, dialing (persistent
peers reconnect with exponential backoff), broadcast, StopPeerForError,
peer filters (self, duplicate, limits).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.node_info import NetAddress, NodeInfo
from cometbft_tpu_torch.p2p.peer import Peer
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.p2p.transport import Transport, TransportError

RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_WAIT = 1.0  # doubles each failure, capped
RECONNECT_MAX_WAIT = 30.0


class SwitchError(Exception):
    pass


class Switch(BaseService):
    """Reference: p2p/switch.go Switch."""

    def __init__(
        self,
        config,  # P2PConfig
        transport: Transport,
        node_info_fn: Callable[[], NodeInfo],
        logger: Optional[liblog.Logger] = None,
    ):
        super().__init__("Switch")
        self.config = config
        self.transport = transport
        self.node_info_fn = node_info_fn
        self.logger = logger or liblog.nop_logger()

        self.reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._channel_descs: list[ChannelDescriptor] = []

        self.peers: dict[str, Peer] = {}
        self._peers_lock = threading.RLock()
        self._dialing: set[str] = set()
        self._reconnecting: set[str] = set()
        self._persistent_addrs: list[NetAddress] = []
        self._threads: list[threading.Thread] = []
        # optional addrbook hook (set by PEX)
        self.addr_book = None

    # -- reactor registry --------------------------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        """Reference: switch.go:163 AddReactor."""
        for desc in reactor.get_channels():
            if desc.id in self._chan_to_reactor:
                raise SwitchError(f"channel {desc.id:#x} already registered")
            self._chan_to_reactor[desc.id] = reactor
            self._channel_descs.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Optional[Reactor]:
        return self.reactors.get(name)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()
        if self.transport.listen_addr is not None:
            t = threading.Thread(
                target=self._accept_routine, name="sw-accept", daemon=True
            )
            t.start()
            self._threads.append(t)

    def on_stop(self) -> None:
        with self._peers_lock:
            peers = list(self.peers.values())
        for p in peers:
            self._remove_peer(p, "switch stopping")
        self.transport.close()
        for reactor in self.reactors.values():
            reactor.stop()

    # -- accept (reference: switch.go acceptRoutine) -----------------------

    def _accept_routine(self) -> None:
        while self.is_running:
            try:
                sock, addr = self.transport.accept_raw()
            except (TransportError, OSError) as e:
                if not self.is_running:
                    return
                self.logger.debug("accept failed", err=str(e))
                continue
            # run the (attacker-timed) upgrade off the accept loop so one
            # stalled dialer can't block inbound connectivity
            threading.Thread(
                target=self._upgrade_inbound,
                args=(sock, addr),
                name="sw-upgrade",
                daemon=True,
            ).start()

    def _upgrade_inbound(self, sock, addr) -> None:
        try:
            up = self.transport.upgrade_inbound(sock, addr)
        except (TransportError, OSError) as e:
            self.logger.debug("inbound upgrade failed", err=str(e))
            return
        try:
            self._filter_conn(up, inbound=True)
        except SwitchError as e:
            self.logger.debug(
                "rejected inbound peer",
                peer=up.node_info.node_id[:12],
                err=str(e),
            )
            up.secret_conn.close()
            return
        self._add_peer(up)

    def _filter_conn(self, up, inbound: bool) -> None:
        nid = up.node_info.node_id
        if nid == self.node_info_fn().node_id:
            raise SwitchError("connection to self")
        with self._peers_lock:
            if nid in self.peers:
                raise SwitchError("duplicate peer")
            n_in = sum(1 for p in self.peers.values() if not p.is_outbound)
            n_out = sum(1 for p in self.peers.values() if p.is_outbound)
        unconditional = nid in self.config.unconditional_peer_ids
        if inbound and not unconditional:
            if n_in >= self.config.max_num_inbound_peers:
                raise SwitchError("too many inbound peers")
        if not inbound and not unconditional:
            if n_out >= self.config.max_num_outbound_peers + len(
                self._persistent_addrs
            ):
                raise SwitchError("too many outbound peers")
        if not self.config.allow_duplicate_ip and up.remote_addr:
            ip = up.remote_addr[0]
            with self._peers_lock:
                for p in self.peers.values():
                    if p.remote_ip() == ip and ip not in ("127.0.0.1", "::1"):
                        raise SwitchError(f"duplicate IP {ip}")

    # -- dialing -----------------------------------------------------------

    def dial_peers_async(self, addrs: list[str], persistent: bool = False):
        """Reference: switch.go:468 DialPeersAsync."""
        nas = []
        for a in addrs:
            try:
                na = NetAddress.parse(a)
            except Exception as e:  # noqa: BLE001
                self.logger.error("bad peer address", addr=a, err=str(e))
                continue
            nas.append(na)
        if persistent:
            self._persistent_addrs.extend(nas)
        random.shuffle(nas)
        for na in nas:
            threading.Thread(
                target=self._dial_peer, args=(na, persistent), daemon=True
            ).start()

    def dial_peer(self, na: NetAddress, persistent: bool = False) -> bool:
        return self._dial_peer(na, persistent)

    def _dial_peer(self, na: NetAddress, persistent: bool) -> bool:
        key = str(na)
        with self._peers_lock:
            if na.id and na.id in self.peers:
                return True
            if key in self._dialing:
                return False
            self._dialing.add(key)
        try:
            up = self.transport.dial(na)
            try:
                self._filter_conn(up, inbound=False)
            except SwitchError as e:
                up.secret_conn.close()
                self.logger.debug("rejected outbound peer", err=str(e))
                return False
            self._add_peer(up, persistent=persistent)
            if self.addr_book is not None and na.id:
                self.addr_book.mark_good(na)
            return True
        except TransportError as e:
            self.logger.debug("dial failed", addr=str(na), err=str(e))
            if self.addr_book is not None and na.id:
                self.addr_book.mark_attempt(na)
            return False
        finally:
            with self._peers_lock:
                self._dialing.discard(key)

    def _reconnect_routine(self, na: NetAddress) -> None:
        """Exponential backoff reconnect to a persistent peer
        (reference: switch.go:389 reconnectToPeer)."""
        key = str(na)
        with self._peers_lock:
            if key in self._reconnecting:
                return
            self._reconnecting.add(key)
        try:
            wait = RECONNECT_BASE_WAIT
            for _attempt in range(RECONNECT_ATTEMPTS):
                if not self.is_running:
                    return
                time.sleep(wait + random.random() * wait * 0.1)
                if self._dial_peer(na, persistent=True):
                    return
                wait = min(wait * 2, RECONNECT_MAX_WAIT)
            self.logger.error(
                "gave up reconnecting to persistent peer", addr=str(na)
            )
        finally:
            with self._peers_lock:
                self._reconnecting.discard(key)

    # -- peer management ---------------------------------------------------

    def _add_peer(self, up, persistent: bool = False) -> None:
        if not persistent:
            persistent = any(
                na.id == up.node_info.node_id for na in self._persistent_addrs
            )
        peer = Peer(
            up,
            self._channel_descs,
            on_receive=self._on_peer_receive,
            on_error=self.stop_peer_for_error,
            send_rate=self.config.send_rate,
            recv_rate=self.config.recv_rate,
            is_persistent=persistent,
        )
        with self._peers_lock:
            if peer.id in self.peers:
                up.secret_conn.close()
                return
            self.peers[peer.id] = peer
        # register with reactors BEFORE starting the recv routine so the
        # peer's first messages find their PeerState (reference: InitPeer
        # before peer start, switch.go addPeer)
        for reactor in self.reactors.values():
            try:
                reactor.add_peer(peer)
            except Exception as e:  # noqa: BLE001
                self.logger.error(
                    "reactor add_peer failed", reactor=reactor.name, err=repr(e)
                )
        peer.start()
        self.logger.info(
            "added peer",
            peer=peer.id[:12],
            out=peer.is_outbound,
            n_peers=len(self.peers),
        )

    def _on_peer_receive(self, peer: Peer, chan_id: int, msg: bytes) -> None:
        reactor = self._chan_to_reactor.get(chan_id)
        if reactor is None:
            self.stop_peer_for_error(
                peer, SwitchError(f"message on unknown channel {chan_id:#x}")
            )
            return
        try:
            reactor.receive(chan_id, peer, msg)
        except Exception as e:  # noqa: BLE001
            self.logger.error(
                "reactor receive failed",
                reactor=reactor.name,
                chan=hex(chan_id),
                err=repr(e),
            )
            self.stop_peer_for_error(peer, e)

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """Reference: switch.go:322 StopPeerForError."""
        if not self._remove_peer(peer, reason):
            return
        if peer.is_persistent:
            na = peer.dial_addr() or peer.socket_addr()
            if na is not None:
                threading.Thread(
                    target=self._reconnect_routine, args=(na,), daemon=True
                ).start()

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._remove_peer(peer, "graceful stop")

    def _remove_peer(self, peer: Peer, reason) -> bool:
        with self._peers_lock:
            if self.peers.get(peer.id) is not peer:
                return False
            del self.peers[peer.id]
        peer.stop()
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception as e:  # noqa: BLE001
                self.logger.error(
                    "reactor remove_peer failed",
                    reactor=reactor.name,
                    err=repr(e),
                )
        self.logger.info("removed peer", peer=peer.id[:12], reason=str(reason))
        return True

    # -- messaging ---------------------------------------------------------

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        """Queue to every peer (reference: switch.go:269 Broadcast)."""
        with self._peers_lock:
            peers = list(self.peers.values())
        for p in peers:
            p.try_send(chan_id, msg)

    def peers_list(self) -> list[Peer]:
        with self._peers_lock:
            return list(self.peers.values())

    def num_peers(self) -> tuple[int, int]:
        with self._peers_lock:
            out = sum(1 for p in self.peers.values() if p.is_outbound)
            return out, len(self.peers) - out

    def get_peer(self, node_id: str) -> Optional[Peer]:
        with self._peers_lock:
            return self.peers.get(node_id)
