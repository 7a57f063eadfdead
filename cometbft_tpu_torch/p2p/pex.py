"""Peer exchange (PEX) reactor + file-backed address book.

Reference: p2p/pex/{pex_reactor.go,addrbook.go} — channel 0x00; peers
request addresses at most once per interval; the address book keeps
new/old buckets (simplified here to attempt-count aging), persists to
JSON, and feeds the dial loop that keeps the node at its outbound target.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.node_info import NetAddress
from cometbft_tpu_torch.p2p.reactor import Reactor

PEX_CHANNEL = 0x00

_MSG_REQUEST = 1
_MSG_ADDRS = 2

MAX_ADDRS_PER_MSG = 100
REQUEST_INTERVAL = 30.0
ENSURE_PEERS_INTERVAL = 3.0
OLD_AFTER_MARK_GOOD = 1  # attempts bucket -> old bucket


@dataclass
class KnownAddress:
    """Reference: p2p/pex/known_address.go."""

    addr: str  # id@host:port
    src: str = ""  # node id we learned it from
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket: str = "new"  # "new" | "old"

    def net_address(self) -> NetAddress:
        return NetAddress.parse(self.addr)


class AddrBook:
    """File-backed address book (reference: p2p/pex/addrbook.go)."""

    MAX_ATTEMPTS = 5

    def __init__(self, path: str = "", strict: bool = True):
        self.path = path
        self.strict = strict
        self._addrs: dict[str, KnownAddress] = {}  # keyed by node id
        self._lock = threading.Lock()
        self._our_ids: set[str] = set()
        if path and os.path.exists(path):
            self.load()

    def add_our_id(self, node_id: str) -> None:
        self._our_ids.add(node_id)
        with self._lock:
            self._addrs.pop(node_id, None)

    def add_address(self, na: NetAddress, src: str = "") -> bool:
        if not na.id or na.id in self._our_ids:
            return False
        if self.strict and na.host in ("0.0.0.0", ""):
            return False
        with self._lock:
            if na.id in self._addrs:
                return False
            self._addrs[na.id] = KnownAddress(addr=str(na), src=src)
            return True

    def remove_address(self, na: NetAddress) -> None:
        with self._lock:
            self._addrs.pop(na.id, None)

    def mark_attempt(self, na: NetAddress) -> None:
        with self._lock:
            ka = self._addrs.get(na.id)
            if ka:
                ka.attempts += 1
                ka.last_attempt = time.time()
                if ka.attempts >= self.MAX_ATTEMPTS and ka.bucket == "new":
                    del self._addrs[na.id]  # unreachable new addr: drop

    def mark_good(self, na: NetAddress) -> None:
        with self._lock:
            ka = self._addrs.get(na.id)
            if ka is None:
                ka = KnownAddress(addr=str(na))
                self._addrs[na.id] = ka
            ka.attempts = 0
            ka.last_success = time.time()
            ka.bucket = "old"

    def pick_address(self, exclude: set[str]) -> Optional[NetAddress]:
        """Biased random pick, preferring old (proven) addresses
        (reference: addrbook.go PickAddress)."""
        with self._lock:
            cands = [
                ka
                for ka in self._addrs.values()
                if ka.net_address().id not in exclude
            ]
        if not cands:
            return None
        old = [ka for ka in cands if ka.bucket == "old"]
        pool = old if old and random.random() < 0.7 else cands
        return random.choice(pool).net_address()

    def get_selection(self, n: int = MAX_ADDRS_PER_MSG) -> list[NetAddress]:
        with self._lock:
            addrs = [ka.net_address() for ka in self._addrs.values()]
        random.shuffle(addrs)
        return addrs[:n]

    def size(self) -> int:
        with self._lock:
            return len(self._addrs)

    def is_empty(self) -> bool:
        return self.size() == 0

    # -- persistence -------------------------------------------------------

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            doc = [
                {
                    "addr": ka.addr,
                    "src": ka.src,
                    "attempts": ka.attempts,
                    "last_success": ka.last_success,
                    "bucket": ka.bucket,
                }
                for ka in self._addrs.values()
            ]
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addrs": doc}, f, indent=1)
        os.replace(tmp, self.path)

    def load(self) -> None:
        with open(self.path) as f:
            doc = json.load(f)
        with self._lock:
            for d in doc.get("addrs", []):
                try:
                    na = NetAddress.parse(d["addr"])
                except Exception:  # noqa: BLE001
                    continue
                self._addrs[na.id] = KnownAddress(
                    addr=d["addr"],
                    src=d.get("src", ""),
                    attempts=d.get("attempts", 0),
                    last_success=d.get("last_success", 0.0),
                    bucket=d.get("bucket", "new"),
                )


def _encode_pex(kind: int, addrs: list[NetAddress]) -> bytes:
    doc = {"kind": kind, "addrs": [str(a) for a in addrs]}
    return json.dumps(doc).encode()


def _decode_pex(raw: bytes) -> tuple[int, list[NetAddress]]:
    doc = json.loads(raw.decode())
    addrs = []
    for s in doc.get("addrs", [])[: MAX_ADDRS_PER_MSG]:
        try:
            addrs.append(NetAddress.parse(s))
        except Exception:  # noqa: BLE001
            continue
    return doc.get("kind", 0), addrs


class PEXReactor(Reactor):
    """Reference: p2p/pex/pex_reactor.go:22."""

    def __init__(
        self,
        book: AddrBook,
        seeds: Optional[list[str]] = None,
        seed_mode: bool = False,
        logger=None,
    ):
        super().__init__("PEXReactor")
        self.book = book
        self.seeds = seeds or []
        self.seed_mode = seed_mode
        self.logger = logger or liblog.nop_logger()
        self._last_request: dict[str, float] = {}
        self._requested: set[str] = set()
        self._ticker: Optional[threading.Thread] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=PEX_CHANNEL,
                priority=1,
                send_queue_capacity=10,
                recv_message_capacity=64 * 1024,
            )
        ]

    def on_start(self) -> None:
        self._ticker = threading.Thread(
            target=self._ensure_peers_routine, name="pex-ensure", daemon=True
        )
        self._ticker.start()

    def on_stop(self) -> None:
        self.book.save()

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer) -> None:
        na = peer.dial_addr()
        if na is not None:
            self.book.add_address(na, src=peer.id)
        if peer.is_outbound and not self.seed_mode:
            self._request_addrs(peer)

    def remove_peer(self, peer, reason) -> None:
        self._requested.discard(peer.id)

    # -- messages ----------------------------------------------------------

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, addrs = _decode_pex(msg_bytes)
        if kind == _MSG_REQUEST:
            now = time.monotonic()
            last = self._last_request.get(peer.id, 0.0)
            if now - last < REQUEST_INTERVAL / 2 and last > 0:
                self.logger.debug("pex request too soon", peer=peer.id[:12])
                return
            self._last_request[peer.id] = now
            sel = self.book.get_selection()
            peer.try_send(PEX_CHANNEL, _encode_pex(_MSG_ADDRS, sel))
        elif kind == _MSG_ADDRS:
            if peer.id not in self._requested:
                return  # unsolicited
            self._requested.discard(peer.id)
            for na in addrs:
                if na.id:
                    self.book.add_address(na, src=peer.id)

    def _request_addrs(self, peer) -> None:
        if peer.id in self._requested:
            return
        self._requested.add(peer.id)
        peer.try_send(PEX_CHANNEL, _encode_pex(_MSG_REQUEST, []))

    # -- dial loop (reference: pex_reactor.go ensurePeersRoutine) ----------

    def _ensure_peers_routine(self) -> None:
        while self.is_running:
            time.sleep(ENSURE_PEERS_INTERVAL * (0.75 + random.random() / 2))
            if not self.is_running:
                return
            try:
                self._ensure_peers()
            except Exception as e:  # noqa: BLE001
                self.logger.error("ensure peers failed", err=repr(e))

    def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None:
            return
        out, inb = sw.num_peers()
        need = sw.config.max_num_outbound_peers - out
        if need <= 0:
            return
        connected = {p.id for p in sw.peers_list()}
        with sw._peers_lock:
            dialing = set(sw._dialing)
        tried = 0
        while tried < need:
            na = self.book.pick_address(exclude=connected)
            if na is None:
                break
            tried += 1
            if str(na) in dialing:
                continue
            threading.Thread(
                target=sw.dial_peer, args=(na,), daemon=True
            ).start()
        # ask a random connected peer for more addresses
        peers = sw.peers_list()
        if peers and self.book.size() < 100:
            self._request_addrs(random.choice(peers))
        # fall back to seeds when the book is empty
        if self.book.is_empty() and self.seeds:
            sw.dial_peers_async(list(self.seeds))
