"""Evidence gossip reactor (reference: internal/evidence/reactor.go).

Channel 0x38 (reference: reactor.go:17 EvidenceChannel).  One broadcast
thread per peer streams the pool's pending evidence; incoming evidence is
verified by the pool before being admitted (and then gossiped onward by
our own broadcast threads).
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.evidence import EvidenceError

EVIDENCE_CHANNEL = 0x38
_BROADCAST_SLEEP = 0.1


class EvidenceReactor(Reactor):
    """Reference: internal/evidence/reactor.go Reactor."""

    def __init__(self, pool, logger=None):
        super().__init__("EvidenceReactor")
        self.pool = pool
        self.logger = logger or liblog.nop_logger()
        self._peer_routines: dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                EVIDENCE_CHANNEL,
                priority=6,
                send_queue_capacity=10,
                recv_message_capacity=1024 * 1024,
            )
        ]

    def add_peer(self, peer) -> None:
        stop = threading.Event()
        with self._lock:
            self._peer_routines[peer.id] = stop
        threading.Thread(
            target=self._broadcast_routine,
            args=(peer, stop),
            name="evidence-broadcast",
            daemon=True,
        ).start()

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            stop = self._peer_routines.pop(peer.id, None)
        if stop is not None:
            stop.set()

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            ev = codec.decode_evidence(msg_bytes)
        except (ValueError, KeyError) as e:
            self.logger.debug("undecodable evidence", peer=peer.id[:12])
            if self.switch is not None:
                self.switch.stop_peer_for_error(peer, e)
            return
        try:
            self.pool.add_evidence(ev)
        except EvidenceError as e:
            self.logger.debug(
                "rejected peer evidence", err=str(e), peer=peer.id[:12]
            )

    def _broadcast_routine(self, peer, stop: threading.Event) -> None:
        sent: set[bytes] = set()
        while self.is_running and peer.is_running and not stop.is_set():
            advanced = False
            for ev in self.pool.all_pending():
                h = ev.hash()
                if h in sent:
                    continue
                if peer.try_send(EVIDENCE_CHANNEL, codec.encode_evidence(ev)):
                    sent.add(h)
                    advanced = True
            if not advanced:
                time.sleep(_BROADCAST_SLEEP)
