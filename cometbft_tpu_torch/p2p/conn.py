"""MConnection: the multiplexed connection (reference: p2p/conn/connection.go).

Multiplexes N logical channels over one encrypted stream.  Each channel has
a priority and a bounded send queue; the send routine services the channel
with the lowest sent-bytes/priority ratio (reference ``sendPacketMsg``
channel selection, connection.go:540), packetizing messages into
<=1021-byte chunks so each packet fits one AEAD frame.  Ping/pong keepalive
detects dead peers; per-direction flow-rate monitors feed optional rate
limiting.

Threads (the goroutine pair at connection.go:429,590): one send routine and
one recv routine per connection.
"""

from __future__ import annotations

import queue
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from cometbft_tpu_torch.libs.flowrate import Monitor

# packet types
_PKT_PING = 0x01
_PKT_PONG = 0x02
_PKT_MSG = 0x03

# max data per msg packet: AEAD frame (1024) - type(1) - chan(1) - eof(1)
PACKET_DATA_SIZE = 1021

DEFAULT_SEND_QUEUE_CAPACITY = 1
DEFAULT_RECV_MESSAGE_CAPACITY = 22 * 1024 * 1024  # reference: 22MB

PING_INTERVAL = 10.0
PONG_TIMEOUT = 45.0
FLUSH_THROTTLE = 0.01


class MConnectionError(Exception):
    pass


@dataclass
class ChannelDescriptor:
    """Reference: p2p/conn/connection.go:748 ChannelDescriptor."""

    id: int
    priority: int = 1
    send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY
    recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY
    recv_buffer_capacity: int = 4096


class _Channel:
    """Reference: connection.go:773 Channel."""

    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.send_queue: "queue.Queue[bytes]" = queue.Queue(
            maxsize=max(desc.send_queue_capacity, 1)
        )
        self.sending: Optional[bytes] = None  # message being packetized
        self.sent_pos = 0
        self.recv_buf = bytearray()
        self.sent_bytes = 0  # for priority ratios
        self.recv_bytes = 0  # a reader's sign that a message is arriving

    def is_send_pending(self) -> bool:
        return self.sending is not None or not self.send_queue.empty()

    def next_packet(self) -> tuple[bytes, bool]:
        """-> (data, eof) for the next packet of the in-flight message."""
        if self.sending is None:
            self.sending = self.send_queue.get_nowait()
            self.sent_pos = 0
        data = self.sending[self.sent_pos : self.sent_pos + PACKET_DATA_SIZE]
        self.sent_pos += len(data)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = None
            self.sent_pos = 0
        self.sent_bytes += len(data)
        return data, eof

    def recv_packet(self, data: bytes, eof: bool) -> Optional[bytes]:
        if len(self.recv_buf) + len(data) > self.desc.recv_message_capacity:
            raise MConnectionError(
                f"recv message exceeds capacity on channel {self.desc.id:#x}"
            )
        self.recv_buf += data
        self.recv_bytes += len(data)
        if eof:
            msg = bytes(self.recv_buf)
            self.recv_buf = bytearray()
            return msg
        return None


class MConnection:
    """Reference: p2p/conn/connection.go:80 MConnection.

    ``stream`` provides write_frame(bytes)/read_frame()->bytes (the
    SecretConnection).  ``on_receive(chan_id, msg_bytes)`` is called from
    the recv routine; ``on_error(exc)`` once, on any fatal error.
    """

    def __init__(
        self,
        stream,
        channel_descs: list[ChannelDescriptor],
        on_receive: Callable[[int, bytes], None],
        on_error: Callable[[Exception], None],
        send_rate: int = 0,  # bytes/sec, 0 = unlimited
        recv_rate: int = 0,
        ping_interval: float = PING_INTERVAL,
        pong_timeout: float = PONG_TIMEOUT,
    ):
        self.stream = stream
        self.channels = {d.id: _Channel(d) for d in channel_descs}
        self.on_receive = on_receive
        self.on_error = on_error
        self.send_rate = send_rate
        self.recv_rate = recv_rate
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout

        self.send_monitor = Monitor()
        self.recv_monitor = Monitor()

        self._send_signal = threading.Event()
        self._pong_pending = False
        self._pongs_owed = 0  # pings received, pongs not yet sent
        self._last_pong = time.monotonic()
        self._stopped = threading.Event()
        self._errored = False
        self._err_lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for fn, name in (
            (self._send_routine, "mconn-send"),
            (self._recv_routine, "mconn-recv"),
        ):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        self._send_signal.set()
        try:
            self.stream.close()
        except Exception:  # noqa: BLE001
            pass

    @property
    def is_running(self) -> bool:
        return not self._stopped.is_set()

    def _fatal(self, e: Exception) -> None:
        with self._err_lock:
            if self._errored:
                return
            self._errored = True
        self.stop()
        self.on_error(e)

    # -- sending -----------------------------------------------------------

    def send(self, chan_id: int, msg: bytes, timeout: float = 10.0) -> bool:
        """Block until the message is queued (reference Send semantics:
        blocks on a full queue, returns False on timeout/closed)."""
        ch = self.channels.get(chan_id)
        if ch is None:
            raise MConnectionError(f"unknown channel {chan_id:#x}")
        if self._stopped.is_set():
            return False
        try:
            ch.send_queue.put(msg, timeout=timeout)
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send (reference TrySend)."""
        ch = self.channels.get(chan_id)
        if ch is None:
            raise MConnectionError(f"unknown channel {chan_id:#x}")
        if self._stopped.is_set():
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def _select_channel(self) -> Optional[_Channel]:
        """Lowest sent_bytes/priority ratio among channels with data
        (reference: connection.go:540 sendPacketMsg)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.sent_bytes / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _write_frames(self, frames: "list[bytes]") -> None:
        """One coalesced write when the stream supports it (the
        SecretConnection transport plane seals the whole flush in one
        AEAD pass); per-frame writes otherwise.  Same bytes either way."""
        wf = getattr(self.stream, "write_frames", None)
        if wf is not None:
            wf(frames)
        else:
            for f in frames:
                self.stream.write_frame(f)

    def _send_routine(self) -> None:
        last_ping = time.monotonic()
        try:
            while not self._stopped.is_set():
                # collect this wakeup's frames — pings, pongs and packets —
                # and flush them as ONE coalesced write at the end
                frames: "list[bytes]" = []
                now = time.monotonic()
                if now - last_ping >= self.ping_interval:
                    frames.append(bytes([_PKT_PING]))
                    last_ping = now
                    if self._pong_pending and (
                        now - self._last_pong > self.pong_timeout
                    ):
                        raise MConnectionError("pong timeout")
                    self._pong_pending = True
                # pongs are written HERE, not in the recv routine: the AEAD
                # send nonce is a sequential counter, so all writes must come
                # from one thread (reference: pongs go through send channels)
                while self._pongs_owed > 0:
                    self._pongs_owed -= 1
                    frames.append(bytes([_PKT_PONG]))

                sent_any = False
                # batch up to 10 packets per wakeup, then re-check signals
                for _ in range(10):
                    ch = self._select_channel()
                    if ch is None:
                        break
                    data, eof = ch.next_packet()
                    pkt = (
                        bytes([_PKT_MSG, ch.desc.id, 1 if eof else 0]) + data
                    )
                    if self.send_rate:
                        self.send_monitor.limit(len(pkt), self.send_rate)
                    frames.append(pkt)
                    self.send_monitor.update(len(pkt))
                    sent_any = True
                if frames:
                    self._write_frames(frames)
                if not sent_any:
                    self._send_signal.wait(timeout=FLUSH_THROTTLE * 10)
                    self._send_signal.clear()
        except Exception as e:  # noqa: BLE001
            if not self._stopped.is_set():
                self._fatal(e)

    # -- receiving ---------------------------------------------------------

    def _recv_routine(self) -> None:
        try:
            while not self._stopped.is_set():
                frame = self.stream.read_frame()
                if not frame:
                    continue
                if self.recv_rate:
                    self.recv_monitor.limit(len(frame), self.recv_rate)
                self.recv_monitor.update(len(frame))
                kind = frame[0]
                if kind == _PKT_PING:
                    self._pongs_owed += 1
                    self._send_signal.set()
                elif kind == _PKT_PONG:
                    self._pong_pending = False
                    self._last_pong = time.monotonic()
                elif kind == _PKT_MSG:
                    if len(frame) < 3:
                        raise MConnectionError("short msg packet")
                    chan_id, eof = frame[1], frame[2]
                    ch = self.channels.get(chan_id)
                    if ch is None:
                        raise MConnectionError(
                            f"peer sent unknown channel {chan_id:#x}"
                        )
                    msg = ch.recv_packet(frame[3:], bool(eof))
                    if msg is not None:
                        self.on_receive(chan_id, msg)
                else:
                    raise MConnectionError(f"unknown packet type {kind:#x}")
        except Exception as e:  # noqa: BLE001
            if not self._stopped.is_set():
                self._fatal(e)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        return {
            "send_rate": self.send_monitor.rate(),
            "recv_rate": self.recv_monitor.rate(),
            "channels": {
                f"{cid:#x}": {
                    "send_queue_size": ch.send_queue.qsize(),
                    "sent_bytes": ch.sent_bytes,
                    "recv_bytes": ch.recv_bytes,
                }
                for cid, ch in self.channels.items()
            },
        }
