"""The port's ``p2p/latency.py`` and ``p2p/fuzz.py`` held to the JAX
package's.

- ``ZoneMatrix.from_config`` over matrices drawn from one
  ``random.Random`` seed gives the same one-way delay for every zone pair
  (exact floats).
- Two port ``Transport``s on ``device="cpu"`` in different zones: the dial
  wraps each raw socket in a ``DelayedSocket``, arms it with the pair's
  one-way delay after the handshake, and a message's round trip over the
  upgraded connection takes at least the matrix's RTT; a link inside one
  zone at least its own.
- ``FuzzedConnection`` makes the same drop, delay and kill decisions as the
  JAX one for a seed (the sleeps recorded, not slept): exact sequences.

Every socket listens on 127.0.0.1 and every wait is bounded.
"""

import random
import socket
import threading
import time

import pytest

from cometbft_tpu.p2p import fuzz as jfuzz
from cometbft_tpu.p2p import latency as jlat
from cometbft_tpu_torch.p2p import fuzz as tfuzz
from cometbft_tpu_torch.p2p import handshake_pool
from cometbft_tpu_torch.p2p import latency as tlat
from cometbft_tpu_torch.p2p.node_info import NetAddress, NodeInfo
from cometbft_tpu_torch.p2p.transport import Transport

import torch_net

SEED = 20261025
ZONES = ["", "eu", "us", "ap", "zz"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zone_matrix_from_config_equals_jax(seed):
    rng = random.Random(SEED + seed)
    cfg = {a: {b: rng.choice([0, 1, 20, 60.5, 150]) for b in ZONES[1:4] if rng.random() < 0.7}
           for a in ZONES[1:4]}
    default = rng.choice([0.0, 30.0])
    jm, tm = jlat.ZoneMatrix.from_config(cfg, default), tlat.ZoneMatrix.from_config(cfg, default)
    assert tm.rtt_ms == jm.rtt_ms and tm.default_ms == jm.default_ms
    for a in ZONES:
        for b in ZONES:
            assert tm.one_way_s(a, b) == jm.one_way_s(a, b), (a, b)


def _transport(name: bytes, zone: str, matrix, zones: dict):
    key = torch_net.node_key("cometbft_tpu_torch", name)
    info = NodeInfo(node_id=key.node_id, network="zone-chain")
    return key, Transport(key, lambda: info, handshake_timeout=60.0,
                          latency=(zone, matrix, zones), device="cpu")


@pytest.mark.parametrize("zones,rtt_ms", [(("eu", "us"), 120.0), (("eu", "eu"), 40.0)])
def test_two_zoned_transports_measure_at_least_the_matrix_rtt(zones, rtt_ms):
    matrix = tlat.ZoneMatrix.from_config({"eu": {"eu": 40, "us": 120}, "us": {"us": 40}})
    ka = torch_net.node_key("cometbft_tpu_torch", b"zone-a")
    kb = torch_net.node_key("cometbft_tpu_torch", b"zone-b")
    peer_zones = {ka.node_id: zones[0], kb.node_id: zones[1]}
    _, ta = _transport(b"zone-a", zones[0], matrix, peer_zones)
    _, tb = _transport(b"zone-b", zones[1], matrix, peer_zones)
    host, port = tb.listen("tcp://127.0.0.1:0")
    got = {}
    server = threading.Thread(target=lambda: got.__setitem__("b", tb.accept()), daemon=True)
    server.start()
    conns = []
    try:
        a = ta.dial(NetAddress(kb.node_id, host, port))
        conns.append(a.secret_conn)
        server.join(60)
        assert not server.is_alive()
        b = got["b"]
        conns.append(b.secret_conn)
        assert a.node_info.node_id == kb.node_id and b.node_info.node_id == ka.node_id

        def echo():
            for _ in range(3):
                b.secret_conn.write_frame(b.secret_conn.read_frame())

        peer = threading.Thread(target=echo, daemon=True)
        peer.start()
        rtts = []
        for k in range(3):
            t0 = time.monotonic()
            a.secret_conn.write_frame(b"ping-%d" % k)
            assert a.secret_conn.read_frame() == b"ping-%d" % k
            rtts.append(time.monotonic() - t0)
        peer.join(30)
        assert not peer.is_alive()
        assert min(rtts) >= rtt_ms / 1e3, (rtts, rtt_ms)
    finally:
        for sc in conns:
            sc.close()
        ta.close()
        tb.close()
        handshake_pool.reset_pool()


class _Recorder:
    """A socket stand-in that records what reaches it."""

    def __init__(self):
        self.ops = []

    def sendall(self, data):
        self.ops.append(("send", data))

    def recv(self, n):
        self.ops.append(("recv", n))
        return b"r" * n

    def close(self):
        self.ops.append(("close",))

    def settimeout(self, t):
        self.ops.append(("timeout", t))

    def shutdown(self, how):
        self.ops.append(("shutdown", how))


def _script(pkg, monkeypatch, cfg_kw: dict, seed: int) -> list:
    """A seeded FuzzedConnection through 200 operations; what reached the
    socket, what came back, and each requested sleep."""
    slept = []
    monkeypatch.setattr(pkg.time, "sleep", lambda s: slept.append(("sleep", s)))
    sock = _Recorder()
    fz = pkg.FuzzedConnection(sock, pkg.FuzzConnConfig(**cfg_kw), rng=random.Random(seed))
    out = []
    for k in range(200):
        try:
            if k % 3 == 2:
                out.append(("got", fz.recv(4)))
            else:
                fz.sendall(b"m%03d" % k)
        except OSError as e:
            out.append(("error", k, str(e)))
    fz.settimeout(1.5)
    fz.close()
    return out + sock.ops + slept


@pytest.mark.parametrize("cfg_kw", [
    dict(mode="drop", prob_drop_rw=0.3),
    dict(mode="delay", prob_drop_rw=0.4, max_delay_s=0.25),
    dict(mode="drop", prob_drop_rw=0.1, prob_sleep=0.3, max_delay_s=0.05),
    dict(mode="drop", prob_drop_rw=0.1, prob_drop_conn=0.02),
])
@pytest.mark.parametrize("seed", [7, 8])
def test_fuzzed_connection_decides_as_jax(monkeypatch, cfg_kw, seed):
    got = _script(tfuzz, monkeypatch, cfg_kw, seed)
    want = _script(jfuzz, monkeypatch, cfg_kw, seed)
    assert got == want
    assert any(op[0] == "send" for op in got)


def test_a_fuzzed_dial_over_a_delayed_socket(monkeypatch):
    """``conn_wrapper`` wraps outside the ``DelayedSocket``: a transport
    with both upgrades a link, and a fuzz config that drops nothing passes
    every frame."""
    matrix = tlat.ZoneMatrix.from_config({"eu": {"us": 20}})
    ka = torch_net.node_key("cometbft_tpu_torch", b"fuzz-a")
    kb = torch_net.node_key("cometbft_tpu_torch", b"fuzz-b")
    zones = {ka.node_id: "eu", kb.node_id: "us"}
    wrapped = []

    def wrap(sock):
        wrapped.append(type(sock).__name__)
        return tfuzz.FuzzedConnection(sock, tfuzz.FuzzConnConfig(prob_drop_rw=0.0),
                                      rng=random.Random(3))

    info = NodeInfo(node_id=ka.node_id, network="zone-chain")
    ta = Transport(ka, lambda: info, handshake_timeout=60.0, conn_wrapper=wrap,
                   latency=("eu", matrix, zones), device="cpu")
    _, tb = _transport(b"fuzz-b", "us", matrix, zones)
    host, port = tb.listen("tcp://127.0.0.1:0")
    got = {}
    server = threading.Thread(target=lambda: got.__setitem__("b", tb.accept()), daemon=True)
    server.start()
    conns = []
    try:
        a = ta.dial(NetAddress(kb.node_id, host, port))
        conns.append(a.secret_conn)
        server.join(60)
        assert not server.is_alive()
        conns.append(got["b"].secret_conn)
        a.secret_conn.write_frames([b"x" * 100, b"y" * 200])
        assert [got["b"].secret_conn.read_frame() for _ in range(2)] == [b"x" * 100, b"y" * 200]
        assert wrapped == ["DelayedSocket"]
    finally:
        for sc in conns:
            sc.close()
        ta.close()
        tb.close()
        handshake_pool.reset_pool()


def test_delayed_socket_keeps_order_as_jax():
    """The same writes, delay armed mid-stream, through both packages'
    ``DelayedSocket``: the same bytes in the same order on the far end."""
    out = []
    for pkg in (jlat, tlat):
        a, b = socket.socketpair()
        d = pkg.DelayedSocket(a)
        try:
            d.sendall(b"fast,")
            d.set_delay(0.02)
            for k in range(5):
                d.sendall(b"s%d," % k)
            want = 5 + 5 * 3
            b.settimeout(10)
            data = b""
            while len(data) < want:
                data += b.recv(want - len(data))
            out.append((data, d.delay_s))
        finally:
            d.close()
            b.close()
    assert out[0] == out[1] == (b"fast,s0,s1,s2,s3,s4,", 0.02)
