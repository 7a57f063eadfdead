"""The port's p2p network stack against the JAX package's: node info,
addresses, MConnection packets, the address book, PEX messages, switches
over loopback, and dials between the two packages.

* ``NodeInfo``: JSON bytes equal, the same validation and compatibility
  errors; ``NetAddress`` parsing and printing equal.
* ``MConnection``: a message of 0, 1,021, 1,022 and 70,000 bytes is cut
  into the same packets, written in the same flushes (one
  ``write_frames`` per wakeup of at most 10 packets), and each package
  reassembles the other's packets into the message.
* ``AddrBook``: the same operations give the same file bytes (clock
  fixed), each package loads the other's file, and seeded picks and
  selections agree; PEX requests and answers are the same bytes.
* Two port switches on ``device="cpu"``, each with an echo reactor, dial
  over loopback: both handshakes' ladders ride the handshake pool and
  the frames the AEAD plane (their plain versions on the CPU), and a
  message goes each way.
* One dial each way between a JAX ``Switch`` and a port one, node info
  exchanged and a message each way.  ``COMETBFT_TPU_HANDSHAKE=0`` and
  ``COMETBFT_TPU_AEAD=0`` turn the JAX package's handshake pool and AEAD
  plane off (no JAX program is traced); the port reads the same
  variables, so its side takes the serial path too.

Every wait has a deadline and every switch is stopped in a ``finally``.
"""

import json
import queue
import random
import threading
import time

import pytest

import torch_net as tn
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.p2p import handshake_pool as thp

J, P = "cometbft_tpu", "cometbft_tpu_torch"
CHAIN = "p2p-test-chain"
ECHO = 0x77
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _fresh():
    tds.reset()
    yield
    thp.reset_pool()


def _mods():
    return tn.modules(J), tn.modules(P)


def _wait(cond, what: str, timeout_s: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


# -- node info and addresses -------------------------------------------------


def _info(m, **kw):
    base = dict(node_id="ab" * 20, network=CHAIN, listen_addr="127.0.0.1:26656",
                version="1.0.0", channels=bytes([0x20, 0x21, 0x30]), moniker="m",
                rpc_address="tcp://127.0.0.1:26657")
    base.update(kw)
    return m.node_info.NodeInfo(**base)


INFO_CASES = {
    "ok": {},
    "bad_id": {"node_id": "xyz"},
    "upper_id": {"node_id": "AB" * 20},
    "empty_network": {"network": ""},
    "too_many_channels": {"channels": bytes(range(65))},
    "no_channels": {"channels": b""},
}


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(INFO_CASES))
def test_node_info_json_and_validation(case):
    out = []
    for m in _mods():
        info = _info(m, **INFO_CASES[case])
        raw = info.to_json()
        back = m.node_info.NodeInfo.from_json(raw)
        out.append((raw, back.to_json(), _err(info.validate_basic)))
    assert out[0] == out[1]
    assert json.loads(out[1][0])["channels"] == _info(_mods()[1], **INFO_CASES[case]).channels.hex()
    assert (out[1][2] is None) == (case in ("ok", "no_channels"))


COMPAT_CASES = {
    "ok": {},
    "network": {"network": "other-chain"},
    "protocol": {"p2p_protocol": 8},
    "no_common_channel": {"channels": bytes([0x40])},
    "theirs_empty": {"channels": b""},
}


@pytest.mark.parametrize("case", sorted(COMPAT_CASES))
def test_node_info_compatibility(case):
    got = [_err(lambda: _info(m).compatible_with(_info(m, **COMPAT_CASES[case])))
           for m in _mods()]
    assert got[0] == got[1]
    assert (got[1] is None) == (case in ("ok", "theirs_empty"))


@pytest.mark.parametrize("addr", [
    "ab" * 20 + "@127.0.0.1:26656", "127.0.0.1:1", "ab" * 20 + "@[::1]:80",
    "host.example:26656", "nope", "zz@1.2.3.4:5", ":26656"])
def test_net_address_parse(addr):
    got = []
    for m in _mods():
        try:
            na = m.node_info.NetAddress.parse(addr)
            got.append((str(na), na.dial_string(), na.id))
        except Exception as e:  # noqa: BLE001
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1]


# -- MConnection packets -----------------------------------------------------


class _Stream:
    """A SecretConnection stand-in: ``write_frames`` records each flush;
    ``read_frame`` hands out ``incoming`` frames, then blocks until closed."""

    def __init__(self, incoming=()):
        self.flushes = []
        self.incoming = queue.Queue()
        for f in incoming:
            self.incoming.put(f)
        self.closed = threading.Event()

    def write_frames(self, frames):
        self.flushes.append(list(frames))

    def write_frame(self, frame):
        self.write_frames([frame])

    def read_frame(self):
        while not self.closed.is_set():
            try:
                return self.incoming.get(timeout=0.05)
            except queue.Empty:
                continue
        raise OSError("closed")

    def close(self):
        self.closed.set()


def _packets(m, msg: bytes):
    """The flushes ``m``'s MConnection writes for one queued message."""
    stream = _Stream()
    errors = []
    mc = m.conn.MConnection(stream, [m.conn.ChannelDescriptor(0x30, priority=5)],
                            on_receive=lambda c, b: None, on_error=errors.append,
                            ping_interval=3600.0)
    want = max(1, -(-len(msg) // m.conn.PACKET_DATA_SIZE))
    assert mc.send(0x30, msg)  # queued before the send routine starts
    mc.start()
    try:
        _wait(lambda: sum(map(len, stream.flushes)) >= want, "the packets")
    finally:
        mc.stop()
    assert not errors
    return stream.flushes


def _reassemble(m, frames):
    """The messages ``m``'s MConnection delivers for ``frames``."""
    stream = _Stream(frames)
    got, errors = [], []
    mc = m.conn.MConnection(stream, [m.conn.ChannelDescriptor(0x30, priority=5)],
                            on_receive=lambda c, b: got.append((c, b)),
                            on_error=errors.append, ping_interval=3600.0)
    mc.start()
    try:
        _wait(lambda: got or errors, "the message")
    finally:
        mc.stop()
    assert not errors
    return got


@pytest.mark.parametrize("size", [0, 1021, 1022, 70_000])
def test_mconnection_packet_bytes(size):
    msg = random.Random(size).randbytes(size)
    jm, pm = _mods()
    want, got = _packets(jm, msg), _packets(pm, msg)
    assert got == want
    frames = [f for flush in got for f in flush]
    assert all(len(f) <= 3 + pm.conn.PACKET_DATA_SIZE for f in frames)
    assert [len(fl) for fl in got][:-1] == [10] * (len(got) - 1)
    assert frames[-1][:3] == bytes([0x03, 0x30, 1])
    assert _reassemble(jm, frames) == _reassemble(pm, frames) == [(0x30, msg)]


def test_mconnection_ping_pong_and_errors_agree():
    """A ping is answered by a pong from the send routine; an unknown
    channel and an unknown packet type end the connection with the same
    error in both packages."""
    out = []
    for m in _mods():
        stream = _Stream([bytes([0x01])])
        mc = m.conn.MConnection(stream, [m.conn.ChannelDescriptor(0x30)],
                                on_receive=lambda c, b: None, on_error=lambda e: None,
                                ping_interval=3600.0)
        mc.start()
        try:
            _wait(lambda: stream.flushes, "the pong")
        finally:
            mc.stop()
        errs = []
        for bad in (bytes([0x03, 0x31, 1]) + b"x", bytes([0x09])):
            errors = []
            mc = m.conn.MConnection(_Stream([bad]), [m.conn.ChannelDescriptor(0x30)],
                                    on_receive=lambda c, b: None, on_error=errors.append,
                                    ping_interval=3600.0)
            mc.start()
            try:
                _wait(lambda: errors, "the error")
            finally:
                mc.stop()
            errs.append((type(errors[0]).__name__, str(errors[0])))
        out.append((stream.flushes, errs))
    assert out[0] == out[1]
    assert out[1][0] == [[bytes([0x02])]]


# -- the address book and PEX -----------------------------------------------


def _book_ops(m, path):
    book = m.pex.AddrBook(str(path))
    book.add_our_id("ee" * 20)
    na = m.node_info.NetAddress
    adds = [book.add_address(na.parse(("%02x" % i) * 20 + "@127.0.0.%d:%d" % (i, 26000 + i)),
                             src="cc" * 20) for i in range(1, 9)]
    adds.append(book.add_address(na.parse("ee" * 20 + "@127.0.0.1:1")))  # ours
    adds.append(book.add_address(na.parse("dd" * 20 + "@0.0.0.0:1")))  # strict
    adds.append(book.add_address(na.parse(("%02x" % 1) * 20 + "@127.0.0.1:2")))  # known
    book.mark_good(na.parse(("%02x" % 2) * 20 + "@127.0.0.2:26002"))
    book.mark_good(na.parse("ff" * 20 + "@127.0.0.9:26009"))
    for _ in range(5):
        book.mark_attempt(na.parse(("%02x" % 3) * 20 + "@127.0.0.3:26003"))
    book.mark_attempt(na.parse(("%02x" % 4) * 20 + "@127.0.0.4:26004"))
    book.remove_address(na.parse(("%02x" % 5) * 20 + "@127.0.0.5:26005"))
    random.seed(11)
    picks = [str(book.pick_address(exclude={"ff" * 20})) for _ in range(6)]
    random.seed(12)
    sel = [str(a) for a in book.get_selection(4)]
    book.save()
    return adds, picks, sel, book.size()


def test_addr_book_file_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.25)
    jm, pm = _mods()
    want = _book_ops(jm, tmp_path / "j" / "addrbook.json")
    got = _book_ops(pm, tmp_path / "p" / "addrbook.json")
    assert got == want
    jb = (tmp_path / "j" / "addrbook.json").read_bytes()
    assert (tmp_path / "p" / "addrbook.json").read_bytes() == jb
    # each package loads the other's file and writes the same bytes back
    for m, src, dst in ((pm, "j", "pj"), (jm, "p", "jp")):
        book = m.pex.AddrBook(str(tmp_path / src / "addrbook.json"))
        book.path = str(tmp_path / dst / "addrbook.json")
        book.save()
        assert (tmp_path / dst / "addrbook.json").read_bytes() == jb


class _StubPeer:
    def __init__(self, node_id, outbound=True, listen="127.0.0.1:26656"):
        self.id = node_id
        self.is_outbound = outbound
        self.sent = []
        self._listen = listen
        self.is_running = True

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, msg))
        return True

    send = try_send

    def dial_addr(self):
        return self._na.parse(f"{self.id}@{self._listen}")


def _pex_script(m):
    jbook = m.pex.AddrBook("")
    jbook.add_our_id("ee" * 20)
    for i in range(1, 6):
        jbook.add_address(m.node_info.NetAddress.parse(
            ("%02x" % i) * 20 + "@127.0.0.%d:%d" % (i, 26000 + i)))
    r = m.pex.PEXReactor(jbook)
    a, b = _StubPeer("aa" * 20), _StubPeer("bb" * 20, outbound=False)
    a._na = b._na = m.node_info.NetAddress
    r.add_peer(a)  # outbound: asks for addresses at once
    r.add_peer(b)
    request = m.pex._encode_pex(m.pex._MSG_REQUEST, [])
    random.seed(5)
    r.receive(m.pex.PEX_CHANNEL, b, request)
    r.receive(m.pex.PEX_CHANNEL, b, request)  # too soon: ignored
    answer = m.pex._encode_pex(m.pex._MSG_ADDRS, [
        m.node_info.NetAddress.parse("99" * 20 + "@127.0.0.99:1"),
        m.node_info.NetAddress.parse("98" * 20 + "@0.0.0.0:1")])
    r.receive(m.pex.PEX_CHANNEL, b, answer)  # unsolicited: ignored
    r.receive(m.pex.PEX_CHANNEL, a, answer)
    r.receive(m.pex.PEX_CHANNEL, a, answer)  # answered already: ignored
    return a.sent, b.sent, sorted(str(x) for x in jbook.get_selection(100))


def test_pex_messages():
    jm, pm = _mods()
    assert _pex_script(pm) == _pex_script(jm)
    for kind, addrs in ((1, []), (2, ["ab" * 20 + "@127.0.0.1:2"])):
        nas = [jm.node_info.NetAddress.parse(s) for s in addrs]
        pnas = [pm.node_info.NetAddress.parse(s) for s in addrs]
        assert pm.pex._encode_pex(kind, pnas) == jm.pex._encode_pex(kind, nas)
    a_sent, b_sent, book = _pex_script(pm)
    assert a_sent == [(0, b'{"kind": 1, "addrs": []}')]
    assert len(b_sent) == 1 and "99" * 20 + "@127.0.0.99:1" in book
    assert not any(s.startswith("98") for s in book)


def test_nodekey_files_equal(tmp_path):
    jm, pm = _mods()
    keys = [m.nodekey.NodeKey(m.keys.Ed25519PrivKey.from_seed(b"\x09" * 32)) for m in (jm, pm)]
    for k, name in zip(keys, "jp"):
        k.save(str(tmp_path / name / "node_key.json"))
    assert (tmp_path / "p" / "node_key.json").read_bytes() == (
        tmp_path / "j" / "node_key.json").read_bytes()
    assert keys[0].node_id == keys[1].node_id
    back = pm.nodekey.NodeKey.load(str(tmp_path / "j" / "node_key.json"))
    assert back.node_id == keys[0].node_id
    made = pm.nodekey.NodeKey.load_or_generate(str(tmp_path / "new" / "node_key.json"))
    assert pm.nodekey.NodeKey.load_or_generate(str(tmp_path / "new" / "node_key.json")
                                               ).node_id == made.node_id


# -- switches over loopback --------------------------------------------------


def _echo(pkg, got):
    m = tn.modules(pkg)

    class EchoReactor(m.reactor.Reactor):
        def __init__(self):
            super().__init__("EchoReactor")

        def get_channels(self):
            return [m.conn.ChannelDescriptor(ECHO, priority=1, send_queue_capacity=10)]

        def receive(self, chan_id, peer, msg):
            got.append(msg)
            if msg.startswith(b"ping"):
                peer.try_send(ECHO, b"pong" + msg[4:])

    return ("ECHO", EchoReactor())


def _pair(pkg_a, pkg_b, got_a, got_b, **port_kw):
    cfgs = [tn.modules(p).config.P2PConfig(pex=False) for p in (pkg_a, pkg_b)]
    a = tn.build(pkg_a, tn.node_key(pkg_a, b"echo-a"), CHAIN, p2p_config=cfgs[0],
                 extra_reactors=[_echo(pkg_a, got_a)], **(port_kw if pkg_a == P else {}))
    try:
        b = tn.build(pkg_b, tn.node_key(pkg_b, b"echo-b"), CHAIN, p2p_config=cfgs[1],
                     extra_reactors=[_echo(pkg_b, got_b)], **(port_kw if pkg_b == P else {}))
    except BaseException:
        a.stop()
        raise
    return a, b


def _exchange(a, b, got_a, got_b):
    """``b`` dials ``a`` as a persistent peer; a ping each way, the pongs
    back.  Returns what each side's peer reports of the other."""
    a.start()
    b.start([a.address])
    assert a.wait_peers(1, WAIT_S) and b.wait_peers(1, WAIT_S), "no connection"
    pa, pb = a.switch.peers_list()[0], b.switch.peers_list()[0]
    assert pb.try_send(ECHO, b"ping-from-b") and pa.try_send(ECHO, b"ping-from-a")
    _wait(lambda: len(got_a) == 2 and len(got_b) == 2, "the echoes")
    assert sorted(got_a) == [b"ping-from-b", b"pong-from-a"]
    assert sorted(got_b) == [b"ping-from-a", b"pong-from-b"]
    return pa, pb


def test_port_switches_echo_over_loopback(monkeypatch):
    # a dial waits for its ladder flush; under the whole suite's load the
    # plain ladder's flush can outlast the pool's 5 s, and the dial then
    # sheds to the host ladder: the wait gets a deadline of its own
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE_TIMEOUT_S", str(WAIT_S))
    got_a, got_b = [], []
    a, b = _pair(P, P, got_a, got_b, device="cpu")
    try:
        pa, pb = _exchange(a, b, got_a, got_b)
        assert pa.node_info.node_id == b.node_id and pb.node_info.node_id == a.node_id
        assert pb.is_outbound and not pa.is_outbound and pb.is_persistent
        assert pa.node_info.channels == bytes([ECHO])
        # a message of seven packets: one flush, one pass of the plane
        bulk = b"bulk" + bytes(range(256)) * 27
        assert pb.try_send(ECHO, bulk)
        _wait(lambda: len(got_a) == 3, "the bulk message")
        assert got_a[-1] == bulk
        # the dials' four ladders (two public keys, two exchanges) and the
        # flushes of four frames or more on the plain versions
        ladders = tds.tier_counts("x25519")
        assert ladders["torch"][1] == 4 and ladders["host"] == (0, 0)
        assert tds.tier_counts("aead")["torch"][0] >= 1
    finally:
        b.stop()
        a.stop()
    assert not a.switch.peers_list() and not b.switch.peers_list()


@pytest.mark.parametrize("dialer", ["jax_dials_port", "port_dials_jax"])
def test_cross_package_dial(dialer, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE", "0")
    monkeypatch.setenv("COMETBFT_TPU_AEAD", "0")
    listener, dialing = (P, J) if dialer == "jax_dials_port" else (J, P)
    got_a, got_b = [], []
    a, b = _pair(listener, dialing, got_a, got_b, device="cpu")
    try:
        pa, pb = _exchange(a, b, got_a, got_b)
        assert pa.node_info.to_json() == b.info.to_json()
        assert pb.node_info.to_json() == a.info.to_json()
    finally:
        b.stop()
        a.stop()


def test_switch_rejects_self_and_duplicates():
    """A dial to oneself and a second dial to a connected peer are
    refused by the switch's filter; the peer count stays one."""
    got_a, got_b = [], []
    a, b = _pair(P, P, got_a, got_b, device="cpu")
    try:
        a.start()
        b.start([a.address])
        assert a.wait_peers(1, WAIT_S) and b.wait_peers(1, WAIT_S)
        na = tn.modules(P).node_info.NetAddress
        assert b.switch.dial_peer(na.parse(a.address)) is True  # already a peer
        assert a.switch.dial_peer(na.parse(a.address)) is False  # ourselves
        assert len(a.switch.peers_list()) == len(b.switch.peers_list()) == 1
    finally:
        b.stop()
        a.stop()


def test_transport_device_rule(monkeypatch):
    """With no card and no device the port's transport raises; the CPU is
    named by ``device="cpu"`` or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``."""
    import torch

    m = tn.modules(P)
    key = tn.node_key(P, b"rule")
    info = m.node_info.NodeInfo(node_id=key.node_id, network=CHAIN)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the rule's no-card case cannot run")
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND", raising=False)
    with pytest.raises(Exception):
        m.transport.Transport(key, lambda: info)
    assert m.transport.Transport(key, lambda: info, device="cpu").device == "cpu"
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert m.transport.Transport(key, lambda: info).device is None
