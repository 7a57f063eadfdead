"""The port's blocksync against the JAX package's: the block pool's
scheduling and the reactor's sync of a served chain.

* ``BlockPool``: both packages' pools driven in lockstep under a fake
  clock and a seeded ``random.Random``, as ``tests/test_blocksync_pool.py``
  drives one: status ranges with RTTs, requests, answers, explicit "no
  block" replies, timeouts, strike bans with backoff, half-open probes,
  the stall switch, a redo, a removed peer and the frontier's pops.
  After every step the requests sent, the request table, every peer's
  scheduling state, the frontier and the counters are equal, with
  ``COMETBFT_TPU_BSYNC_ADAPTIVE=0`` bit for bit, and with the adaptive
  scheduling against the JAX pool plus the port's one departure (a
  delivered block restarts the clocks of the peer's other pending
  requests).  The departure's reason: several ~1-3.7 MiB blocks in
  flight from one peer at the default 5,120,000 B/s, which the JAX
  pool times out at its 2 s floor, re-requests and bans.
* ``BlocksyncReactor``: a joiner driven by ``tick()`` against a serving
  reactor through a stub switch, over ``tests/torch_chain``'s 4-validator
  chain of 5 heights (a validator update at height 2, evidence at 3, one
  absent signer in every commit); the same messages go each way, in the
  same order, and the joiner ends at height 4 with the same store bytes
  and state in both packages and the server's blocks 1-4.  Served once
  with block 2's body tampered, the joiner redoes and bans the server in
  both packages, reconnects and syncs the same chain.
* The fused prefetch on the port's ``device="cpu"``:
  ``fused_verify_eligible(..., "cpu")`` answers True (the supervisor's
  ``torch`` tier is live on the CPU), so a window of three or more
  received blocks is verified in one ``verify_segments`` call; the JAX
  package on its CPU backend answers False and never prefetches.

Both packages run with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``; the port's
signature batches go through the supervisor's device-runner seam
answering from the pure-Python oracle, so no plain verify runs.
"""

import dataclasses
import importlib
import random
from collections import deque

import numpy as np
import pytest

import torch_chain as tc
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch import verifysched as tvs

J, P = "cometbft_tpu", "cometbft_tpu_torch"
PKGS = (J, P)
CPU = {"executor_kw": {"device": "cpu"}, "pool_kw": {"device": "cpu"}}
SERVER, JOINER = "5e" * 20, "70" * 20
MAX_TICKS = 2000


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _oracle_runner(log):
    def run(backend, pubs, msgs, sigs, lanes):
        log.append(len(pubs))
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [len(p) == 32 and len(s) == 64 and ref.verify_zip215(p, m, s)
                            for p, m, s in zip(pubs, msgs, sigs)]
        return out
    return run


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()
    for pkg in PKGS:
        mod(pkg, "blocksync.stats").reset()
    yield
    tsup.clear_device_runner()
    tvs.reset_scheduler()
    tsc.reset_cache()
    for pkg in PKGS:
        mod(pkg, "blocksync.stats").reset()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _Header:
    def __init__(self, height: int):
        self.height = height


class _Block:
    def __init__(self, height: int):
        self.header = _Header(height)


CFG = dict(timeout_mult=4.0, timeout_floor=2.0, timeout_cap=30.0, ban_base=2.0,
           ban_cap=16.0, ban_strikes=3, stall_secs=5.0)


# -- the pool in lockstep ----------------------------------------------------


def _jax_pool_with_the_restart(bp):
    """The JAX ``BlockPool`` plus the port's one departure (ROADMAP §3):
    with adaptive scheduling, a delivered block restarts the clocks of the
    peer's other pending requests."""

    class Pool(bp.BlockPool):
        def add_block(self, peer_id, block, ext_commit=None):
            ok = super().add_block(peer_id, block, ext_commit)
            if ok and self.config.adaptive:
                now = self._clock()
                for other in self.requests.values():
                    if other.peer_id == peer_id and other.block is None:
                        other.sent_at = now
            return ok

    return Pool


def _pool_script(pkg, adaptive: bool):
    bp = mod(pkg, "blocksync.pool")
    pool_cls = _jax_pool_with_the_restart(bp) if pkg == J else bp.BlockPool
    clock = FakeClock()
    sent = []
    fail = set()

    def send(peer_id, h):
        sent.append((peer_id, h))
        return (peer_id, h) not in fail

    pool = pool_cls(1, send, clock=clock, rng=random.Random(0),
                    config=bp.PoolConfig(adaptive=adaptive, **CFG))
    trace = []

    def snap(what):
        reqs = {h: (r.peer_id, r.probe, r.block is not None, r.sent_at)
                for h, r in sorted(pool.requests.items())}
        peers = {p: dataclasses.astuple(d) for p, d in sorted(pool.peers.items())}
        first, second, p1, p2, _ = pool.peek_two_blocks()
        window = [(h, pid) for h, _, pid, _ in pool.peek_window(6)]
        trace.append((what, list(sent), reqs, peers, pool.height, pool.is_caught_up(),
                      pool.max_peer_height(), first is not None, second is not None,
                      p1, p2, window, mod(pkg, "blocksync.stats").snapshot()))

    def answer(peer_id, upto):
        for h, r in sorted(pool.requests.items()):
            if r.peer_id == peer_id and r.block is None and h <= upto:
                pool.add_block(peer_id, _Block(h))

    pool.set_peer_range("p1", 1, 30, rtt=0.5)
    pool.set_peer_range("p2", 1, 20)
    pool.set_peer_range("p3", 5, 45, rtt=2.0)
    snap("ranges")
    pool.make_next_requests()
    snap("requests")
    clock.advance(0.4)
    answer("p1", 12)
    answer("p3", 9)
    snap("answers")
    for h, r in sorted(pool.requests.items()):
        if r.peer_id == "p2" and r.block is None:
            pool.no_block("p2", h)
            break
    snap("no_block")
    for _ in range(4):  # timeouts: strikes, then a ban of the mute peers
        clock.advance(16.0)
        pool.make_next_requests()
        snap("timeouts")
    clock.advance(3.0)
    answer("p1", 45)
    pool.make_next_requests()
    snap("after answers")
    while pool.peek_two_blocks()[1] is not None and pool.height < 8:
        pool.pop_request()
    snap("pops")
    pool.redo_request(pool.height)
    snap("redo")
    fail.add(("p3", pool.height))
    for _ in range(3):  # bans expire: half-open probes, stall switches
        clock.advance(6.0)
        pool.make_next_requests()
        answer("p2", 100)
        snap("probes")
    pool.remove_peer("p3")
    snap("remove")
    clock.advance(20.0)
    pool.make_next_requests()
    answer("p1", 100)
    answer("p2", 100)
    while pool.peek_two_blocks()[1] is not None:
        pool.pop_request()
    snap("drained")
    return trace


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "legacy"])
def test_pool_lockstep(adaptive):
    want, got = _pool_script(J, adaptive), _pool_script(P, adaptive)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, g[0]
    stats = got[-1][-1]
    assert stats["bans"] >= 1 and stats["timeouts"] >= 1 and stats["heights_synced"] >= 7
    if adaptive:
        assert stats["probes"] >= 1 and stats["redos"] == 1


# -- the reactor over a stub switch ------------------------------------------


class Link:
    """One direction of a peer link: what the reactor sends lands in
    ``outbox`` (and the shared ``log``) until the test delivers it."""

    def __init__(self, node_id, name, log):
        self.id = node_id
        self.name = name
        self.log = log
        self.outbox = deque()
        self.is_running = True
        self.is_outbound = True

    def try_send(self, chan_id, msg):
        self.log.append((self.name, chan_id, bytes(msg)))
        self.outbox.append((chan_id, bytes(msg)))
        return True

    send = try_send


class StubSwitch:
    def __init__(self):
        self.peers = {}
        self.stopped = []

    def get_peer(self, node_id):
        return self.peers.get(node_id)

    def broadcast(self, chan_id, msg):
        for p in list(self.peers.values()):
            p.try_send(chan_id, msg)

    def stop_peer_for_error(self, peer, err):
        self.stopped.append((peer.id, type(err).__name__))
        self.peers.pop(peer.id, None)


def _sync(pkg, heights: int = 5, tamper_at: int = 0):
    """Serve ``pkg``'s chain to a fresh joiner through ``tick()``.  With
    ``tamper_at`` the first answer for that height carries a changed tx.
    Returns what the test compares."""
    kw = CPU if pkg == P else {}
    dev = {"device": "cpu"} if pkg == P else {}
    br, codec = mod(pkg, "blocksync.reactor"), mod(pkg, "types.codec")
    server, _ = tc.drive(pkg, heights=heights, **kw)
    mod(pkg, "crypto.sigcache").reset_cache()  # a joiner never saw the votes
    joiner = tc.Chain(pkg, **kw)
    clock = FakeClock()
    srv = br.BlocksyncReactor(server.state, server.executor, server.block_store,
                              enabled=False, clock=clock, rng=random.Random(1), **dev)
    jr = br.BlocksyncReactor(joiner.state, joiner.executor, joiner.block_store,
                             enabled=True, clock=clock, rng=random.Random(2), **dev)
    if tamper_at:
        real = server.block_store.load_block
        served = set()

        def load_block(h):
            b = real(h)
            if h == tamper_at and h not in served and b is not None:
                served.add(h)
                b = codec.decode_block(codec.encode_block(b))
                b.data.txs[0] = b.data.txs[0] + b"-tampered"
            return b

        server.block_store.load_block = load_block
    log = []
    # the joiner's peer is the server (what it sends goes to the server),
    # the server's peer is the joiner
    to_srv, to_joiner = Link(SERVER, "joiner->server", log), Link(JOINER, "server->joiner", log)
    sw_j, sw_s = StubSwitch(), StubSwitch()
    jr.set_switch(sw_j)
    srv.set_switch(sw_s)

    def connect():
        sw_j.peers[SERVER] = to_srv
        sw_s.peers[JOINER] = to_joiner
        srv.add_peer(to_joiner)
        jr.add_peer(to_srv)

    connect()
    ticks = reconnects = 0
    while jr.syncing and ticks < MAX_TICKS:
        ticks += 1
        jr.tick()
        if SERVER not in sw_j.peers:
            # the switch stopped the peer; a persistent peer is redialed
            jr.remove_peer(to_srv, "stopped")
            srv.remove_peer(to_joiner, "stopped")
            to_srv.outbox.clear()
            to_joiner.outbox.clear()
            reconnects += 1
            connect()
        while to_srv.outbox or to_joiner.outbox:
            while to_srv.outbox:
                ch, msg = to_srv.outbox.popleft()
                srv.receive(ch, to_joiner, msg)
            while to_joiner.outbox:
                ch, msg = to_joiner.outbox.popleft()
                jr.receive(ch, to_srv, msg)
        clock.advance(0.05)
    assert not jr.syncing, f"{pkg}: not synced after {ticks} ticks at {joiner.block_store.height()}"
    store = list(joiner.db.iterate())
    blocks = [joiner.block_store.load_block(h) for h in range(1, heights)]
    assert [b.hash() for b in blocks] == [server.block_store.load_block(h).hash()
                                          for h in range(1, heights)]
    return {"log": log, "store": store, "state": jr.state.to_json(),
            "height": joiner.block_store.height(), "stopped": sw_j.stopped,
            "reconnects": reconnects, "ticks": ticks,
            "stats": mod(pkg, "blocksync.stats").snapshot()}


def test_reactor_sync_equals_jax():
    verified = []
    tsup.set_device_runner(_oracle_runner(verified))
    want = _sync(J)
    got = _sync(P)
    assert got["log"] == want["log"]
    assert got["store"] == want["store"]
    assert got["state"] == want["state"] and got["height"] == want["height"] == 4
    assert got["stats"] == want["stats"] and got["stats"]["heights_synced"] == 4
    assert not got["stopped"]
    kinds = {msg[0] for _, _, msg in got["log"]}
    assert kinds == {1, 2, 4, 5}  # requests, blocks, status requests and answers
    # the port's prefetch: eligible on the CPU, one fused dispatch of the
    # window's commits, then the authoritative verifies from the cache
    assert mod(P, "types.validation").fused_verify_eligible([], "cpu") is True
    assert tds.snapshot()["fused_batches"] >= 1 and verified


def test_prefetch_eligibility_beside_jax():
    """The JAX package on its CPU backend never prefetches; the port on
    ``device="cpu"`` does, and with ``COMETBFT_TPU_BLOCKSYNC_WINDOW=1`` it
    does not, and the sync is the same."""
    jvals = tc.Chain(J).state.validators
    assert mod(J, "types.validation").fused_verify_eligible([jvals]) is False
    pvals = tc.Chain(P, **CPU).state.validators
    assert mod(P, "types.validation").fused_verify_eligible([pvals], "cpu") is True


def test_reactor_window_off_syncs_the_same(monkeypatch):
    verified = []
    tsup.set_device_runner(_oracle_runner(verified))
    with_window = _sync(P)
    fused = tds.snapshot()["fused_batches"]
    tds.reset()
    monkeypatch.setenv("COMETBFT_TPU_BLOCKSYNC_WINDOW", "1")
    without = _sync(P)
    assert fused >= 1 and tds.snapshot()["fused_batches"] == 0
    assert without["store"] == with_window["store"]
    assert without["log"] == with_window["log"]


def test_tampered_block_is_redone_and_banned():
    verified = []
    tsup.set_device_runner(_oracle_runner(verified))
    want = _sync(J, tamper_at=2)
    got = _sync(P, tamper_at=2)
    clean = _sync(P)
    assert got["log"] == want["log"]
    assert got["store"] == want["store"] == clean["store"]
    # the tampered body cuts a different part set: the commit's block id
    # does not match, and the peer is stopped once
    assert got["stopped"] == want["stopped"] and len(got["stopped"]) == 1
    assert got["stopped"][0][0] == SERVER
    assert got["stats"]["redos"] == want["stats"]["redos"] >= 1
    assert got["stats"]["bans"] == want["stats"]["bans"] >= 1
    assert got["reconnects"] == want["reconnects"] >= 1


def test_reactor_device_rule(monkeypatch):
    """With no card and no device the port's reactor raises; the CPU is
    named by ``device="cpu"`` or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the rule's no-card case cannot run")
    c = tc.Chain(P, **CPU)
    br = mod(P, "blocksync.reactor")
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND", raising=False)
    with pytest.raises(Exception):
        br.BlocksyncReactor(c.state, c.executor, c.block_store)
    assert br.BlocksyncReactor(c.state, c.executor, c.block_store, device="cpu").device == "cpu"
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert br.BlocksyncReactor(c.state, c.executor, c.block_store).device is None


def test_a_queue_of_large_blocks_is_progress():
    """One peer, five requests in flight, one block delivered every 1.5 s
    (a ~3.7 MiB block at 5,120,000 B/s with its encoding): in the port
    each delivery restarts the clocks of the peer's other requests, so
    none expires at the 2 s floor and all five arrive once; the JAX pool
    expires the queued ones, re-requests them and strikes the peer
    (ROADMAP §3)."""
    out = {}
    for pkg in PKGS:
        bp = mod(pkg, "blocksync.pool")
        mod(pkg, "blocksync.stats").reset()
        clock = FakeClock()
        sent = []
        pool = bp.BlockPool(1, lambda p, h: sent.append((p, h)) or True, clock=clock,
                            rng=random.Random(0), config=bp.PoolConfig(**CFG))
        pool.set_peer_range("p1", 1, 5, rtt=0.01)  # the status round trip
        pool.make_next_requests()
        served = []
        for k in range(1, 6):
            for _ in range(3):  # scans every 0.5 s while the block is on the wire
                clock.advance(0.5)
                pool.make_next_requests()
            if pool.add_block("p1", _Block(k)):
                served.append(k)
        out[pkg] = (served, len(sent), mod(pkg, "blocksync.stats").snapshot(),
                    pool.peers["p1"].timeout_strikes, pool.peers["p1"].banned_until)
    served, n_sent, stats, strikes, banned = out[P]
    assert served == [1, 2, 3, 4, 5] and n_sent == 5 and stats["timeouts"] == 0
    assert strikes == 0 and banned == 0.0
    j_served, j_sent, j_stats, _, _ = out[J]
    assert j_stats["timeouts"] > 0 and j_sent > 5  # the departure's reason


def _streaming(pkg, arriving: bool):
    """One peer, one request whose block takes 6 s on the wire, scans
    every 0.5 s; ``arriving``: its bytes come in meanwhile (the port's
    ``progress`` seam), else the peer is mute."""
    bp = mod(pkg, "blocksync.pool")
    mod(pkg, "blocksync.stats").reset()
    clock = FakeClock()
    sent = []
    received = {"p1": 0}
    kw = {"progress": received.get} if pkg == P else {}
    pool = bp.BlockPool(1, lambda p, h: sent.append((p, h)) or True, clock=clock,
                        rng=random.Random(0), config=bp.PoolConfig(**CFG), **kw)
    pool.set_peer_range("p1", 1, 1, rtt=0.01)  # the status round trip
    pool.make_next_requests()
    for _ in range(12):
        clock.advance(0.5)
        if arriving:
            received["p1"] += 320_000  # ~3.7 MiB over the 6 s
        pool.make_next_requests()
    served = pool.add_block("p1", _Block(1))
    return served, sent, mod(pkg, "blocksync.stats").snapshot()


def test_a_block_streaming_past_the_floor_is_progress():
    """While a block's bytes arrive, the port's pool keeps its request past
    the 2 s floor and takes the block once; a mute peer's request expires
    at the floor and the peer is struck, as in the JAX pool, which expires
    the streaming request alike (ROADMAP §3)."""
    served, sent, stats = _streaming(P, arriving=True)
    assert served and sent == [("p1", 1)] and stats["timeouts"] == 0
    _, sent, stats = _streaming(P, arriving=False)
    _, j_sent, j_stats = _streaming(J, arriving=False)
    assert stats["timeouts"] > 0 and len(sent) > 1
    assert (sent, stats["timeouts"], stats["bans"]) == (j_sent, j_stats["timeouts"],
                                                        j_stats["bans"])
    _, j_sent, j_stats = _streaming(J, arriving=True)
    assert j_stats["timeouts"] > 0 and len(j_sent) > 1  # the departure's reason


def test_reactor_reads_the_channel_bytes():
    """The reactor's ``progress`` seam is the bytes the peer's connection
    took on the blocksync channel, whole messages and parts alike."""
    from types import SimpleNamespace

    conn = mod(P, "p2p.conn")
    br = mod(P, "blocksync.reactor")
    ch = conn._Channel(conn.ChannelDescriptor(br.BLOCKSYNC_CHANNEL, priority=5,
                                              recv_message_capacity=1 << 20))
    assert ch.recv_packet(b"x" * 1000, False) is None and ch.recv_bytes == 1000
    assert ch.recv_packet(b"y" * 21, True) == b"x" * 1000 + b"y" * 21
    assert ch.recv_bytes == 1021
    peer = SimpleNamespace(conn=SimpleNamespace(channels={br.BLOCKSYNC_CHANNEL: ch}))
    r = br.BlocksyncReactor.__new__(br.BlocksyncReactor)
    r.switch = SimpleNamespace(get_peer={"p1": peer}.get)
    assert r._peer_progress("p1") == 1021 and r._peer_progress("p2") is None
    r.switch = None
    assert r._peer_progress("p1") is None


class _SlowSocket:
    """A socket whose writes go out at ``rate`` bytes a second, 4 KiB at a
    time: a slow link's steady trickle."""

    def __init__(self, sock, rate: int):
        self._sock, self._rate = sock, rate

    def sendall(self, data) -> None:
        import time

        view = memoryview(data)
        for k in range(0, len(view), 4096):
            chunk = view[k:k + 4096]
            self._sock.sendall(chunk)
            time.sleep(len(chunk) / self._rate)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def test_blocks_longer_on_the_wire_than_the_floor_sync():
    """Two port switches over loopback, the server's writes at 40,000 B/s
    (a ``conn_wrapper``), blocks of ~130 KB: each block is on the wire for
    ~3.3 s, past the pool's 2 s floor.  The pool sees its bytes arrive and
    keeps the request, so the joiner syncs with no timeout and no ban;
    under the JAX rule each request expired while it streamed, the server
    queued the block again, and the peer was banned (ROADMAP §3)."""
    import time

    import torch_net as tn

    cfg = mod(P, "config.config")
    tsup.set_device_runner(_oracle_runner([]))
    server = tc.Chain(P, **CPU)
    for h in (1, 2, 3):
        txs = [b"k%d-%04d=" % (h, i) + b"%02x" % (i % 256) * 120 for i in range(500)]
        server.apply(server.make_block(h, txs), absent=(3,))
    tsc.reset_cache()  # a joiner never saw the votes
    joiner = tc.Chain(P, **CPU)
    nodes = []
    try:
        for name, chain, sync in ((b"slow-srv", server, False), (b"slow-joiner", joiner, True)):
            nodes.append(tn.build(
                P, tn.node_key(P, name), tc.CHAIN_ID, p2p_config=cfg.P2PConfig(pex=False),
                state=chain.state, block_exec=chain.executor, block_store=chain.block_store,
                block_sync=sync, device="cpu"))
        srv, jn = nodes
        srv.transport.conn_wrapper = lambda sock: _SlowSocket(sock, 40_000)
        srv.start()
        jn.start([srv.address])
        bs = jn.reactors["BLOCKSYNC"]
        deadline = time.monotonic() + 120
        while bs.syncing and time.monotonic() < deadline:
            time.sleep(0.05)
        stats = mod(P, "blocksync.stats").snapshot()
        assert not bs.syncing, f"not synced in 120 s: {stats}"
    finally:
        for n in nodes:
            n.stop()
        mod(P, "p2p.handshake_pool").reset_pool()
    assert joiner.block_store.height() == 2, stats
    assert stats["timeouts"] == 0 and stats["bans"] == 0, stats
    assert [joiner.block_store.load_block(h).hash() for h in (1, 2)] == [
        server.block_store.load_block(h).hash() for h in (1, 2)]
