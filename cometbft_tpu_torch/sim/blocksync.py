"""Deterministic blocksync over the sim fabric.

Drives the REAL ``blocksync.reactor.BlocksyncReactor`` (pool scheduling,
adaptive timeouts/bans/probes, the fused-prefetch verify window) for a
late joiner, with every request and block response riding
``SimNetwork.schedule_transfer`` through the same faulty, bandwidth-shaped
links as gossip — closing ROADMAP 6(b): blocksync was the last reactor
outside the deterministic fault envelope.

Shape (mirrors the statesync join path in ``cluster._statesync_join``,
store-first): the harness assembles the joiner's stores/app/BlockExecutor
standalone, lets the reactor download + verify + apply blocks on the
virtual clock (one ``reactor.tick()`` per repeating clock timer), and only
when the reactor declares itself caught up does the cluster ``_build`` a
full node over the populated db and start its consensus
(``InvariantChecker.on_join`` exempts blocksync-applied heights from the
WAL #ENDHEIGHT check, exactly like statesync-restored ones).

Fault scripting hooks, driven by scenario actions:
  * ``set_mute(src)``    — helper ``src`` goes quiet: block requests to it
    vanish in its NIC (the joiner's adaptive timeout must expire, ban,
    then half-open probe it once unmuted).
  * ``set_tamper(src)``  — helper ``src`` serves blocks whose BODY is
    forged after signing (the header keeps its legitimate commit — only
    ``validate_block`` catches it, taking the redo→ban path).
  * ``crash()``/``cluster.blocksync_restart`` — the joiner process dies
    mid-catchup; its stores survive, and a fresh harness resumes from
    ``block_store.height() + 1`` after an app-replay handshake, the same
    boot a real node does.

The joiner's stores, executor, evidence pool, handshake and reactor, and
each helper's serving reactor, run on the cluster's ``device``.
"""

from __future__ import annotations

import random

from cometbft_tpu_torch.blocksync import stats as bstats
from cometbft_tpu_torch.blocksync.reactor import (
    BLOCKSYNC_CHANNEL,
    _MSG_BLOCK_RESPONSE,
    BlocksyncReactor,
    _enc,
)
from cometbft_tpu_torch.libs import log as liblog

# One reactor scheduler pass per this many virtual seconds (the wall-clock
# loop polls every 20 ms; virtual ticks are free, so a slightly coarser
# cadence keeps the event count down without starving the window).
TICK_INTERVAL = 0.05


class _TraceLogger(liblog.Logger):
    """Routes pool/reactor log lines into the cluster's byte-compared
    trace, so every ban / probe / stall-switch / re-admission is part of
    the determinism contract the soak matrix enforces."""

    def __init__(self, cluster, index: int):
        super().__init__(level=liblog.INFO)
        self._cluster = cluster
        self._index = index

    def _log(self, level: int, msg: str, kv: dict) -> None:
        if level < self.level:
            return
        parts = [msg] + ["%s=%s" % (k, v) for k, v in kv.items()]
        self._cluster._log("bsync node%d %s" % (self._index, " ".join(parts)))


class _JoinerPeer:
    """The joiner as seen by a serving helper: replies ride the fabric
    back (src = helper, dst = joiner), bandwidth-shaped by payload size."""

    def __init__(self, harness, src: int):
        self._h = harness
        self._src = src
        self.id = "joiner%d" % harness.index

    def try_send(self, chan_id: int, msg_bytes: bytes) -> bool:
        h = self._h
        if h.closed:
            return False

        def deliver(m=msg_bytes, s=self._src) -> None:
            if h.closed or h.reactor is None:
                return
            h.reactor.receive(BLOCKSYNC_CHANNEL, h.peers[s], m)

        return h.cluster.net.schedule_transfer(
            self._src,
            h.index,
            deliver,
            label="bsync-resp",
            size_bytes=len(msg_bytes),
        )


class _HelperPeer:
    """A serving helper as seen by the joiner's reactor/pool: requests
    ride the fabric out (src = joiner, dst = helper) and are answered by
    the helper's OWN serving reactor over its live block store."""

    def __init__(self, harness, src: int):
        self._h = harness
        self._src = src
        self.id = "node%d" % src

    def try_send(self, chan_id: int, msg_bytes: bytes) -> bool:
        h = self._h
        src = self._src
        if h.cluster.nodes[src] is None:
            return False  # helper is down: the dial itself fails

        def deliver(m=msg_bytes, s=src) -> None:
            if h.closed:
                return
            node = h.cluster.nodes[s]
            if node is None or h.muted.get(s):
                return  # crashed or wedged helper: the request vanishes
            serve = h.servers.get(s)
            if serve is not None:
                serve.receive(BLOCKSYNC_CHANNEL, h.joiner_views[s], m)

        return h.cluster.net.schedule_transfer(
            h.index,
            src,
            deliver,
            label="bsync-req",
            size_bytes=len(msg_bytes),
        )


class _FakeSwitch:
    """Just enough of ``p2p.Switch`` for the joiner's reactor: peer lookup,
    status broadcast, and the bad-peer disconnect (which the sim logs but
    keeps connected — re-dials are instant here, and keeping the peer is
    what exercises the ban→probe→re-admission arc)."""

    def __init__(self, harness):
        self._h = harness

    @property
    def peers(self) -> dict:
        # id -> peer view, like p2p.Switch.peers (the reactor's status
        # retry enumerates it for range-less peers)
        return {p.id: p for p in self._h.peers.values()}

    def get_peer(self, peer_id: str):
        for p in self._h.peers.values():
            if p.id == peer_id:
                return p
        return None

    def broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        for p in self._h.peers.values():
            p.try_send(chan_id, msg_bytes)

    def stop_peer_for_error(self, peer, err) -> None:
        self._h.log.info("peer errored", peer=peer.id, err=str(err))


def _tamper_block_response(msg_bytes: bytes) -> bytes:
    """Forge the BODY of a served block after signing: decode, swap the
    txs, re-encode.  The wire-carried header (and its commit in the NEXT
    block) stays legitimately signed, so ``verify_commit_light`` passes
    and only ``validate_block``'s body-vs-header check can catch it —
    the exact attack internal/blocksync/reactor.go:546 defends against."""
    from cometbft_tpu_torch.libs import protoenc as pe
    from cometbft_tpu_torch.types import codec

    kind, body = msg_bytes[0], msg_bytes[1:]
    if kind != _MSG_BLOCK_RESPONSE:
        return msg_bytes
    f = pe.fields_dict(body)
    block = codec.decode_block(f[1][-1])
    block.data.txs = list(block.data.txs) + [b"forged-tx"]
    out = pe.t_message(1, codec.encode_block(block), always=True)
    if 2 in f:
        out += pe.t_message(2, f[2][-1], always=True)
    return _enc(_MSG_BLOCK_RESPONSE, out)


class SimBlocksync:
    """One joiner's blocksync session on the virtual clock."""

    def __init__(self, cluster, index: int, helper_indices: list[int]):
        self.cluster = cluster
        self.index = index
        self.helper_indices = list(helper_indices)
        self.closed = False
        self.muted: dict[int, bool] = {}
        self.tampered: dict[int, bool] = {}
        self.log = _TraceLogger(cluster, index)
        self._timer = None
        # A real joiner is a fresh process with a COLD signature cache —
        # in-process the global cache is pre-warmed by the validators' own
        # gossip verification, which would mask every fused-prefetch
        # dispatch the catchup path owes.  Clearing is deterministic: the
        # validators re-warm it on their next verifies, all on the
        # virtual clock.
        from cometbft_tpu_torch.crypto import sigcache as _sigcache

        _sigcache.get_cache().clear()
        self._dispatches_at_start = self._dispatch_count()
        self._build_joiner_side()
        self._build_serving_side()
        self._schedule_tick()

    # -- assembly ----------------------------------------------------------

    def _build_joiner_side(self) -> None:
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.config.config import MempoolConfig
        from cometbft_tpu_torch.consensus.replay import Handshaker
        from cometbft_tpu_torch.evidence.pool import EvidencePool
        from cometbft_tpu_torch.mempool.clist_mempool import CListMempool
        from cometbft_tpu_torch.proxy.multi_app_conn import (
            AppConns,
            local_client_creator,
        )
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.state.state import state_from_genesis
        from cometbft_tpu_torch.state.store import StateStore
        from cometbft_tpu_torch.store.block_store import BlockStore
        from cometbft_tpu_torch.store.kv import MemKV
        from cometbft_tpu_torch.types.events import EventBus

        c = self.cluster
        db = c._dbs[self.index]
        if db is None:
            db = MemKV()
            c._dbs[self.index] = db
        self.app = (
            c.app_factory() if c.app_factory is not None
            else KVStoreApplication()
        )
        self.conns = AppConns(local_client_creator(self.app))
        self.conns.start()
        state_store = StateStore(db)
        block_store = BlockStore(db)
        event_bus = EventBus()
        evidence_pool = EvidencePool(db, state_store, block_store, device=c.device)
        state = state_store.load()
        if state is None:
            state = state_from_genesis(c.gdoc)
        handshaker = Handshaker(
            state_store,
            block_store,
            c.gdoc,
            event_bus=event_bus,
            evidence_pool=evidence_pool,
            device=c.device,
        )
        # fresh joiner: InitChain; crash-restart resume: app replay up to
        # the store height — the same boot path a real node takes
        state = handshaker.handshake(state, self.conns)
        evidence_pool.state = state
        info = self.conns.query.info()
        mempool = CListMempool(
            c.mempool_config or MempoolConfig(recheck=False),
            self.conns.mempool,
            height=state.last_block_height,
            lane_priorities=dict(info.lane_priorities),
            default_lane=info.default_lane,
        )
        block_exec = BlockExecutor(
            state_store,
            block_store,
            self.conns.consensus,
            mempool,
            evidence_pool=evidence_pool,
            event_bus=event_bus,
            device=c.device,
        )
        self.reactor = BlocksyncReactor(
            state,
            block_exec,
            block_store,
            enabled=True,
            logger=self.log,
            clock=self.cluster.clock,
            # private stream: a join must not perturb the fabric's rng
            rng=random.Random((self.cluster.seed << 16) ^ (0xB5 + self.index)),
            device=c.device,
        )
        self.reactor.switch = _FakeSwitch(self)
        self.block_store = block_store

    def _build_serving_side(self) -> None:
        c = self.cluster
        self.peers: dict[int, _HelperPeer] = {}
        self.joiner_views: dict[int, "_TamperingJoinerPeer | _JoinerPeer"] = {}
        self.servers: dict[int, BlocksyncReactor] = {}
        for src in self.helper_indices:
            node = c.nodes[src]
            if node is None:
                continue
            self.peers[src] = _HelperPeer(self, src)
            self.joiner_views[src] = _TamperingJoinerPeer(self, src)
            # a serving-only reactor over the helper's live stores: never
            # started, never syncing — only its receive() serve path runs
            self.servers[src] = BlocksyncReactor(
                node.cs.state,
                None,
                node.block_store,
                enabled=False,
                clock=c.clock,
                device=c.device,
            )
        for p in self.peers.values():
            # announce the joiner and ask for ranges, like Switch.add_peer
            self.reactor.add_peer(p)

    # -- fault scripting ---------------------------------------------------

    def set_mute(self, src: int, on: bool = True) -> None:
        self.muted[src] = on
        self.cluster._log(
            "bsync node%d helper node%d %s"
            % (self.index, src, "muted" if on else "unmuted")
        )

    def set_tamper(self, src: int, on: bool = True) -> None:
        self.tampered[src] = on
        self.cluster._log(
            "bsync node%d helper node%d tamper=%s" % (self.index, src, on)
        )

    # -- the drive loop ----------------------------------------------------

    def _schedule_tick(self) -> None:
        self._timer = self.cluster.clock.call_later(
            TICK_INTERVAL, self._tick, label="bsync node%d" % self.index
        )

    @staticmethod
    def _dispatch_count() -> int:
        from cometbft_tpu_torch.ops import dispatch_stats

        return int(dispatch_stats.snapshot().get("dispatches", 0))

    def _tick(self) -> None:
        if self.closed:
            return
        r = self.reactor
        try:
            progressed = r.tick()
            # drain the received window in this tick: block application is
            # host work, not fabric time
            while r.syncing and progressed:
                progressed = r._process_blocks()
        except Exception as e:  # noqa: BLE001 — surface, don't wedge the sim
            self.log.error("blocksync tick failed", err=repr(e))
        if not r.syncing:
            self._complete()
            return
        self._schedule_tick()

    def _complete(self) -> None:
        s = bstats.snapshot()
        self.cluster._log(
            "bsync node%d complete h=%d dispatches=%d reqs=%d timeouts=%d "
            "bans=%d probes=%d readmits=%d stalls=%d redos=%d"
            % (
                self.index,
                self.block_store.height(),
                self._dispatch_count() - self._dispatches_at_start,
                s["requests"],
                s["timeouts"],
                s["bans"],
                s["probes"],
                s["probe_passes"],
                s["stall_switches"],
                s["redos"],
            )
        )
        self.closed = True
        self._timer = None
        self.cluster._finish_blocksync_join(self)

    def close(self) -> None:
        """Quiet teardown (cluster.stop with a sync still in flight)."""
        if self.closed:
            return
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.conns.stop()

    def crash(self) -> None:
        """Kill the joiner mid-catchup: harness state dies, stores (the
        MemKV in ``cluster._dbs``) survive for a restart."""
        if self.closed:
            return
        h = self.block_store.height()
        self.close()
        self.cluster._log(
            "bsync node%d crashed mid-catchup h=%d" % (self.index, h)
        )


class _TamperingJoinerPeer(_JoinerPeer):
    """Joiner view handed to a helper's serving reactor: applies the
    scripted body-forgery before the response enters the fabric."""

    def try_send(self, chan_id: int, msg_bytes: bytes) -> bool:
        if self._h.tampered.get(self._src):
            msg_bytes = _tamper_block_response(msg_bytes)
        return super().try_send(chan_id, msg_bytes)
