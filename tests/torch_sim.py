"""A seeded four-validator network on virtual time, driven through either
package's consensus core by name.

``Cluster("cometbft_tpu", ...)`` and ``Cluster("cometbft_tpu_torch", ...)``
run the same script: four validators built by the package's
``sim/node.build_node`` (``threaded=False``, each on a ``SimTicker`` of
one ``VirtualClock``), wired by its ``sim/network.SimNetwork`` (one
``random.Random(seed)`` for the links' delays and faults), with its
``sim/invariants.InvariantChecker`` run after every event.  The drive loop
mirrors the JAX package's ``sim/cluster.SimCluster`` (``_build``,
``_broadcast``, ``crash``/``restart``, ``_on_deliver``, ``_drain_all``,
``step``, ``run``, the catchup tick and ``join``: a statesync of a fresh
node on the virtual clock, through ``sim/node.HandleProvider``), without
its blocksync and churn.  As there, the package's flight recorder
(``libs/tracing``) runs on the virtual clock, reset when the cluster is
built, and each node keeps its own black box (``libs/blackbox``,
synchronous, records routed by the node whose work is running): a crash
kills the journal's unflushed tail, a restart logs the dead journal's
postmortem into the trace, and ``stop`` closes every journal cleanly and
gives the tracer back its wall clock.  Each time the network's top height
grows, every live node's mempool is offered the next height's
``txs_per_height`` KVStore txs (from a numpy seed), standing in for the
mempool reactor.

The module imports neither package at the top: ``chip_smoke.py`` loads it
to run the same drive loop on the card, and the jax-free subprocess of
``tests/test_torch_import_audit.py`` drives the port with it.
"""

from __future__ import annotations

import importlib
import random
import shutil
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np

CHAIN_ID = "sim-chain"
N_VALS = 4
TX_SEED = 7
CATCHUP_INTERVAL = 0.5  # virtual seconds between catchup scans
PORT = "cometbft_tpu_torch"

_MODULES = {
    "blackbox": "libs.blackbox",
    "tracing": "libs.tracing",
    "messages": "consensus.messages",
    "block": "types.block",
    "clock": "sim.clock",
    "invariants": "sim.invariants",
    "network": "sim.network",
    "node": "sim.node",
    "state": "state.state",
}


def modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(pkg=pkg, **{k: importlib.import_module(f"{pkg}.{v}")
                                       for k, v in _MODULES.items()})


def txs_at(height: int, n: int) -> list:
    """``n`` KVStore txs (``key=value``) offered before ``height``."""
    rng = np.random.default_rng(TX_SEED * 1000 + height)
    return [b"k%d-%d=%s" % (height, i, rng.bytes(12).hex().encode())
            for i in range(n)]


def describe_msg(m, msg) -> str:
    """The JAX ``sim/cluster.describe_msg``: one deterministic line per
    message, with a signature prefix so byte-level divergence shows."""
    if isinstance(msg, m.messages.ProposalMessage):
        p = msg.proposal
        return "Proposal h=%d r=%d blk=%s sig=%s" % (
            p.height, p.round_, p.block_id.hash.hex()[:12], p.signature.hex()[:12])
    if isinstance(msg, m.messages.BlockPartMessage):
        return "BlockPart h=%d r=%d i=%d" % (msg.height, msg.round_, msg.part.index)
    if isinstance(msg, m.messages.VoteMessage):
        v = msg.vote
        return "Vote t=%d h=%d r=%d v%d blk=%s sig=%s" % (
            v.type_, v.height, v.round_, v.validator_index,
            v.block_id.hash.hex()[:12], v.signature.hex()[:12])
    return type(msg).__name__


class Cluster:
    """N_VALS validators of ``pkg`` on one virtual clock, the invariant
    checker raising on a violation.  ``device`` goes to the port's
    ``build_node`` and ``InvariantChecker`` (the JAX package has no such
    parameter); ``links`` updates every link's ``LinkConfig`` (drop,
    reorder, ... faults)."""

    raise_on_violation = True  # read by the InvariantChecker

    def __init__(self, pkg: str, root, seed: int = 0, txs_per_height: int = 0,
                 device=None, links: Optional[dict] = None):
        m = self.m = modules(pkg)
        self.root = Path(root)
        self.config = m.node.sim_consensus_config()
        self.txs_per_height = txs_per_height
        self._dev = {"device": device} if pkg == PORT else {}
        self.clock = m.clock.VirtualClock()
        self.rng = random.Random(seed)
        self.privs, self.gdoc = m.node.make_genesis(N_VALS, CHAIN_ID)
        self.net = m.network.SimNetwork(self.clock, self.rng, N_VALS)
        for cfg in self.net.links.values():
            cfg.update(**(links or {}))
        self.net.deliver_fn = self._on_deliver
        self.net.alive_fn = lambda i: self.nodes[i] is not None
        self.checker = m.invariants.InvariantChecker(
            CHAIN_ID, m.state.state_from_genesis(self.gdoc), **self._dev)
        self.trace: list[str] = []
        self.events_fired = 0
        self._dbs: list = [None] * N_VALS  # MemKV survives crash-restart
        # the flight recorder on the virtual clock, reset per cluster (span
        # ids and anomaly dumps become a pure function of the seed), and
        # one synchronous black box a node, as the JAX SimCluster has
        self.tracer = m.tracing.get_tracer()
        self.tracer.reset()
        self.tracer.set_clock(self.clock.now)
        self.active_node: Optional[int] = None
        self.blackbox: dict = {}
        self.postmortems: list = []
        self._bb_prev_sinks: Optional[dict] = None
        if m.blackbox.enabled():
            self._bb_prev_sinks = {
                k: m.tracing.set_sink(k, fn) for k, fn in self._bb_sinks().items()}
        self.nodes: list = [self._build(i) for i in range(N_VALS)]
        self.members = set(range(N_VALS))
        self._started = False
        self._fed = 0  # heights whose txs were offered

    # -- assembly ----------------------------------------------------------

    def _build(self, i: int, app=None, app_conns=None):
        node = self.m.node.build_node(
            i, self.privs[i], self.gdoc, self.root, config=self.config,
            db=self._dbs[i], clock=self.clock,
            ticker_factory=lambda tock, i=i: self.m.clock.SimTicker(
                self.clock, tock, name=f"node{i}"),
            threaded=False, app=app, app_conns=app_conns, **self._dev)
        self._dbs[i] = node.block_store._db
        node.cs.trace_origin = i
        node.cs.broadcast_hook = lambda msg, i=i: self._broadcast(i, msg)
        if self._bb_prev_sinks is not None:
            # no periodic health records: their counter snapshots carry
            # wall-clock aggregates, which would break the journal's bytes
            j = self.m.blackbox.BlackboxJournal(
                str(self.root / f"node{i}" / "blackbox"), threaded=False,
                clock=self.clock.now, health_every=None)
            j.on_event("boot", {"node": i})
            self.blackbox[i] = j
        repair = node.cs.wal.last_repair if node.cs.wal is not None else None
        if repair is not None:
            self._log("node%d wal_repair: truncated %d torn byte(s) to %d"
                      % (i, repair["dropped_bytes"], repair["good_bytes"]))
            j = self.blackbox.get(i)
            if j is not None and not j.closed:
                j.on_event("wal_repair", {"node": i, **repair})
        return node

    # -- black-box routing (the JAX SimCluster's): records go to the journal
    # of the node whose work runs (``active_node``), else to the one a
    # consensus record names; cluster-level work is nobody's

    def _bb_target(self, attrs=None):
        i = self.active_node
        if i is None and attrs:
            i = attrs.get("node")
        j = self.blackbox.get(i) if i is not None else None
        return j if j is not None and not j.closed else None

    def _bb_sinks(self) -> dict:
        def span(sp):
            j = self._bb_target(sp.attrs)
            if j is not None:
                j.on_span(sp)

        def open_(sp):
            j = self._bb_target(sp.attrs)
            if j is not None:
                j.on_open(sp)

        def anomaly(kind, attrs, t):
            j = self._bb_target(attrs)
            if j is not None:
                j.on_anomaly(kind, attrs, t)

        def event(kind, attrs):
            j = self._bb_target(attrs)
            if j is not None:
                j.on_event(kind, attrs)

        return {"span": span, "open": open_, "anomaly": anomaly, "event": event}

    def _broadcast(self, i: int, msg) -> None:
        node = self.nodes[i]
        ctx = None
        if node is not None:
            # current_trace_ctx already gates on tracing.xnode_enabled()
            tc = node.cs.current_trace_ctx()
            ctx = tc.encode() if tc is not None else None
        self.net.send(i, msg, ctx=ctx)

    def live_nodes(self) -> list:
        return [n for n in self.nodes if n is not None]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._feed()
        for node in self.live_nodes():
            self._log("start node%d" % node.index)
            self._start_cs(node)
        self.clock.call_later(CATCHUP_INTERVAL, self._catchup_tick, label="catchup")
        self._drain_all()

    def _start_cs(self, node) -> None:
        """Start a node's consensus with ``active_node`` set, so the round
        anchor its start opens routes to the node's own journal."""
        self.active_node = node.index
        try:
            node.cs.start()
        finally:
            self.active_node = None

    def stop(self) -> None:
        for node in self.live_nodes():
            node.cs.stop()
            node.app_conns.stop()
        for j in self.blackbox.values():
            if not j.closed:
                j.close(clean=True)
        if self._bb_prev_sinks is not None:
            for k, fn in self._bb_prev_sinks.items():
                self.m.tracing.set_sink(k, fn)
            self._bb_prev_sinks = None
        self.tracer.set_clock(None)

    def crash(self, i: int) -> None:
        """Kill node i; its stores, WAL and privval files survive."""
        node = self.nodes[i]
        if node is None:
            return
        self._log("crash node%d" % i)
        self.nodes[i] = None
        if node.cs.wal is not None:
            node.cs.wal.kill()
        j = self.blackbox.get(i)
        if j is not None:
            # the journal's unflushed tail dies with the process, as the
            # WAL's does
            j.kill()
        node.cs.stop()
        node.app_conns.stop()

    def restart(self, i: int) -> None:
        """Rebuild node i from its stores: the Handshaker replays the app,
        the WAL catchup replays the unfinished height."""
        if self.nodes[i] is not None:
            return
        self._log("restart node%d" % i)
        if self._bb_prev_sinks is not None:
            # decode the dead journal before reopening repairs its torn tail
            rep = self.m.blackbox.postmortem_report(
                str(self.root / f"node{i}" / "blackbox"))
            self.postmortems.append(
                {"node": i, "t": round(self.clock.now(), 6), "report": rep})
            inf = rep.get("in_flight") or {}
            self._log(
                "restart node%d postmortem: clean=%s records=%d torn=%s "
                "corrupt=%d last_committed=%s inflight=h%s/r%s open_spans=%d"
                % (i, rep["clean_close"], rep["journal"]["records"],
                   rep["journal"]["torn_tail"], rep["journal"]["corrupt_skipped"],
                   rep["last_committed_height"], inf.get("h"), inf.get("r"),
                   len(rep["open_spans"])))
        node = self._build(i)
        self.nodes[i] = node
        self._start_cs(node)
        self._drain_all()
        self.checker.on_restart(self, i)

    def join(self, i: int) -> bool:
        """Bring node i back as a fresh machine through statesync (the JAX
        ``SimCluster.join``/``_statesync_join``): snapshots listed by every
        live helper, the target height light-verified from a height-1 trust
        root through ``HandleProvider`` on the first helper, chunks carried
        by the faulty links, the stores bootstrapped, then the node
        assembled around the restored app and started."""
        if self.nodes[i] is not None:
            return False
        helpers = self.live_nodes()
        self._log("join node%d starting statesync" % i)
        imp = lambda name: importlib.import_module(f"{self.m.pkg}.{name}")
        at, kvstore = imp("abci.types"), imp("abci.kvstore")
        verifier, proxy = imp("light.verifier"), imp("proxy.multi_app_conn")
        sp, syn = imp("statesync.stateprovider"), imp("statesync.syncer")
        state_store, block_store, kv = imp("state.store"), imp("store.block_store"), imp("store.kv")

        # a fresh machine: no stores, no WAL, no privval history and no
        # black box (close the old handle before its directory goes)
        j = self.blackbox.pop(i, None)
        if j is not None and not j.closed:
            j.close(clean=False)
        shutil.rmtree(self.root / f"node{i}", ignore_errors=True)
        self._dbs[i] = None
        app = kvstore.KVStoreApplication()
        conns = proxy.AppConns(proxy.local_client_creator(app))
        conns.start()
        trust_meta = helpers[0].block_store.load_block_meta(1)
        provider = self.m.node.HandleProvider(helpers[0], CHAIN_ID)
        state_provider = sp.LightClientStateProvider(
            CHAIN_ID, [provider],
            verifier.TrustOptions(period_s=10**9, height=1, hash=trust_meta.block_id.hash),
            genesis_doc=self.gdoc, now_fn=self.clock, **self._dev)
        syncer_box: list = []

        def request_chunk(peer_id: str, height: int, fmt: int, idx: int) -> bool:
            src = int(peer_id[len("node"):])

            def respond() -> None:
                peer = self.nodes[src]
                if peer is None:
                    return
                res = peer.app_conns.snapshot.load_snapshot_chunk(
                    at.LoadSnapshotChunkRequest(height=height, format=fmt, chunk=idx))
                if res.chunk and syncer_box:
                    self.net.schedule_transfer(
                        src, i, lambda: syncer_box[0].add_chunk(height, fmt, idx, res.chunk),
                        label="chunk-resp")

            return self.net.schedule_transfer(i, src, respond, label="chunk-req")

        syncer = syn.Syncer(state_provider, conns, request_chunk, logger=None,
                            clock=self.clock, sleeper=self._statesync_sleeper)
        syncer_box.append(syncer)
        for helper in helpers:
            res = helper.app_conns.snapshot.list_snapshots(at.ListSnapshotsRequest())
            for s in res.snapshots:
                syncer.add_snapshot(f"node{helper.index}", syn.SnapshotKey(
                    height=s.height, format=s.format, hash=s.hash, chunks=s.chunks,
                    metadata=s.metadata))
        try:
            state, commit = syncer.sync_any(0.0, is_running=lambda: True)
        except syn.StatesyncError as e:
            conns.stop()
            self._log("join node%d statesync failed: %s" % (i, e))
            return False
        db = kv.MemKV()
        state_store.StateStore(db).bootstrap(state)
        block_store.BlockStore(db).save_seen_commit(state.last_block_height, commit)
        self._dbs[i] = db
        node = self._build(i, app=app, app_conns=conns)
        self.nodes[i] = node
        self.members.add(i)
        self.checker.on_join(self, i, state.last_block_height)
        self._log("join node%d statesync complete h=%d" % (i, state.last_block_height))
        self._start_cs(node)
        self._drain_all()
        return True

    def _statesync_sleeper(self, timeout: float) -> None:
        """The syncer's wait on virtual time: the rest of the network runs
        (timeouts, deliveries, chunk responses) while the joiner waits."""
        deadline = self.clock.now() + timeout
        while True:
            nxt = self.clock.next_event_time()
            if nxt is None or nxt > deadline:
                break
            self.step()
        self.clock.advance_to(deadline)

    # -- traffic -----------------------------------------------------------

    def _feed(self) -> None:
        """Offer every live mempool the txs of each height up to one past
        the network's top height."""
        if not self.txs_per_height:
            return
        top = max(n.block_store.height() for n in self.live_nodes())
        while self._fed <= top:
            h = self._fed + 1
            txs = txs_at(h, self.txs_per_height)
            for node in self.live_nodes():
                for tx in txs:
                    try:
                        node.mempool.check_tx(tx)
                    except Exception:  # noqa: BLE001 — in cache, full
                        pass
            self._log("feed h=%d txs=%d" % (h, len(txs)))
            self._fed = h

    # -- event loop --------------------------------------------------------

    def _on_deliver(self, dst: int, src: int, msg, ctx=None) -> None:
        node = self.nodes[dst]
        if node is None or not node.cs.is_running:
            return
        self._log("deliver %d->%d %s" % (src, dst, describe_msg(self.m, msg)))
        node.cs.add_peer_message(msg, peer_id=f"node{src}", trace_ctx=ctx)

    def _drain_all(self) -> None:
        progress = True
        while progress:
            progress = False
            for node in self.nodes:
                if node is not None and node.cs.is_running:
                    self.active_node = node.index
                    try:
                        if node.cs.process_pending():
                            progress = True
                    finally:
                        self.active_node = None

    def step(self) -> bool:
        """Fire one scheduled event, drain, check the invariants."""
        timer = self.clock.tick()
        if timer is None:
            return False
        self.events_fired += 1
        if timer.label and not timer.label.startswith("net ") and timer.label != "catchup":
            self._log("fire %s" % timer.label)
        self._drain_all()
        self.trace.extend(self.checker.on_event(self))
        self._feed()
        return True

    def run(self, until_height: int, max_time: float = 600.0,
            max_events: int = 500_000) -> bool:
        """Drive until every member has committed ``until_height``."""
        self.start()
        while True:
            if self.reached(until_height):
                return True
            if self.clock.now() >= max_time or self.events_fired >= max_events:
                return self.reached(until_height)
            if not self.step():
                return self.reached(until_height)

    def reached(self, height: int) -> bool:
        return all(self.nodes[i] is not None
                   and self.nodes[i].block_store.height() >= height
                   for i in self.members)

    def heights(self) -> list:
        return [-1 if n is None else n.block_store.height() for n in self.nodes]

    # -- catchup -----------------------------------------------------------

    def _catchup_tick(self) -> None:
        for node in self.live_nodes():
            want = node.cs.rs.height
            helper = next((peer for peer in self.live_nodes()
                           if peer.index != node.index
                           and peer.block_store.height() >= want
                           and self.net.connected(peer.index, node.index)), None)
            if helper is None:
                continue
            commit = helper.block_store.load_seen_commit(want)
            meta = helper.block_store.load_block_meta(want)
            if commit is None or meta is None:
                continue
            for idx in range(len(commit.signatures)):
                vote = self.m.block.commit_vote(commit, idx)
                if vote is not None:
                    self.net.unicast(helper.index, node.index,
                                     self.m.messages.VoteMessage(vote))
            for pi in range(meta.block_id.part_set_header.total):
                part = helper.block_store.load_block_part(want, pi)
                if part is not None:
                    self.net.unicast(helper.index, node.index,
                                     self.m.messages.BlockPartMessage(
                                         height=want, round_=commit.round_, part=part))
        self.clock.call_later(CATCHUP_INTERVAL, self._catchup_tick, label="catchup")

    # -- results -----------------------------------------------------------

    def _log(self, line: str) -> None:
        self.trace.append("%.6f %s" % (self.clock.now(), line))

    def chain(self, upto: int) -> dict:
        """What must agree across packages, per live node: each height's
        block hash and the app hash after it, from the node's base (a
        statesync joiner holds no earlier block), and the WAL's #ENDHEIGHT
        set."""
        out = {}
        for node in self.live_nodes():
            blocks, apps = [], []
            for h in range(max(node.block_store.base(), 1), upto + 1):
                meta = node.block_store.load_block_meta(h)
                blocks.append(meta.block_id.hash.hex())
                nxt = node.block_store.load_block_meta(h + 1)
                apps.append(nxt.header.app_hash.hex() if nxt is not None
                            else node.state_store.load().app_hash.hex())
            ends, _ = node.cs.wal.scan_end_heights(0)
            out[node.index] = {"blocks": blocks, "apps": apps,
                               "ends": sorted(e for e in ends if e <= upto)}
        return out


def run_script(pkg: str, root, script: str = "clean", seed: int = 42,
               heights: int = 5, txs_per_height: int = 16, device=None) -> Cluster:
    """One of the differential scripts, run to ``heights`` on every node:
    ``clean``; ``crash`` (node 1 crashes once the network has height 3,
    the others run two heights on, then it restarts from its stores);
    ``lossy`` (every link drops 5% and reorders 20% of messages); ``join``
    (node 3 crashes once the network has height 2, the others run to
    height 8, past the KVStore snapshot at 5, then node 3 joins through
    statesync as a fresh machine)."""
    links = {"drop_rate": 0.05, "reorder_rate": 0.2} if script == "lossy" else None
    c = Cluster(pkg, root, seed=seed, txs_per_height=txs_per_height,
                device=device, links=links)
    if script == "join":
        assert c.run(2), c.heights()
        c.crash(3)
        c.members.discard(3)
        assert c.run(8), c.heights()
        assert c.join(3), c.trace[-3:]
    if script == "crash":
        assert c.run(3), c.heights()
        c.crash(1)
        c.members.discard(1)
        assert c.run(5), c.heights()
        c.members.add(1)
        c.restart(1)
    assert c.run(heights), c.heights()
    return c
