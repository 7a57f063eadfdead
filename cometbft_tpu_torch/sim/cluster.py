"""Single-threaded N-validator cluster on virtual time.

The drive loop is strictly sequential: pop the next virtual-clock event
(message delivery, consensus timeout, scripted fault, catchup tick), let it
enqueue work, then drain every node's receive queue in index order until the
cluster is quiescent, then run the incremental invariant checkers.  No other
thread exists, so the full event trace — and therefore every commit hash and
every failure — is a pure function of (seed, scenario script).

Catchup: push gossip alone cannot rescue a node that missed a commit (its
peers have moved to later heights whose votes it ignores), so the cluster
runs a virtual-time catchup tick modelled on the reactor's
``gossipDataForCatchup``: a lagging node is served the seen-commit votes and
block parts for its current height by the lowest-indexed connected peer that
has them, through the same faulty fabric as everything else.

Fleet-scale membership (docs/sim-design.md "Fleet scale"): the cluster can
be built with ``n_spares`` standby nodes beyond the genesis validator set.
A spare either comes online at genesis (``spawn_spare`` — it replays the
chain through consensus catchup) or arrives later via the REAL statesync
path (``join`` — snapshot offer → chunk fetch over the faulty fabric →
blocksync-style catchup tail), all on the virtual clock.  ``leave`` retires
a node gracefully; ``crash``/``restart`` stay the hard-kill path.  The
validator set itself rotates through ``val:`` txs (``add_validator`` /
``remove_validator``), which flow through the production
``validate_validator_updates`` path at FinalizeBlock.

``device`` (None: the card) is every node's device: ``sim/node.build_node``,
a statesync joiner's light client and a blocksync joiner's reactor take it
(the ``InvariantChecker`` verifies on the host, as the JAX package's).  As the port's other entry points, the cluster
resolves it through ``types/validation.entry_device``: with no card and no
CPU asked for (``device="cpu"`` or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``) it
raises, and on the card the kernel's self-check runs before the first node
is built.
"""

from __future__ import annotations

import random
import shutil
from pathlib import Path
from typing import Optional

from cometbft_tpu_torch.crypto.batch import env_backend
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
)
from cometbft_tpu_torch.libs import blackbox, tracing
from cometbft_tpu_torch.types.block import commit_vote as _commit_vote
from cometbft_tpu_torch.sim.clock import SimTicker, VirtualClock
from cometbft_tpu_torch.sim.invariants import InvariantChecker
from cometbft_tpu_torch.sim.network import SimNetwork
from cometbft_tpu_torch.sim.node import (
    HandleProvider,
    NodeHandle,
    build_node,
    make_genesis,
    sim_consensus_config,
)
from cometbft_tpu_torch.state.state import state_from_genesis
from cometbft_tpu_torch.types.validation import entry_device

SIM_CHAIN_ID = "sim-chain"
CATCHUP_INTERVAL = 0.5  # virtual seconds between catchup scans
# virtual seconds before an input whose check the card did not serve is
# offered again (the consensus reactor's vote gossip sleep, 100 ms)
UNSERVED_RETRY = 0.1


def describe_msg(msg) -> str:
    """Deterministic one-line rendering for the event trace; includes a
    signature prefix so the trace is sensitive to byte-level divergence."""
    if isinstance(msg, ProposalMessage):
        p = msg.proposal
        return "Proposal h=%d r=%d blk=%s sig=%s" % (
            p.height,
            p.round_,
            p.block_id.hash.hex()[:12],
            p.signature.hex()[:12],
        )
    if isinstance(msg, BlockPartMessage):
        return "BlockPart h=%d r=%d i=%d" % (msg.height, msg.round_, msg.part.index)
    if isinstance(msg, VoteMessage):
        v = msg.vote
        return "Vote t=%d h=%d r=%d v%d blk=%s sig=%s" % (
            v.type_,
            v.height,
            v.round_,
            v.validator_index,
            v.block_id.hash.hex()[:12],
            v.signature.hex()[:12],
        )
    return type(msg).__name__


class SimCluster:
    def __init__(
        self,
        n_vals: int,
        root,
        seed: int = 0,
        config=None,
        raise_on_violation: bool = True,
        check_wal: bool = True,
        catchup: bool = True,
        app_factory=None,
        mempool_config=None,
        n_spares: int = 0,
        device=None,
    ):
        if device is None and env_backend() == "cpu":
            device = "cpu"  # the variable asks for the CPU: name it
        self.device = entry_device(device)
        self.n_vals = n_vals
        self.n_spares = n_spares
        self.n_nodes = n_vals + n_spares
        self.root = Path(root)
        self.seed = seed
        self.config = config or sim_consensus_config()
        self.app_factory = app_factory
        self.mempool_config = mempool_config
        self.raise_on_violation = raise_on_violation
        self.clock = VirtualClock()
        self.rng = random.Random(seed)
        self.privs, self.gdoc = make_genesis(
            n_vals, SIM_CHAIN_ID, n_nodes=self.n_nodes
        )
        self.net = SimNetwork(self.clock, self.rng, self.n_nodes)
        self.net.deliver_fn = self._on_deliver
        self.net.alive_fn = lambda i: self.nodes[i] is not None
        self.checker = InvariantChecker(
            SIM_CHAIN_ID, state_from_genesis(self.gdoc), check_wal
        )
        self.trace: list[str] = []
        self.events_fired = 0
        # Which node's work is currently executing (set while draining a
        # node's queue) — backend-fault scenarios use it to scope injected
        # device failures to a victim subset; None = cluster-level work
        # (invariant checker, scripted actions).
        self.active_node: Optional[int] = None
        self._dbs: list = [None] * self.n_nodes  # MemKV survives crash-restart
        # per-node black-box journals (docs/observability.md "Black box"):
        # synchronous mode — one sim thread, so journal bytes are a pure
        # function of the seed — routed from the process-wide tracer by
        # ``active_node``.  ``crash`` kills a journal with the same
        # drop-unflushed-tail discipline as the WAL; ``restart`` decodes
        # the dead journal's postmortem (digest logged into the
        # byte-compared trace) before reopening it.
        self.blackbox: dict = {}
        self.postmortems: list[dict] = []
        # nodes halted by a fail-stop storage failure (StorageFatal from
        # the WAL / privval / state surfaces): they leave ``members`` —
        # 'the cluster made it' means no SURVIVOR left behind; a
        # fail-stopped node is an operator page, not a laggard
        self.fail_stopped: set[int] = set()
        self._bb_enabled = blackbox.enabled()
        self._bb_prev_sinks: Optional[dict] = None
        if self._bb_enabled:
            self._bb_prev_sinks = {
                "span": tracing.set_sink("span", self._bb_span),
                "open": tracing.set_sink("open", self._bb_open),
                "anomaly": tracing.set_sink("anomaly", self._bb_anomaly),
                "event": tracing.set_sink("event", self._bb_event),
            }
        self.nodes: list[Optional[NodeHandle]] = [
            self._build(i) for i in range(n_vals)
        ] + [None] * n_spares
        # membership: nodes expected to be online and at the chain head;
        # ``reached`` waits for exactly these (a crashed member still
        # counts as behind, a left node does not)
        self.members: set[int] = set(range(n_vals))
        self._started = False
        self._catchup = catchup
        self._joining = False  # statesync joins never nest
        self._bsync: dict = {}  # in-flight blocksync joins (sim/blocksync.py)

    # -- assembly ----------------------------------------------------------

    def _build(self, i: int, app=None, app_conns=None) -> NodeHandle:
        node = build_node(
            i,
            self.privs[i],
            self.gdoc,
            self.root,
            config=self.config,
            db=self._dbs[i],
            clock=self.clock,
            ticker_factory=lambda tock, i=i: SimTicker(
                self.clock, tock, name=f"node{i}"
            ),
            threaded=False,
            app_factory=self.app_factory,
            mempool_config=self.mempool_config,
            app=app,
            app_conns=app_conns,
            device=self.device,
        )
        self._dbs[i] = node.block_store._db
        node.cs.on_unserved = (
            lambda kind, payload, cs=node.cs: self.clock.call_later(
                UNSERVED_RETRY, lambda: cs.requeue(kind, payload),
                label=f"unserved node{i}"))
        # gossip envelopes carry the sender's round-trace context so
        # consensus-round spans merge into one causal tree per (height,
        # round) across the cluster (docs/observability.md); the context
        # is read at send time — the anchor may have been adopted since
        node.cs.trace_origin = i
        node.cs.broadcast_hook = lambda msg, i=i: self._broadcast(i, msg)
        node.cs.on_storage_fatal = lambda e, i=i: self._on_storage_fatal(i, e)
        if self._bb_enabled:
            j = blackbox.BlackboxJournal(
                str(self.root / f"node{i}" / "blackbox"),
                threaded=False,  # the one sim thread writes; deterministic
                clock=self.clock.now,
                # no periodic health records in sim: their counter
                # snapshots carry WALL-clock aggregates (verify_seconds,
                # latency sums), which would break the journal's
                # byte-per-seed determinism the soak matrix enforces
                health_every=None,
            )
            j.on_event("boot", {"node": i})
            self.blackbox[i] = j
        # a WAL tail repair at this boot (the crash-consistency scrub,
        # docs/storage-robustness.md) lands in the trace AND the node's
        # fresh journal — the torn-wal-restart scenario asserts both
        repair = (
            node.cs.wal.last_repair if node.cs.wal is not None else None
        )
        if repair is not None:
            self._log(
                "node%d wal_repair: truncated %d torn byte(s) to %d"
                % (i, repair["dropped_bytes"], repair["good_bytes"])
            )
            j = self.blackbox.get(i)
            if j is not None and not j.closed:
                j.on_event("wal_repair", {"node": i, **repair})
        return node

    def _on_storage_fatal(self, i: int, err) -> None:
        """A node hit a fail-stop storage failure: it has already halted
        its consensus state machine (before voting on unpersisted state —
        ``ConsensusState._storage_fatal``); here the cluster retires it
        like a crash whose operator never comes back.  It leaves
        ``members`` so ``reached`` measures the SURVIVORS — the agreement
        invariant still covers everything it committed before the halt."""
        self._log(
            "node%d STORAGE FATAL %s/%s: fail-stop halt (errno=%s)"
            % (i, err.surface, err.op, err.io_errno)
        )
        node = self.nodes[i]
        if node is None:
            return
        self.nodes[i] = None
        self.members.discard(i)
        self.fail_stopped.add(i)
        node.app_conns.stop()
        j = self.blackbox.get(i)
        if j is not None and not j.closed:
            # a fail-stop is a DELIBERATE halt: the process exits through
            # its shutdown path, so the journal gets its clean-close
            # sentinel (the disk_fatal anomaly is already journaled; on a
            # truly full disk the sentinel itself degrades to a counted
            # drop through the blackbox surface guard)
            j.close(clean=True)

    # -- black-box routing -------------------------------------------------
    #
    # One process hosts every sim node but each node keeps its OWN
    # journal, like production: records route by ``active_node`` (set
    # while a node's work executes), falling back to the span's ``node``
    # attr for consensus records emitted outside a drain.  Cluster-level
    # work (the invariant checker) is nobody's black box and is dropped.

    def _bb_target(self, attrs=None):
        i = self.active_node
        if i is None and attrs:
            i = attrs.get("node")
        if i is None:
            return None
        j = self.blackbox.get(i)
        return j if j is not None and not j.closed else None

    def _bb_span(self, sp) -> None:
        j = self._bb_target(sp.attrs)
        if j is not None:
            j.on_span(sp)

    def _bb_open(self, sp) -> None:
        j = self._bb_target(sp.attrs)
        if j is not None:
            j.on_open(sp)

    def _bb_anomaly(self, kind, attrs, t) -> None:
        j = self._bb_target(attrs)
        if j is not None:
            j.on_anomaly(kind, attrs, t)

    def _bb_event(self, kind, attrs) -> None:
        j = self._bb_target(attrs)
        if j is not None:
            j.on_event(kind, attrs)

    def _bb_close_all(self, clean: bool = True) -> None:
        for j in self.blackbox.values():
            if not j.closed:
                j.close(clean=clean)
        if self._bb_prev_sinks is not None:
            ours = (
                self._bb_span,
                self._bb_open,
                self._bb_anomaly,
                self._bb_event,
            )
            for k, fn in self._bb_prev_sinks.items():
                # restore only sinks still ours — a later installer
                # (another cluster, a node) must not be clobbered
                if tracing.get_sink(k) in ours:
                    tracing.set_sink(k, fn)
            self._bb_prev_sinks = None

    def blackbox_stats(self) -> dict:
        """Aggregate journal counters for soak rows: total records/bytes/
        drops/rotations across the cluster, on-disk footprint vs the
        configured segment budget (``budget_ok`` fails a soak row that
        outgrew it), and the postmortem count."""
        import os as _os

        agg = {"records": 0, "bytes": 0, "dropped": 0, "rotations": 0}
        disk = 0
        budget_ok = True
        for j in self.blackbox.values():
            s = j.stats()
            for k in agg:
                agg[k] += s[k]
            node_disk = 0
            for fp in blackbox.segment_files(j.dir):
                try:
                    node_disk += _os.path.getsize(fp)
                except OSError:
                    pass
            disk += node_disk
            # + one frame of slack: rotation triggers on the write that
            # would cross the threshold
            if node_disk > j.segments * j.segment_bytes + blackbox.MAX_REC_SIZE:
                budget_ok = False
        agg["disk_bytes"] = disk
        agg["budget_ok"] = budget_ok
        agg["nodes"] = len(self.blackbox)
        agg["postmortems"] = len(self.postmortems)
        return agg

    def _broadcast(self, i: int, msg) -> None:
        node = self.nodes[i]
        ctx = None
        if node is not None:
            # current_trace_ctx already gates on tracing.xnode_enabled()
            tc = node.cs.current_trace_ctx()
            ctx = tc.encode() if tc is not None else None
        self.net.send(i, msg, ctx=ctx)

    def live_nodes(self) -> list[NodeHandle]:
        return [n for n in self.nodes if n is not None]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for node in self.live_nodes():
            self._log("start node%d" % node.index)
            self._start_cs(node)
        if self._catchup:
            self.clock.call_later(
                CATCHUP_INTERVAL, self._catchup_tick, label="catchup"
            )
        self._drain_all()

    def _start_cs(self, node: NodeHandle) -> None:
        """Start a node's consensus with ``active_node`` set, so the
        round anchor its start opens routes to the node's own journal."""
        self.active_node = node.index
        try:
            node.cs.start()
        finally:
            self.active_node = None

    def stop(self) -> None:
        for h in list(self._bsync.values()):
            h.close()
        self._bsync.clear()
        for node in self.live_nodes():
            node.cs.stop()
            node.app_conns.stop()
        self._bb_close_all(clean=True)

    def crash(self, i: int) -> None:
        """Kill node i: its process state vanishes, its stores/WAL/privval
        files survive for ``restart``.  In-flight traffic to it is dropped,
        and the WAL loses its unflushed user-space tail (``WAL.kill``) —
        a graceful stop would fsync it and hide lost-tail replay bugs."""
        node = self.nodes[i]
        if node is None:
            return
        self._log("crash node%d" % i)
        self.nodes[i] = None  # alive_fn now reports dead
        if node.cs.wal is not None:
            node.cs.wal.kill()
        j = self.blackbox.get(i)
        if j is not None:
            # same discipline as the WAL: the journal's unflushed tail
            # dies with the process, so crash scenarios exercise real
            # torn tails — a graceful close here would hide them
            j.kill()
        node.cs.stop()
        node.app_conns.stop()

    def restart(self, i: int) -> None:
        """Rebuild node i from its persisted stores: Handshaker replays the
        app, WAL catchup replays unfinished-height consensus inputs."""
        if self.nodes[i] is not None:
            return
        self._log("restart node%d" % i)
        if self._bb_enabled:
            # decode the dead journal BEFORE reopening repairs its torn
            # tail — the same order a real node boots in.  The digest
            # lands in the byte-compared trace, so the nightly matrix's
            # same-seed double runs enforce that a killed node's
            # reconstruction is a pure function of the seed.
            rep = blackbox.postmortem_report(
                str(self.root / f"node{i}" / "blackbox")
            )
            self.postmortems.append(
                {"node": i, "t": round(self.clock.now(), 6), "report": rep}
            )
            inf = rep.get("in_flight") or {}
            self._log(
                "restart node%d postmortem: clean=%s records=%d torn=%s "
                "corrupt=%d last_committed=%s inflight=h%s/r%s open_spans=%d"
                % (
                    i,
                    rep["clean_close"],
                    rep["journal"]["records"],
                    rep["journal"]["torn_tail"],
                    rep["journal"]["corrupt_skipped"],
                    rep["last_committed_height"],
                    inf.get("h"),
                    inf.get("r"),
                    len(rep["open_spans"]),
                )
            )
        node = self._build(i)
        self.nodes[i] = node
        self._start_cs(node)
        self._drain_all()
        self.checker.on_restart(self, i)

    # -- churn --------------------------------------------------------------

    def leave(self, i: int) -> None:
        """Graceful departure: the node flushes and stops (WAL intact) and
        stops counting toward ``reached``.  Its stores survive, so a later
        ``restart`` models an operator bringing the same node back, while
        ``join`` models a fresh machine taking over the index."""
        node = self.nodes[i]
        if node is None:
            return
        self._log("leave node%d" % i)
        self.nodes[i] = None
        node.cs.stop()
        node.app_conns.stop()
        j = self.blackbox.get(i)
        if j is not None:
            j.close(clean=True)  # graceful: the sentinel IS the point
        self.members.discard(i)

    def spawn_spare(self, i: int) -> None:
        """Bring standby node ``i`` online from genesis: it replays the
        whole chain through consensus catchup (cheap early in a run).  Late
        arrivals should use ``join`` instead — that's the statesync path."""
        if self.nodes[i] is not None:
            return
        self._log("spawn node%d" % i)
        node = self._build(i)
        self.nodes[i] = node
        self.members.add(i)
        self._start_cs(node)
        self._drain_all()

    def join(self, i: int, helper_index: Optional[int] = None) -> bool:
        """Bring node ``i`` online as a FRESH machine via statesync on the
        virtual clock: discover snapshots from live peers, light-verify the
        target height against a height-1 trust root, stream chunks through
        the faulty fabric, bootstrap the stores, then let the catchup tick
        serve the blocksync tail.  Returns False (and logs) when no viable
        snapshot exists yet — scenarios typically retry a few virtual
        seconds later.  Any previous identity at this index is wiped."""
        if self.nodes[i] is not None or self._joining:
            return False
        helpers = [
            n
            for n in self.live_nodes()
            if helper_index is None or n.index == helper_index
        ]
        if not helpers:
            self._log("join node%d failed: no live peers" % i)
            return False
        self._log("join node%d starting statesync" % i)
        self._joining = True
        try:
            ok = self._statesync_join(i, helpers)
        finally:
            self._joining = False
        return ok

    def _statesync_join(self, i: int, helpers: list[NodeHandle]) -> bool:
        from cometbft_tpu_torch.abci import types as at
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.light.verifier import TrustOptions
        from cometbft_tpu_torch.proxy.multi_app_conn import (
            AppConns,
            local_client_creator,
        )
        from cometbft_tpu_torch.statesync.stateprovider import (
            LightClientStateProvider,
        )
        from cometbft_tpu_torch.statesync.syncer import (
            SnapshotKey,
            StatesyncError,
            Syncer,
        )
        from cometbft_tpu_torch.state.store import StateStore
        from cometbft_tpu_torch.store.block_store import BlockStore
        from cometbft_tpu_torch.store.kv import MemKV

        # fresh machine: no stores, no WAL, no privval history — and no
        # black box (close the old handle before its dir vanishes)
        j = self.blackbox.pop(i, None)
        if j is not None and not j.closed:
            j.close(clean=False)
        shutil.rmtree(self.root / f"node{i}", ignore_errors=True)
        self._dbs[i] = None
        app = (
            self.app_factory() if self.app_factory is not None
            else KVStoreApplication()
        )
        conns = AppConns(local_client_creator(app))
        conns.start()

        trust_meta = helpers[0].block_store.load_block_meta(1)
        if trust_meta is None:
            conns.stop()
            self._log("join node%d failed: no trust root yet" % i)
            return False
        provider = HandleProvider(helpers[0], SIM_CHAIN_ID)
        state_provider = LightClientStateProvider(
            SIM_CHAIN_ID,
            [provider],
            TrustOptions(
                period_s=10**9,
                height=1,
                hash=trust_meta.block_id.hash,
            ),
            genesis_doc=self.gdoc,
            now_fn=self.clock,
            device=self.device,
        )

        syncer_box: list = []

        def request_chunk(peer_id: str, height: int, fmt: int, idx: int) -> bool:
            src = int(peer_id[len("node"):])

            def respond() -> None:
                peer = self.nodes[src]
                if peer is None:
                    return  # helper died between request and response
                res = peer.app_conns.snapshot.load_snapshot_chunk(
                    at.LoadSnapshotChunkRequest(
                        height=height, format=fmt, chunk=idx
                    )
                )
                if res.chunk and syncer_box:

                    def deliver() -> None:
                        syncer_box[0].add_chunk(height, fmt, idx, res.chunk)

                    self.net.schedule_transfer(
                        src, i, deliver, label="chunk-resp"
                    )

            # request leg and response leg each cross the faulty fabric
            return self.net.schedule_transfer(
                i, src, respond, label="chunk-req"
            )

        syncer = Syncer(
            state_provider,
            conns,
            request_chunk,
            logger=None,
            clock=self.clock,
            sleeper=self._statesync_sleeper,
        )
        syncer_box.append(syncer)

        # snapshot discovery: every live helper advertises its app snapshots
        for helper in helpers:
            res = helper.app_conns.snapshot.list_snapshots(
                at.ListSnapshotsRequest()
            )
            for s in res.snapshots:
                syncer.add_snapshot(
                    f"node{helper.index}",
                    SnapshotKey(
                        height=s.height,
                        format=s.format,
                        hash=s.hash,
                        chunks=s.chunks,
                        metadata=s.metadata,
                    ),
                )

        try:
            state, commit = syncer.sync_any(0.0, is_running=lambda: True)
        except StatesyncError as e:
            conns.stop()
            self._log("join node%d statesync failed: %s" % (i, e))
            return False

        db = MemKV()
        StateStore(db).bootstrap(state)
        BlockStore(db).save_seen_commit(state.last_block_height, commit)
        self._dbs[i] = db
        node = self._build(i, app=app, app_conns=conns)
        self.nodes[i] = node
        self.members.add(i)
        self.checker.on_join(self, i, state.last_block_height)
        self._log(
            "join node%d statesync complete h=%d" % (i, state.last_block_height)
        )
        self._start_cs(node)
        self._drain_all()
        return True

    def blocksync_join(self, i: int, helper_indices=None) -> bool:
        """Bring node ``i`` online as a FRESH machine via BLOCKSYNC on the
        virtual clock: the real ``BlocksyncReactor`` downloads every block
        from live helpers through the faulty, bandwidth-shaped fabric,
        verifies commits through the batch seam (fused-prefetch windows
        included) and applies them; once caught up the cluster assembles a
        full node over the populated stores and starts its consensus.
        Returns False when no live helpers exist.  Non-blocking: the sync
        runs on repeating clock timers inside the normal ``run`` loop
        (``sim/blocksync.py``)."""
        from cometbft_tpu_torch.sim.blocksync import SimBlocksync

        if self.nodes[i] is not None or i in self._bsync:
            return False
        helpers = [
            n.index
            for n in self.live_nodes()
            if helper_indices is None or n.index in helper_indices
        ]
        if not helpers:
            self._log("bsync node%d failed: no live peers" % i)
            return False
        fresh = self._dbs[i] is None
        self._log(
            "bsync node%d starting blocksync (%s) helpers=%s"
            % (i, "fresh" if fresh else "resume", ",".join(map(str, helpers)))
        )
        self._bsync[i] = SimBlocksync(self, i, helpers)
        return True

    def blocksync_crash(self, i: int) -> None:
        """Kill a mid-catchup blocksync joiner (its stores survive for a
        ``blocksync_join`` resume — the crash-restart leg of the storm
        scenario)."""
        h = self._bsync.pop(i, None)
        if h is not None:
            h.crash()

    def blocksync_harness(self, i: int):
        """The live ``SimBlocksync`` for joiner ``i`` (fault-scripting
        handle for scenario actions), or None."""
        return self._bsync.get(i)

    def _finish_blocksync_join(self, harness) -> None:
        """Blocksync caught up: promote the joiner to a full member over
        its populated stores (the blocksync analog of the tail of
        ``_statesync_join``).  Runs inside a clock-timer callback, so the
        surrounding ``step()`` drains and invariant-checks right after."""
        i = harness.index
        self._bsync.pop(i, None)
        node = self._build(i, app=harness.app, app_conns=harness.conns)
        self.nodes[i] = node
        self.members.add(i)
        self.checker.on_join(self, i, node.block_store.height())
        self._log(
            "join node%d blocksync complete h=%d"
            % (i, node.block_store.height())
        )
        self._start_cs(node)

    def _statesync_sleeper(self, timeout: float) -> None:
        """The syncer's wait seam on virtual time: keep the REST of the
        cluster running (consensus timeouts, deliveries, scripted faults,
        chunk responses) while the joiner blocks, exactly like a real
        joiner waiting out the network."""
        deadline = self.clock.now() + timeout
        while True:
            nxt = self.clock.next_event_time()
            if nxt is None or nxt > deadline:
                break
            self.step()
        self.clock.advance_to(deadline)

    # -- validator rotation -------------------------------------------------

    def add_validator(self, i: int, power: int = 10) -> None:
        """Vote node ``i``'s key into the validator set: inject the
        kvstore's ``val:`` tx into every live mempool so whichever node
        proposes next carries the update (validate_validator_updates path,
        effective at +2 heights)."""
        self._inject_val_tx(i, power)

    def remove_validator(self, i: int) -> None:
        """Vote node ``i`` out (power 0 removes; the node keeps running as
        a full node)."""
        self._inject_val_tx(i, 0)

    def _inject_val_tx(self, i: int, power: int) -> None:
        import base64

        pub_b64 = base64.b64encode(self.privs[i].pub_key().bytes()).decode()
        tx = b"val:%s!%d" % (pub_b64.encode(), power)
        self._log("validator update node%d power=%d" % (i, power))
        for node in self.live_nodes():
            try:
                node.mempool.check_tx(tx)
            except Exception:  # noqa: BLE001 — duplicate in cache etc.
                pass

    # -- event loop --------------------------------------------------------

    def _on_deliver(self, dst: int, src: int, msg, ctx=None) -> None:
        node = self.nodes[dst]
        if node is None or not node.cs.is_running:
            return
        self._log("deliver %d->%d %s" % (src, dst, describe_msg(msg)))
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
        """Fire one scheduled event + drain + check invariants."""
        timer = self.clock.tick()
        if timer is None:
            return False
        self.events_fired += 1
        if (
            timer.label
            and not timer.label.startswith("net ")
            and not timer.label.startswith("bsync ")
            and timer.label != "catchup"
        ):
            # deliveries log themselves with message detail; catchup and
            # blocksync scheduler ticks are pure scheduling noise (the
            # harness logs the semantic events itself)
            self._log("fire %s" % timer.label)
        self._drain_all()
        self.trace.extend(self.checker.on_event(self))
        return True

    def run(
        self,
        until_height: Optional[int] = None,
        max_time: float = 600.0,
        max_events: int = 500_000,
    ) -> bool:
        """Drive until every member node has committed ``until_height`` (or
        the virtual-time/event budget runs out).  Returns success."""
        self.start()
        while True:
            if until_height is not None and self.reached(until_height):
                return True
            if self.clock.now() >= max_time or self.events_fired >= max_events:
                return until_height is not None and self.reached(until_height)
            if not self.step():
                return until_height is not None and self.reached(until_height)

    def reached(self, height: int) -> bool:
        """Every member — crashed ones count as behind — has committed
        ``height``; 'the cluster made it' means no member left behind."""
        return all(
            self.nodes[i] is not None
            and self.nodes[i].block_store.height() >= height
            for i in self.members
        )

    def heights(self) -> list[int]:
        return [
            -1 if n is None else n.block_store.height() for n in self.nodes
        ]

    def commit_hash(self, height: int) -> Optional[bytes]:
        for node in self.live_nodes():
            meta = node.block_store.load_block_meta(height)
            if meta is not None:
                return meta.block_id.hash
        return None

    # -- catchup -----------------------------------------------------------

    def _catchup_tick(self) -> None:
        for node in self.live_nodes():
            want = node.cs.rs.height  # first height it has not committed
            helper = next(
                (
                    peer
                    for peer in self.live_nodes()
                    if peer.index != node.index
                    and peer.block_store.height() >= want
                    and self.net.connected(peer.index, node.index)
                ),
                None,
            )
            if helper is None:
                continue
            commit = helper.block_store.load_seen_commit(want)
            meta = helper.block_store.load_block_meta(want)
            if commit is None or meta is None:
                continue
            for idx in range(len(commit.signatures)):
                vote = _commit_vote(commit, idx)
                if vote is not None:
                    self.net.unicast(
                        helper.index, node.index, VoteMessage(vote)
                    )
            for pi in range(meta.block_id.part_set_header.total):
                part = helper.block_store.load_block_part(want, pi)
                if part is not None:
                    self.net.unicast(
                        helper.index,
                        node.index,
                        BlockPartMessage(
                            height=want, round_=commit.round_, part=part
                        ),
                    )
        self.clock.call_later(CATCHUP_INTERVAL, self._catchup_tick, label="catchup")

    # -- trace -------------------------------------------------------------

    def _log(self, line: str) -> None:
        self.trace.append("%.6f %s" % (self.clock.now(), line))
