"""Tendermint BFT consensus state machine.

Reference: internal/consensus/state.go — a single consumer thread
(``_receive_routine``, reference :795) drains peer messages, internal
messages (our own proposals/votes), and timeouts; every input is written to
the WAL before it is processed (peer msgs buffered, internal msgs fsync'd);
the round state advances propose → prevote → precommit → commit with
proof-of-lock (POL) lock/unlock rules.

Determinism discipline: all state transitions happen on the consumer thread
under ``_mtx``; public methods only enqueue.  The card-batched commit
verification runs synchronously inside ``finalize_commit`` → ``apply_block``
— verify completion cannot reorder state transitions (SURVEY.md §7 hard
parts).  Proposal, vote and vote-extension signatures go through
``verifysched.verify_cached`` at the consensus priority: on a card node the
Ed25519 kernel answers them in the scheduler's flushes.

The flight recorder (``libs/tracing``) sees each round as the JAX
package's does: a ``consensus.round`` anchor per (height, round), the
parent of every span the round produces, with ``consensus.step`` spans
under it, ``consensus.proposal`` and ``consensus.vote_ext`` around those
checks, the quorum stamps, and the trace context a received message
carries adopted into it.  Trace contexts stay in memory: no wire byte
carries them.
"""

from __future__ import annotations

import queue
import threading

from cometbft_tpu_torch.libs import sync as libsync
import time as _time
from typing import Callable, Optional

from cometbft_tpu_torch.config.config import ConsensusConfig
from cometbft_tpu_torch.consensus import messages as cmsg
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    MsgInfo,
    ProposalMessage,
    VoteMessage,
)
from cometbft_tpu_torch.consensus.ticker import TimeoutInfo, TimeoutTicker
from cometbft_tpu_torch.consensus.types import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
    HeightVoteSet,
    RoundState,
)
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.crypto.backend_health import BackendError
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.diskguard import StorageFatal
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.basic import (
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
    Timestamp,
)
from cometbft_tpu_torch.types.block import Block, Commit
from cometbft_tpu_torch.types.events import (
    EventBus,
    EventDataCompleteProposal,
    EventDataNewRound,
    EventDataRoundState,
    EventDataVote,
)
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.types.vote_set import ConflictingVoteError, VoteError, VoteSet
from cometbft_tpu_torch.utils.fail import fail_point


class _MsgQueue(queue.Queue):
    """The consensus input queue: bounded for peer messages, with one way
    past the bound for the consumer thread's own messages."""

    def put_unbounded(self, item) -> None:
        """Put ``item`` last without waiting for room."""
        with self.not_empty:
            self._put(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()


class ConsensusState(BaseService):
    """Reference: internal/consensus/state.go State."""

    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store,
        mempool,
        priv_validator=None,
        wal: Optional[WAL] = None,
        event_bus: Optional[EventBus] = None,
        evidence_pool=None,
        logger: Optional[liblog.Logger] = None,
        clock: Optional[Callable[[], float]] = None,
        ticker_factory: Optional[Callable[[Callable], object]] = None,
        threaded: bool = True,
    ):
        """``clock``/``ticker_factory``/``threaded`` form the determinism
        seam (sim/clock.py): a simulation injects a virtual clock and a
        virtual-time ticker and drives the receive loop synchronously via
        ``process_pending`` instead of the consumer thread."""
        super().__init__("ConsensusState")
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.priv_validator = priv_validator
        self.wal = wal
        self.event_bus = event_bus
        self.evidence_pool = evidence_pool
        self.logger = logger or liblog.nop_logger()

        self.rs = RoundState()
        self.state: Optional[State] = None

        self._mtx = libsync.rlock("consensus.state")
        self._queue: "_MsgQueue[tuple[str, object]]" = _MsgQueue(maxsize=1000)
        # an input whose check the card did not serve (``BackendError``: an
        # infrastructure failure, never a verdict) is handed back here,
        # ``on_unserved(kind, payload)``, to be offered again later, as a
        # peer's vote gossip sends again what it sees the node lacks; None
        # drops it (the threaded node: its reactors re-gossip)
        self.on_unserved: Optional[Callable[[str, object], None]] = None
        self._clock: Callable[[], float] = clock or _time.time
        self._threaded = threaded
        self.ticker = (ticker_factory or TimeoutTicker)(self._tock)
        self._thread: Optional[threading.Thread] = None
        self._done_first_height = threading.Event()

        # reactor hook: called with every internal message we generate, so a
        # gossip layer can fan it out to peers (reference gossips from
        # RoundState; push is equivalent for in-process wiring)
        self.broadcast_hook: Optional[Callable[[object], None]] = None
        # disk fail-stop (docs/storage-robustness.md): a StorageFatal from
        # the WAL / privval / state store halts this node BEFORE it can
        # vote or commit on unpersisted state; the hook lets the host
        # (node assembly, sim cluster) react to the halt
        self.on_storage_fatal: Optional[Callable[[StorageFatal], None]] = None
        self.storage_fatal_err: Optional[StorageFatal] = None
        # test hook: observe each (height, round, step) transition
        self.step_hook: Optional[Callable[[RoundState], None]] = None
        # reactor listeners (reference: reactor subscribes to internal
        # NewRoundStep/Vote events, reactor.go:1009 subscribeToBroadcastEvents)
        self._step_listeners: list[Callable[[RoundState], None]] = []
        self._vote_listeners: list[Callable[[Vote], None]] = []

        self._priv_addr: Optional[bytes] = None
        if priv_validator is not None:
            self._priv_addr = priv_validator.pub_key().address()

        # block parts that arrived before we learned the part-set header
        # (catchup: gossiped parts can beat the commit votes that carry the
        # header in their block id); drained once the PartSet exists
        self._orphan_parts: list = []

        # flight-recorder round anchor: one unfinished ``consensus.round``
        # span per (height, round), opened at round entry and recorded when
        # the round ends.  It is the ambient parent of every span the round
        # produces (step timings, proposal/vote checks, the commit's verify
        # pipeline) and the thing a received proposal's trace context
        # re-parents, so a commit's verify spans on this node link to the
        # proposal that originated on the proposer.  ``trace_origin`` names
        # this node in propagated contexts (the sim sets it to the node
        # index).
        self.trace_origin = None
        self._round_span = None
        self._step_t0 = 0.0
        self._step_prev: Optional[str] = None

        self.update_to_state(state)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def on_start(self) -> None:
        self.ticker.start()
        if self.wal is not None:
            self._catchup_replay()
        if self._threaded:
            self._thread = threading.Thread(
                target=self._receive_routine, name="cs-receive", daemon=True
            )
            self._thread.start()
        # kick off round 0 for the current height
        self._schedule_round0()

    def on_stop(self) -> None:
        self.ticker.stop()
        self._queue.put(("quit", None))
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.wal is not None:
            self.wal.close()

    # ------------------------------------------------------------------
    # public API (enqueue only)
    # ------------------------------------------------------------------

    def add_peer_message(
        self, msg: object, peer_id: str, trace_ctx=None
    ) -> None:
        self._queue.put(("peer", MsgInfo(msg, peer_id, trace_ctx)))

    def _add_internal_message(self, msg: object) -> None:
        # The consumer thread itself makes our proposals and votes: a
        # blocking put on a queue that peers filled would wait on the only
        # thread that drains it.  Internal messages take their place in
        # the one FIFO past its bound, as the reference never blocks here
        # (state.go sendInternalMessage: "the channel is full, try again
        # in a goroutine"); the JAX package blocks (ROADMAP §3).
        self._queue.put_unbounded(("internal", MsgInfo(msg, "")))
        if self.broadcast_hook is not None:
            self.broadcast_hook(msg)

    def notify_txs_available(self) -> None:
        self._queue.put(("txs", None))

    def requeue(self, kind: str, payload: object) -> None:
        """Offer an input again (``on_unserved``)."""
        self._queue.put_unbounded((kind, payload))

    def get_round_state(self) -> RoundState:
        with self._mtx:
            import copy

            rs = copy.copy(self.rs)
            return rs

    @property
    def height(self) -> int:
        with self._mtx:
            return self.rs.height

    def is_proposer(self) -> bool:
        with self._mtx:
            return (
                self._priv_addr is not None
                and self.rs.validators is not None
                and self.rs.validators.get_proposer().address == self._priv_addr
            )

    # ------------------------------------------------------------------
    # the receive loop (reference :795)
    # ------------------------------------------------------------------

    def _receive_routine(self) -> None:
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.5)
            except queue.Empty:
                if not self.is_running:
                    return
                continue
            if kind == "quit":
                return
            self._process_one(kind, payload)
            if self.storage_fatal_err is not None:
                return

    def process_pending(self) -> int:
        """Drain queued inputs synchronously; returns how many were handled.

        Only for ``threaded=False`` instances (the deterministic simulation
        drives each node's receive loop from the virtual-time scheduler).
        """
        n = 0
        while True:
            try:
                kind, payload = self._queue.get_nowait()
            except queue.Empty:
                return n
            if kind == "quit":
                return n
            self._process_one(kind, payload)
            n += 1
            if self.storage_fatal_err is not None:
                # fail-stopped mid-drain: queued inputs must not be
                # processed on top of unpersisted state
                return n

    def _process_one(self, kind: str, payload: object) -> None:
        try:
            if kind == "peer":
                mi: MsgInfo = payload
                if self.wal is not None:
                    try:
                        self.wal.write(cmsg.encode_msg(mi.msg))
                    except TypeError:
                        pass
                self._handle_msg(mi)
            elif kind == "internal":
                mi = payload
                if self.wal is not None:
                    try:
                        self.wal.write_sync(cmsg.encode_msg(mi.msg))
                    except TypeError:
                        pass
                self._handle_msg(mi)
            elif kind == "timeout":
                ti: TimeoutInfo = payload
                if self.wal is not None:
                    self.wal.write_sync(
                        cmsg.encode_timeout_wal(
                            ti.duration, ti.height, ti.round_, ti.step
                        )
                    )
                self._handle_timeout(ti)
            elif kind == "txs":
                self._handle_txs_available()
        except StorageFatal as e:
            # fail-stop: the durable state backing consensus safety can no
            # longer advance — halt before voting/committing on it
            self._storage_fatal(e)
        except BackendError as e:
            # on a card a check the kernel did not serve raises; the input
            # is not consumed, so it may be offered again
            self.logger.error(
                "consensus input not verified", err=repr(e), height=self.rs.height
            )
            if self.on_unserved is not None:
                self.on_unserved(kind, payload)
        except Exception as e:  # noqa: BLE001 — consensus must not die silently
            self.logger.error(
                "consensus failure", err=repr(e), height=self.rs.height
            )
            import traceback

            traceback.print_exc()

    def _storage_fatal(self, e: StorageFatal) -> None:
        """Halt this node on a fail-stop storage failure.  The WAL write,
        privval sign-state persist or store commit that raised ``e``
        happened BEFORE any vote was released or state transition applied
        (write-ahead ordering), so halting here can never equivocate —
        the node simply goes silent, like a crash (the one failure mode
        BFT already budgets f for)."""
        if self.storage_fatal_err is not None:
            return
        self.storage_fatal_err = e
        self.logger.error(
            "STORAGE FATAL — halting node",
            surface=e.surface,
            op=e.op,
            err=repr(e.err),
            height=self.rs.height,
        )
        if self._thread is threading.current_thread():
            # on_stop would join the receive thread we are running on
            self._thread = None
        try:
            self.stop()
        except Exception as stop_err:  # noqa: BLE001 — already halting
            self.logger.error("fail-stop cleanup failed", err=repr(stop_err))
        if self.on_storage_fatal is not None:
            try:
                self.on_storage_fatal(e)
            except Exception as hook_err:  # noqa: BLE001
                self.logger.error(
                    "storage-fatal hook failed", err=repr(hook_err)
                )

    def _tock(self, ti: TimeoutInfo) -> None:
        self._queue.put(("timeout", ti))

    def _now_ts(self) -> Timestamp:
        """Vote/proposal timestamps come from the injected clock so a
        simulated node's signatures are a pure function of virtual time."""
        return Timestamp.from_ns(int(self._clock() * 1e9))

    # ------------------------------------------------------------------
    # message handling (reference :886 handleMsg)
    # ------------------------------------------------------------------

    def _handle_msg(self, mi: MsgInfo) -> None:
        with self._mtx:
            msg = mi.msg
            self._maybe_adopt_ctx(mi)
            # every span the message produces (proposal/vote signature
            # checks, block validation, the commit's verify pipeline)
            # parents under this round's anchor and therefore inherits
            # the round trace — cross-node once the anchor is adopted
            with tracing.get_tracer().under(self._round_span):
                if isinstance(msg, ProposalMessage):
                    self._set_proposal(msg.proposal)
                elif isinstance(msg, BlockPartMessage):
                    added = self._add_proposal_block_part(msg)
                    if added:
                        self._on_block_part_added(msg.height)
                elif isinstance(msg, VoteMessage):
                    self._try_add_vote(msg.vote, mi.peer_id)

    # ------------------------------------------------------------------
    # flight-recorder round anchors (docs/observability.md)
    # ------------------------------------------------------------------

    def _maybe_adopt_ctx(self, mi: MsgInfo) -> None:
        """Link this node's round anchor into the sender's trace: a
        proposal (or a vote/part from a node that already linked) carries
        the round trace rooted at the proposer's anchor.  First adoption
        wins; the proposer's own anchor (the root) never adopts."""
        if mi.trace_ctx is None:
            return
        sp = self._round_span
        if sp is None or sp.parent_id is not None or sp.attrs.get("proposer"):
            return
        ctx = tracing.TraceContext.decode(mi.trace_ctx)
        if ctx is None:
            return
        msg = mi.msg
        if isinstance(msg, ProposalMessage):
            h, r = msg.proposal.height, msg.proposal.round_
        elif isinstance(msg, VoteMessage):
            h, r = msg.vote.height, msg.vote.round_
        elif isinstance(msg, BlockPartMessage):
            h, r = msg.height, msg.round_
        else:
            return
        if sp.attrs.get("h") == h and sp.attrs.get("r") == r:
            tracing.get_tracer().adopt(sp, ctx)

    def _open_round_span(self, height: int, round_: int) -> None:
        tr = tracing.get_tracer()
        attrs = {"h": height, "r": round_}
        if self.trace_origin is not None:
            attrs["node"] = self.trace_origin
        self._round_span = tr.begin("consensus.round", **attrs)
        self._step_t0 = tr.time()
        self._step_prev = None

    def _close_round_span(self, committed: bool) -> None:
        sp = self._round_span
        if sp is None:
            return
        self._round_span = None
        tr = tracing.get_tracer()
        if self._step_prev is not None:
            self._record_step_span(sp, self._step_prev, tr.time())
        self._step_prev = None
        tr.finish(sp, committed=committed)

    def _rotate_round_span(self, height: int, round_: int) -> None:
        sp = self._round_span
        if (
            sp is not None
            and sp.attrs.get("h") == height
            and sp.attrs.get("r") == round_
        ):
            return  # same round re-entered (wait-for-txs loop)
        self._close_round_span(committed=False)
        self._open_round_span(height, round_)

    def _record_step_span(self, sp, step_name: str, now: float) -> None:
        attrs = {
            "h": sp.attrs.get("h"),
            "r": sp.attrs.get("r"),
            "step": step_name,
        }
        if self.trace_origin is not None:
            attrs["node"] = self.trace_origin
        tracing.get_tracer().record_span(
            "consensus.step", self._step_t0, now, parent=sp, **attrs
        )
        self._step_t0 = now

    def _note_step_transition(self) -> None:
        """Called on every (height, round, step) transition: records the
        PREVIOUS step's duration as a ``consensus.step`` span under the
        round anchor — retroactive, because a step's length is only known
        once the next one begins."""
        sp = self._round_span
        if sp is None:
            return
        name = self.rs.step_name()
        if name == self._step_prev:
            return
        now = tracing.get_tracer().time()
        if self._step_prev is not None:
            self._record_step_span(sp, self._step_prev, now)
        else:
            self._step_t0 = now
        self._step_prev = name

    def _note_quorum(self, key: str, round_: int) -> None:
        """Stamp a quorum-arrival time (ms since round entry) onto the
        round anchor the first time 2/3 power lands for ``round_`` —
        time-to-2/3-prevotes / time-to-2/3-precommits."""
        sp = self._round_span
        if sp is None or key in sp.attrs or sp.attrs.get("r") != round_:
            return
        t = tracing.get_tracer().time() - sp.t_start
        ms = round(t * 1e3, 6)
        sp.set(**{key: ms})
        # quorum arrivals are stamped onto the UNFINISHED anchor, which a
        # crash would lose — journal them so the black box can attach them
        # to the in-flight round's postmortem (no-op without a journal)
        tracing.note_event(
            "quorum",
            h=sp.attrs.get("h"),
            r=sp.attrs.get("r"),
            node=sp.attrs.get("node"),
            key=key,
            ms=ms,
        )

    def current_trace_ctx(self):
        """The trace context outgoing gossip should carry, or None.  Only
        a LINKED anchor propagates — the proposer's root, or an anchor
        adopted into the proposal's trace — so every context on the wire
        resolves to the originating proposal's trace id (a node that has
        not seen the proposal yet gossips context-free)."""
        sp = self._round_span
        if sp is None or not tracing.xnode_enabled():
            return None
        if sp.parent_id is None and not sp.attrs.get("proposer"):
            return None
        return tracing.TraceContext(
            sp.trace_id, sp.span_id, self.trace_origin
        )

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        with self._mtx:
            rs = self.rs
            if ti.height != rs.height or ti.round_ < rs.round_ or (
                ti.round_ == rs.round_ and ti.step < rs.step
            ):
                return  # stale
            with tracing.get_tracer().under(self._round_span):
                self._dispatch_timeout(ti)

    def _dispatch_timeout(self, ti: TimeoutInfo) -> None:
        """Timeout-driven transitions under the round anchor, so verify
        work a timeout triggers (prevote-time block validation, a
        timeout-path finalize) links to the round trace exactly like
        message-driven work."""
        rs = self.rs
        if ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            if self.event_bus:
                self.event_bus.publish_timeout_propose(
                    EventDataRoundState(rs.height, rs.round_, rs.step_name())
                )
            self._enter_prevote(ti.height, ti.round_)
        elif ti.step == STEP_PREVOTE_WAIT:
            if self.event_bus:
                self.event_bus.publish_timeout_wait(
                    EventDataRoundState(rs.height, rs.round_, rs.step_name())
                )
            self._enter_precommit(ti.height, ti.round_)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            if self.event_bus:
                self.event_bus.publish_timeout_wait(
                    EventDataRoundState(rs.height, rs.round_, rs.step_name())
                )
            self._enter_precommit(ti.height, ti.round_)
            self._enter_new_round(ti.height, ti.round_ + 1)

    def _handle_txs_available(self) -> None:
        with self._mtx:
            if self.rs.step == STEP_NEW_HEIGHT:
                # +1ms so the block isn't proposed before the commit timeout
                self.ticker.schedule_timeout(
                    TimeoutInfo(0.001, self.rs.height, 0, STEP_NEW_ROUND)
                )
            elif self.rs.step == STEP_PROPOSE and self.is_proposer():
                pass  # already proposing this round

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------

    def add_step_listener(self, fn: Callable[[RoundState], None]) -> None:
        self._step_listeners.append(fn)

    def add_vote_listener(self, fn: Callable[[Vote], None]) -> None:
        self._vote_listeners.append(fn)

    def _new_step(self) -> None:
        self._note_step_transition()
        if self.event_bus:
            self.event_bus.publish_new_round_step(
                EventDataRoundState(
                    self.rs.height, self.rs.round_, self.rs.step_name()
                )
            )
        if self.step_hook is not None:
            self.step_hook(self.rs)
        for fn in self._step_listeners:
            try:
                fn(self.rs)
            except Exception as e:  # noqa: BLE001
                self.logger.error("step listener failed", err=repr(e))

    def _schedule_round0(self) -> None:
        """Wait until start_time then enter round 0 (reference:
        scheduleRound0, state.go:1950)."""
        sleep = max(self.rs.start_time - self._clock(), 0.0)
        self.ticker.schedule_timeout(
            TimeoutInfo(sleep, self.rs.height, 0, STEP_NEW_HEIGHT)
        )

    def _enter_new_round(self, height: int, round_: int) -> None:
        """Reference: state.go:1063 enterNewRound."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step != STEP_NEW_HEIGHT
        ):
            return
        self.logger.debug("enter new round", height=height, round=round_)
        self._rotate_round_span(height, round_)

        validators = rs.validators
        if rs.round_ < round_:
            validators = validators.copy_increment_proposer_priority(
                round_ - rs.round_
            )
        rs.round_ = round_
        rs.step = STEP_NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            # round 0 gets proposal fields fresh from update_to_state
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)
        rs.triggered_timeout_precommit = False

        if self.event_bus:
            self.event_bus.publish_new_round(
                EventDataNewRound(
                    height,
                    round_,
                    rs.step_name(),
                    proposer_address=validators.get_proposer().address,
                )
            )

        wait_for_txs = (
            not self.config.create_empty_blocks
            and round_ == 0
            and self.mempool.is_empty()
        )
        if wait_for_txs:
            rs.step = STEP_NEW_HEIGHT  # stay waiting; txs notification re-enters
            rs.round_ = round_
            interval = self.config.create_empty_blocks_interval_ms
            if interval > 0:
                self.ticker.schedule_timeout(
                    TimeoutInfo(interval / 1000.0, height, round_, STEP_NEW_ROUND)
                )
            self._new_step()
        else:
            self._enter_propose(height, round_)

    def _enter_propose(self, height: int, round_: int) -> None:
        """Reference: state.go:1152 enterPropose."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= STEP_PROPOSE
        ):
            return
        rs.round_ = round_
        rs.step = STEP_PROPOSE
        self._new_step()

        # propose timeout — move to prevote even without a proposal
        self.ticker.schedule_timeout(
            TimeoutInfo(
                self.config.propose_timeout(round_), height, round_, STEP_PROPOSE
            )
        )

        if self.priv_validator is not None and self.is_proposer():
            self._decide_proposal(height, round_)

        if self.rs.proposal_complete():
            self._enter_prevote(height, round_)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """Reference: state.go:1226 defaultDecideProposal."""
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            last_commit = self._load_last_commit(height)
            if last_commit is None:
                self.logger.error("no last commit, cannot propose", height=height)
                return
            ext_info = self._last_ext_commit_info(height)
            if (
                ext_info is None
                and height > self.state.initial_height
                and self._extensions_enabled(height - 1)
            ):
                # no extended commit available (e.g. the node blocksynced
                # to the head and never collected last-height precommits):
                # proposing with an empty ExtendedCommitInfo would hand the
                # app zero votes where the contract promises +2/3 — refuse
                # and let another validator propose (reference state.go
                # panics here; we fail just this proposal)
                self.logger.error(
                    "cannot propose: vote extensions enabled but no "
                    "extended commit for the previous height",
                    height=height,
                )
                return
            try:
                block = self.block_exec.create_proposal_block(
                    height,
                    self.state,
                    last_commit,
                    self._priv_addr,
                    last_ext_commit_info=ext_info,
                    block_time=self._now_ts(),
                )
            except Exception as e:  # noqa: BLE001
                self.logger.error("failed to create proposal block", err=repr(e))
                return
            parts = block.make_part_set()

        block_id = BlockID(hash=block.hash(), part_set_header=parts.header)
        proposal = Proposal(
            height=height,
            round_=round_,
            pol_round=rs.valid_round,
            block_id=block_id,
            timestamp=self._now_ts(),
        )
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except StorageFatal:
            raise  # fail-stop: _process_one halts the node
        except Exception as e:  # noqa: BLE001
            self.logger.error("failed to sign proposal", err=repr(e))
            return

        # mark the round anchor as the trace ROOT before the broadcast:
        # the outgoing proposal (and everything after) now carries this
        # node's round-trace context for the cluster to adopt
        if self._round_span is not None:
            self._round_span.set(proposer=True)
        self._add_internal_message(ProposalMessage(proposal))
        for i in range(parts.header.total):
            self._add_internal_message(
                BlockPartMessage(height=height, round_=round_, part=parts.get_part(i))
            )
        self.logger.info(
            "signed proposal", height=height, round=round_, hash=block_id.hash
        )

    def _last_ext_commit_info(self, height: int):
        """The previous height's precommit extensions as the app-facing
        ExtendedCommitInfo for PrepareProposal (reference: state.go
        defaultDecideProposal -> LoadBlockExtendedCommit ->
        ToExtendedCommitInfo), or None when extensions were not enabled."""
        from cometbft_tpu_torch.abci import types as at

        if height <= self.state.initial_height or not self._extensions_enabled(
            height - 1
        ):
            return None
        ec = None
        if (
            self.rs.last_commit is not None
            and self.rs.last_commit.has_two_thirds_majority()
        ):
            ec = self.rs.last_commit.make_extended_commit()
        else:
            ec = self.block_store.load_extended_commit(height - 1)
        if ec is None:
            return None
        vals = self.state.last_validators
        votes = []
        for i, cs in enumerate(ec.extended_signatures):
            val = vals.validators[i] if vals and i < len(vals.validators) else None
            votes.append(
                at.ExtendedVoteInfo(
                    validator=at.Validator(
                        address=cs.validator_address
                        or (val.address if val else b""),
                        power=val.voting_power if val else 0,
                    ),
                    vote_extension=cs.extension,
                    extension_signature=cs.extension_signature,
                    block_id_flag=cs.block_id_flag,
                )
            )
        return at.ExtendedCommitInfo(round_=ec.round_, votes=votes)

    def _load_last_commit(self, height: int) -> Optional[Commit]:
        from cometbft_tpu_torch.types.block import empty_commit

        if height == self.state.initial_height:
            return empty_commit()
        if (
            self.rs.last_commit is not None
            and self.rs.last_commit.has_two_thirds_majority()
        ):
            return self.rs.last_commit.make_commit()
        return self.block_store.load_seen_commit(height - 1)

    def _enter_prevote(self, height: int, round_: int) -> None:
        """Reference: state.go:1345 enterPrevote + :1387 defaultDoPrevote."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= STEP_PREVOTE
        ):
            return
        rs.round_ = round_
        rs.step = STEP_PREVOTE
        self._new_step()

        # defaultDoPrevote:
        if rs.locked_block is not None:
            # prevote our lock (PoL safety)
            self._sign_add_vote(
                PREVOTE_TYPE, rs.locked_block.hash(), rs.locked_block_parts.header
            )
            return
        if rs.proposal_block is None:
            self._sign_add_vote(PREVOTE_TYPE, b"", None)
            return
        # PBTS timeliness (reference: state.go:1379 proposalIsTimely +
        # types/proposal.go IsTimely): an untimely proposal gets a nil prevote
        if self.state.consensus_params.pbts_enabled(height) and not self._proposal_is_timely():
            self.logger.info(
                "prevote nil: proposal not timely", height=height, round=round_
            )
            self._sign_add_vote(PREVOTE_TYPE, b"", None)
            return
        # validate the proposal: header checks + app ProcessProposal
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
            accepted = self.block_exec.process_proposal(rs.proposal_block, self.state)
        except Exception as e:  # noqa: BLE001
            self.logger.error("invalid proposal block", err=repr(e))
            accepted = False
        if accepted:
            self._sign_add_vote(
                PREVOTE_TYPE,
                rs.proposal_block.hash(),
                rs.proposal_block_parts.header,
            )
        else:
            self._sign_add_vote(PREVOTE_TYPE, b"", None)

    def _proposal_is_timely(self) -> bool:
        """Reference: types/proposal.go IsTimely — the proposal timestamp
        must be within [recv - PRECISION - MSGDELAY, recv + PRECISION];
        message delay relaxes 10% per round (spec: PBTS adaptive delay)."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_receive_time == 0.0:
            return True
        sp = self.state.consensus_params.synchrony
        precision = sp.precision_ns / 1e9
        msg_delay = (sp.message_delay_ns / 1e9) * (1.1 ** rs.round_)
        ts = rs.proposal.timestamp.to_ns() / 1e9
        recv = rs.proposal_receive_time
        return ts - precision <= recv <= ts + precision + msg_delay

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= STEP_PREVOTE_WAIT
        ):
            return
        rs.round_ = round_
        rs.step = STEP_PREVOTE_WAIT
        self._new_step()
        self.ticker.schedule_timeout(
            TimeoutInfo(
                self.config.vote_timeout(round_), height, round_, STEP_PREVOTE_WAIT
            )
        )

    def _enter_precommit(self, height: int, round_: int) -> None:
        """Reference: state.go:1609 enterPrecommit — lock/unlock logic."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= STEP_PRECOMMIT
        ):
            return
        rs.round_ = round_
        rs.step = STEP_PRECOMMIT
        self._new_step()

        block_id = rs.votes.prevotes(round_).two_thirds_majority()

        if block_id is None:
            # no polka: precommit nil
            self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return

        if self.event_bus:
            self.event_bus.publish_polka(
                EventDataRoundState(height, round_, rs.step_name())
            )

        if block_id.is_zero():
            # polka for nil: unlock if locked
            if rs.locked_block is not None:
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return

        # polka for a block
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            # relock
            rs.locked_round = round_
            if self.event_bus:
                self.event_bus.publish_relock(
                    EventDataRoundState(height, round_, rs.step_name())
                )
            self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header)
            return

        if (
            rs.proposal_block is not None
            and rs.proposal_block.hash() == block_id.hash
        ):
            # lock the proposal block (it was validated at prevote time)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            if self.event_bus:
                self.event_bus.publish_lock(
                    EventDataRoundState(height, round_, rs.step_name())
                )
            self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header)
            return

        # polka for a block we don't have: unlock and precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if (
            rs.proposal_block_parts is None
            or rs.proposal_block_parts.header != block_id.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(block_id.part_set_header)
            self._drain_orphan_parts()
        self._sign_add_vote(PRECOMMIT_TYPE, b"", None)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.triggered_timeout_precommit
        ):
            return
        rs.triggered_timeout_precommit = True
        self._new_step()
        self.ticker.schedule_timeout(
            TimeoutInfo(
                self.config.vote_timeout(round_), height, round_, STEP_PRECOMMIT_WAIT
            )
        )

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """Reference: state.go:1743 enterCommit."""
        rs = self.rs
        if rs.height != height or rs.step >= STEP_COMMIT:
            return
        self.logger.debug("enter commit", height=height, round=commit_round)
        rs.step = STEP_COMMIT
        rs.commit_round = commit_round
        rs.commit_time = self._clock()
        self._new_step()

        block_id = rs.votes.precommits(commit_round).two_thirds_majority()
        assert block_id is not None and not block_id.is_zero()

        # if we locked the block, it is the committed one
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts

        if (
            rs.proposal_block is None
            or rs.proposal_block.hash() != block_id.hash
        ):
            # we don't have the block yet — wait for parts (catchup)
            if (
                rs.proposal_block_parts is None
                or rs.proposal_block_parts.header != block_id.part_set_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
                self._drain_orphan_parts()
            return

        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step != STEP_COMMIT:
            return
        block_id = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if block_id is None or block_id.is_zero():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """Reference: state.go:1834 finalizeCommit."""
        rs = self.rs
        block, parts = rs.proposal_block, rs.proposal_block_parts
        block_id = BlockID(hash=block.hash(), part_set_header=parts.header)

        # the commit's verify work (LastCommit re-verification inside
        # validate/apply) parents under the round anchor, so its spans
        # carry the originating proposal's trace id
        with tracing.get_tracer().under(self._round_span):
            self.block_exec.validate_block(self.state, block)

            fail_point(10)
            # save block + seen commit (DISK)
            if self.block_store.height() < height:
                precommits = rs.votes.precommits(rs.commit_round)
                seen_commit = precommits.make_commit()
                ext_commit = (
                    precommits.make_extended_commit()
                    if self._extensions_enabled(height)
                    else None
                )
                self.block_store.save_block(
                    block, parts, seen_commit, extended_commit=ext_commit
                )

            fail_point(11)
            # WAL end-height marker (DISK fsync) — replay boundary
            if self.wal is not None:
                self.wal.write_end_height(height)
            fail_point(12)

            new_state = self.block_exec.apply_verified_block(
                self.state, block_id, block
            )

        fail_point(13)
        self.logger.info(
            "finalized block",
            height=height,
            hash=lambda: block.hash(),
            n_txs=len(block.data.txs),
        )
        self._close_round_span(committed=True)
        self.update_to_state(new_state)
        self._schedule_round0()

    # ------------------------------------------------------------------
    # update to new height (reference: updateToState :1939)
    # ------------------------------------------------------------------

    def update_to_state(self, state: State) -> None:
        # a round anchor still open here means the height ended without
        # this node finalizing (blocksync overtook it, statesync restart):
        # record it un-committed rather than leak it
        self._close_round_span(committed=False)
        rs = self.rs
        last_precommits: Optional[VoteSet] = None
        if rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is not None and precommits.has_two_thirds_majority():
                last_precommits = precommits

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        validators = state.validators

        # commit_time + timeout_commit = when the next round starts
        if rs.commit_time > 0:
            start = rs.commit_time + self.config.commit_timeout()
        else:
            start = self._clock() + self.config.commit_timeout()
        if self.config.skip_timeout_commit and last_precommits is not None:
            start = self._clock()

        self.state = state
        rs.height = height
        rs.round_ = 0
        rs.step = STEP_NEW_HEIGHT
        rs.start_time = start
        rs.validators = validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, validators)
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self._orphan_parts = []
        self._new_step()

    # ------------------------------------------------------------------
    # proposals
    # ------------------------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """Reference: state.go:2048 defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round_ != rs.round_:
            return
        if proposal.pol_round < -1 or (
            proposal.pol_round >= 0 and proposal.pol_round >= proposal.round_
        ):
            raise VoteError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        # through the signature cache + verify scheduler (consensus class):
        # a proposal regossiped by several peers (or replayed from the WAL)
        # is verified once per process, and on accelerator-backed nodes the
        # check coalesces with in-flight vote verifications
        from cometbft_tpu_torch import verifysched

        with tracing.span(
            "consensus.proposal", h=proposal.height, r=proposal.round_
        ):
            ok = verifysched.verify_cached(
                proposer.pub_key,
                proposal.sign_bytes(self.state.chain_id),
                proposal.signature,
                priority=verifysched.PRIO_CONSENSUS,
            )
        if not ok:
            raise VoteError("invalid proposal signature")
        rs.proposal = proposal
        rs.proposal_receive_time = self._clock()
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)
            self._drain_orphan_parts()
        self.logger.debug(
            "received proposal", height=proposal.height, round=proposal.round_
        )

    def _add_proposal_block_part(self, msg: BlockPartMessage) -> bool:
        """Reference: state.go:2129 addProposalBlockPart."""
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            # no part-set header yet — keep the part; it is validated
            # against the header's merkle root when drained
            if len(self._orphan_parts) < 512:
                self._orphan_parts.append(msg)
            return False
        added, err = rs.proposal_block_parts.add_part(msg.part)
        if err:
            raise VoteError(f"bad block part: {err}")
        if added and rs.proposal_block_parts.is_complete():
            from cometbft_tpu_torch.types import codec

            raw = rs.proposal_block_parts.assemble()
            rs.proposal_block = codec.decode_block(raw)
            if self.event_bus:
                self.event_bus.publish_complete_proposal(
                    EventDataCompleteProposal(
                        rs.height,
                        rs.round_,
                        rs.step_name(),
                        block_id=BlockID(
                            hash=rs.proposal_block.hash(),
                            part_set_header=rs.proposal_block_parts.header,
                        ),
                    )
                )
        return added

    def _drain_orphan_parts(self) -> None:
        """Re-add parts that arrived before the part-set header was known."""
        if not self._orphan_parts or self.rs.proposal_block_parts is None:
            return
        pending, self._orphan_parts = self._orphan_parts, []
        added_any = False
        for msg in pending:
            try:
                if self._add_proposal_block_part(msg):
                    added_any = True
            except VoteError:
                continue  # part doesn't match the header's merkle root
        if added_any:
            self._on_block_part_added(self.rs.height)

    def _on_block_part_added(self, height: int) -> None:
        """Dispatch after a part lands (reference: addProposalBlockPart's
        completion handling, state.go:2129-2214): at commit step a complete
        BLOCK suffices — a Proposal message is never required to finalize."""
        rs = self.rs
        if rs.step == STEP_COMMIT:
            self._try_finalize_commit(height)
        elif rs.proposal_complete():
            self._handle_complete_proposal(height)

    def _handle_complete_proposal(self, height: int) -> None:
        """Reference: state.go:2214 handleCompleteProposal."""
        rs = self.rs
        # update valid block if there's a polka for it
        prevotes = rs.votes.prevotes(rs.round_)
        block_id = prevotes.two_thirds_majority() if prevotes else None
        if (
            block_id is not None
            and not block_id.is_zero()
            and rs.valid_round < rs.round_
            and rs.proposal_block.hash() == block_id.hash
        ):
            rs.valid_round = rs.round_
            rs.valid_block = rs.proposal_block
            rs.valid_block_parts = rs.proposal_block_parts

        if rs.step <= STEP_PROPOSE and rs.proposal_complete():
            self._enter_prevote(height, rs.round_)
            if block_id is not None and not block_id.is_zero():
                self._enter_precommit(height, rs.round_)
        elif rs.step == STEP_COMMIT:
            self._try_finalize_commit(height)

    # ------------------------------------------------------------------
    # votes
    # ------------------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> None:
        """Reference: state.go:2250 tryAddVote."""
        try:
            self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            if self.evidence_pool is not None and self._is_our_height_vote(vote):
                self.evidence_pool.report_conflicting_votes(e.existing, e.conflicting)
        except VoteError as e:
            self.logger.debug("bad vote", err=str(e), peer=peer_id)

    def _is_our_height_vote(self, vote: Vote) -> bool:
        return vote.height == self.rs.height

    def _add_vote(self, vote: Vote, peer_id: str) -> None:
        """Reference: state.go:2296 addVote."""
        rs = self.rs

        # precommit for previous height (late commit votes)
        if (
            vote.height + 1 == rs.height
            and vote.type_ == PRECOMMIT_TYPE
            and rs.step == STEP_NEW_HEIGHT
            and rs.last_commit is not None
        ):
            # late votes feed rs.last_commit -> make_extended_commit ->
            # the app's ExtendedCommitInfo, so their extensions need the
            # same verification as current-height precommits
            if not self._check_vote_extension(
                vote, self.state.last_validators
            ):
                return
            if rs.last_commit.add_vote(vote):
                if self.event_bus:
                    self.event_bus.publish_vote(EventDataVote(vote))
                if (
                    self.config.skip_timeout_commit
                    and rs.last_commit.has_all()
                ):
                    self._enter_new_round(rs.height, 0)
            return

        if vote.height != rs.height:
            return  # ignore other-height votes

        if not self._check_vote_extension(vote, rs.validators):
            return

        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return
        if self.event_bus:
            self.event_bus.publish_vote(EventDataVote(vote))
        for fn in self._vote_listeners:
            try:
                fn(vote)
            except Exception as e:  # noqa: BLE001
                self.logger.error("vote listener failed", err=repr(e))

        if vote.type_ == PREVOTE_TYPE:
            self._check_prevotes(vote)
        else:
            self._check_precommits(vote)

    def _check_vote_extension(self, vote: Vote, vals) -> bool:
        """Gate a received vote on the extension rules (reference:
        state.go:2296 addVote -> VerifyExtension +
        blockExec.VerifyVoteExtension):

          * extensions disabled at the vote's height: no extension bytes
            may appear at all;
          * enabled: prevotes and nil precommits must carry none, and a
            non-nil precommit from another validator must have a valid
            extension signature and pass the app's VerifyVoteExtension.
        """
        enabled = self._extensions_enabled(vote.height)
        has_ext = bool(vote.extension or vote.extension_signature)
        if not enabled or vote.type_ != PRECOMMIT_TYPE or vote.is_nil():
            return not has_ext
        if vote.validator_address == self._priv_addr:
            return True
        return self._verify_vote_extension(vote, vals)

    def _verify_vote_extension(self, vote: Vote, vals) -> bool:
        val = (
            vals.get_by_address(vote.validator_address)
            if vals is not None
            else None
        )
        if val is None or val[1] is None:
            return False
        from cometbft_tpu_torch import verifysched

        pub = val[1].pub_key
        # cached: blocksync's check_ext_commit re-verifies these same
        # extension signatures when serving/validating extended commits.
        # Scheduled at consensus priority: the extension check rides the
        # same fused dispatch as the vote signature it arrived with.
        with tracing.span(
            "consensus.vote_ext", h=vote.height, r=vote.round_
        ):
            ext_ok = bool(vote.extension_signature) and verifysched.verify_cached(
                pub,
                vote.extension_sign_bytes(self.state.chain_id),
                vote.extension_signature,
                priority=verifysched.PRIO_CONSENSUS,
            )
        if not ext_ok:
            self.logger.debug(
                "rejecting precommit: bad extension signature",
                val=vote.validator_address.hex(),
            )
            return False
        try:
            if not self.block_exec.verify_vote_extension(vote):
                self.logger.debug(
                    "rejecting precommit: app rejected extension",
                    val=vote.validator_address.hex(),
                )
                return False
        except Exception as e:  # noqa: BLE001
            self.logger.error("verify_vote_extension failed", err=repr(e))
            return False
        return True

    def _check_prevotes(self, vote: Vote) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round_)
        block_id = prevotes.two_thirds_majority()
        if block_id is not None:
            self._note_quorum("q_prevote_ms", vote.round_)
            # unlock if polka for something newer than our lock
            if (
                rs.locked_block is not None
                and rs.locked_round < vote.round_ <= rs.round_
                and rs.locked_block.hash() != block_id.hash
            ):
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            # update valid block
            if (
                not block_id.is_zero()
                and rs.valid_round < vote.round_ <= rs.round_
                and rs.proposal_block is not None
                and rs.proposal_block.hash() == block_id.hash
            ):
                rs.valid_round = vote.round_
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
                if self.event_bus:
                    self.event_bus.publish_valid_block(
                        EventDataRoundState(rs.height, rs.round_, rs.step_name())
                    )

        if rs.round_ < vote.round_ and prevotes.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round_)
        elif rs.round_ == vote.round_ and rs.step >= STEP_PREVOTE:
            if block_id is not None and (
                rs.proposal_complete() or block_id.is_zero()
            ):
                self._enter_precommit(rs.height, vote.round_)
            elif prevotes.has_two_thirds_any():
                self._enter_prevote_wait(rs.height, vote.round_)
        elif (
            rs.proposal is not None
            and 0 <= rs.proposal.pol_round == vote.round_
        ):
            if self.rs.proposal_complete():
                self._enter_prevote(rs.height, rs.round_)

    def _check_precommits(self, vote: Vote) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(vote.round_)
        block_id = precommits.two_thirds_majority()
        if block_id is not None:
            self._note_quorum("q_precommit_ms", vote.round_)
            self._enter_new_round(rs.height, vote.round_)
            self._enter_precommit(rs.height, vote.round_)
            if not block_id.is_zero():
                self._enter_commit(rs.height, vote.round_)
                if self.config.skip_timeout_commit and precommits.has_all():
                    self._enter_new_round(rs.height, 0)
            else:
                self._enter_precommit_wait(rs.height, vote.round_)
        elif rs.round_ <= vote.round_ and precommits.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round_)
            self._enter_precommit_wait(rs.height, vote.round_)

    def _sign_add_vote(
        self, type_: int, hash_: bytes, header
    ) -> Optional[Vote]:
        """Reference: state.go:2591 signAddVote."""
        rs = self.rs
        if self.priv_validator is None:
            return None
        found = rs.validators.get_by_address(self._priv_addr)
        if found is None:
            return None  # not a validator this height
        idx, _val = found

        from cometbft_tpu_torch.types.basic import PartSetHeader

        block_id = BlockID(
            hash=hash_, part_set_header=header or PartSetHeader()
        )
        vote = Vote(
            type_=type_,
            height=rs.height,
            round_=rs.round_,
            block_id=block_id,
            timestamp=self._now_ts(),
            validator_address=self._priv_addr,
            validator_index=idx,
        )
        ext_enabled = self._extensions_enabled(rs.height)
        if (
            type_ == PRECOMMIT_TYPE
            and not block_id.is_zero()
            and ext_enabled
        ):
            vote.extension = self.block_exec.extend_vote(
                vote, rs.proposal_block, self.state
            )
        try:
            self.priv_validator.sign_vote(
                self.state.chain_id, vote, sign_extension=ext_enabled and type_ == PRECOMMIT_TYPE
            )
        except StorageFatal:
            raise  # fail-stop: the vote must NOT be released or broadcast
        except Exception as e:  # noqa: BLE001 — double-sign protection etc.
            self.logger.error("failed to sign vote", err=repr(e))
            return None
        self._add_internal_message(VoteMessage(vote))
        return vote

    def _extensions_enabled(self, height: int) -> bool:
        h = self.state.consensus_params.feature.vote_extensions_enable_height
        return h > 0 and height >= h

    # ------------------------------------------------------------------
    # WAL catchup replay (reference: replay.go:95 catchupReplay)
    # ------------------------------------------------------------------

    def _catchup_replay(self) -> None:
        height = self.state.last_block_height
        records = self.wal.replay_after_height(height)
        if not records:
            return
        self.logger.info(
            "replaying consensus WAL", height=height + 1, records=len(records)
        )
        wal, self.wal = self.wal, None  # don't re-write replayed msgs
        try:
            for raw in records:
                if raw and raw[0] == cmsg.MSG_TIMEOUT:
                    dur, h, r, s = cmsg.decode_timeout_wal(raw)
                    self._handle_timeout(TimeoutInfo(dur, h, r, s))
                    continue
                try:
                    msg = cmsg.decode_msg(raw)
                except ValueError:
                    continue
                self._handle_msg(MsgInfo(msg, ""))
        finally:
            self.wal = wal
