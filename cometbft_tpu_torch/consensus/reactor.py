"""Consensus reactor: round-state/proposal/block-part/vote gossip.

Reference: internal/consensus/reactor.go — four p2p channels (state 0x20,
data 0x21, vote 0x22, vote-set-bits 0x23, reactor.go:27-30), a ``PeerState``
per peer tracking what the peer has (reactor.go:1085), and per-peer gossip
routines (gossipData :590, gossipVotes :650, queryMaj23 :716).

Two delivery paths, both feeding the same deduplicating consensus handlers:
our own proposals/parts/votes are pushed to every peer the moment they are
generated (the ``broadcast_hook`` fast path), while the per-peer gossip
threads close the gaps — catching peers up with old block parts and commit
votes, and retransmitting anything the fast path missed.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.libs import sync as libsync
import time
from typing import Optional

from cometbft_tpu_torch.consensus import messages as cmsg
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
)
from cometbft_tpu_torch.consensus.types import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_PRECOMMIT,
    STEP_PREVOTE,
)
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.types.basic import (
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
    Timestamp,
)
from cometbft_tpu_torch.types.vote import Vote

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

_GOSSIP_SLEEP = 0.05
_MAJ23_SLEEP = 2.0


# shared with the deterministic simulator's catchup path (sim/cluster.py)
from cometbft_tpu_torch.types.block import commit_sigs as _commit_sigs
from cometbft_tpu_torch.types.block import commit_vote as _commit_vote


class PeerState:
    """What we know the peer has (reference: reactor.go:1085 PeerState)."""

    def __init__(self, peer):
        self.peer = peer
        self.lock = libsync.rlock("consensus.reactor.peer_state")
        self.height = 0
        self.round_ = -1
        self.step = STEP_NEW_HEIGHT
        self.start_time = 0.0
        self.proposal = False
        self.proposal_psh = None  # PartSetHeader
        self.proposal_parts: list[bool] = []
        self.proposal_pol_round = -1
        self.proposal_pol: list[bool] = []
        self.prevotes: dict[int, list[bool]] = {}  # round -> bits
        self.precommits: dict[int, list[bool]] = {}
        self.last_commit_round = -1
        self.last_commit: list[bool] = []

    # -- updates from state channel ---------------------------------------

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        with self.lock:
            new_height = msg.height != self.height
            new_round = new_height or msg.round_ != self.round_
            if msg.height < self.height or (
                msg.height == self.height and msg.round_ < self.round_
            ):
                return  # stale
            if new_height:
                if self.height == msg.height - 1:
                    # peer moved up one: its precommits became last_commit
                    self.last_commit = self.precommits.get(
                        msg.last_commit_round, []
                    )
                    self.last_commit_round = msg.last_commit_round
                else:
                    self.last_commit = []
                    self.last_commit_round = msg.last_commit_round
                self.prevotes = {}
                self.precommits = {}
            if new_round:
                self.proposal = False
                self.proposal_psh = None
                self.proposal_parts = []
                self.proposal_pol_round = -1
                self.proposal_pol = []
            self.height = msg.height
            self.round_ = msg.round_
            self.step = msg.step
            self.start_time = time.time() - msg.seconds_since_start_time

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        with self.lock:
            if self.height != msg.height:
                return
            if self.round_ != msg.round_ and not msg.is_commit:
                return
            self.proposal_psh = msg.block_part_set_header
            self.proposal_parts = list(msg.blockparts)

    def set_has_proposal(self, height: int, round_: int, psh) -> None:
        with self.lock:
            if self.height == height and self.round_ == round_:
                self.proposal = True
                if not self.proposal_parts:
                    self.proposal_psh = psh
                    self.proposal_parts = [False] * psh.total

    def set_has_part(self, height: int, round_: int, index: int) -> None:
        with self.lock:
            if self.height == height and self.round_ == round_:
                if 0 <= index < len(self.proposal_parts):
                    self.proposal_parts[index] = True

    def _bits_for(self, height: int, round_: int, type_: int, size: int):
        """The bit list tracking (height, round, type) votes, or None."""
        if height == self.height:
            table = self.prevotes if type_ == PREVOTE_TYPE else self.precommits
            bits = table.get(round_)
            if bits is None or len(bits) < size:
                bits = (bits or []) + [False] * (size - len(bits or []))
                table[round_] = bits
            return bits
        if height == self.height - 1 and type_ == PRECOMMIT_TYPE:
            if round_ == self.last_commit_round:
                if len(self.last_commit) < size:
                    self.last_commit += [False] * (
                        size - len(self.last_commit)
                    )
                return self.last_commit
        return None

    def set_has_vote(
        self, height: int, round_: int, type_: int, index: int
    ) -> None:
        with self.lock:
            bits = self._bits_for(height, round_, type_, index + 1)
            if bits is not None and 0 <= index < len(bits):
                bits[index] = True

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage) -> None:
        with self.lock:
            bits = self._bits_for(
                msg.height, msg.round_, msg.type_, len(msg.votes)
            )
            if bits is None:
                return
            for i, b in enumerate(msg.votes):
                if b and i < len(bits):
                    bits[i] = True


class ConsensusReactor(Reactor):
    """Reference: internal/consensus/reactor.go Reactor."""

    def __init__(self, cs, block_store, logger=None, wait_sync: bool = False):
        super().__init__("ConsensusReactor")
        self.cs = cs
        self.block_store = block_store
        self.logger = logger or liblog.nop_logger()
        self.wait_sync = wait_sync  # True until blocksync/statesync finish
        self._peer_states: dict[str, PeerState] = {}
        self._ps_lock = libsync.lock("consensus.reactor")
        cs.broadcast_hook = self._broadcast_internal
        cs.add_step_listener(self._on_new_step)
        cs.add_vote_listener(self._on_vote_added)

    def get_channels(self) -> list[ChannelDescriptor]:
        # ids/priorities per reference reactor.go GetChannels
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6, send_queue_capacity=100),
            ChannelDescriptor(DATA_CHANNEL, priority=10, send_queue_capacity=100),
            ChannelDescriptor(VOTE_CHANNEL, priority=7, send_queue_capacity=100),
            ChannelDescriptor(
                VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=2
            ),
        ]

    def on_start(self) -> None:
        if not self.wait_sync and not self.cs._started:
            self.cs.start()

    def on_stop(self) -> None:
        pass  # cs lifecycle is owned by the node

    def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Hand-off from blocksync (reference: reactor.go:116
        SwitchToConsensus)."""
        self.cs.update_to_state(state)
        self.wait_sync = False
        if not self.cs._started:
            self.cs.start()

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer) -> None:
        ps = PeerState(peer)
        with self._ps_lock:
            self._peer_states[peer.id] = ps
        peer.set("cons_peer_state", ps)
        # tell the new peer where we are
        peer.try_send(STATE_CHANNEL, cmsg.encode_gossip_msg(self._our_nrs()))
        for target, name in (
            (self._gossip_data_routine, "cons-gossip-data"),
            (self._gossip_votes_routine, "cons-gossip-votes"),
            (self._query_maj23_routine, "cons-maj23"),
        ):
            threading.Thread(
                target=target, args=(peer, ps), name=name, daemon=True
            ).start()

    def remove_peer(self, peer, reason) -> None:
        with self._ps_lock:
            self._peer_states.pop(peer.id, None)

    def peer_state(self, peer_id: str) -> Optional[PeerState]:
        with self._ps_lock:
            return self._peer_states.get(peer_id)

    # -- receive -----------------------------------------------------------

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        msg = cmsg.decode_gossip_msg(msg_bytes)
        ps = self.peer_state(peer.id)
        if ps is None:
            return
        if chan_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                ps.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.set_has_vote(msg.height, msg.round_, msg.type_, msg.index)
            elif isinstance(msg, VoteSetMaj23Message):
                self._handle_maj23(peer, ps, msg)
        elif chan_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, ProposalMessage):
                ps.set_has_proposal(
                    msg.proposal.height,
                    msg.proposal.round_,
                    msg.proposal.block_id.part_set_header,
                )
                self.cs.add_peer_message(msg, peer.id)
            elif isinstance(msg, BlockPartMessage):
                ps.set_has_part(msg.height, msg.round_, msg.part.index)
                self.cs.add_peer_message(msg, peer.id)
            elif isinstance(msg, cmsg.ProposalPOLMessage):
                with ps.lock:
                    if ps.height == msg.height:
                        ps.proposal_pol_round = msg.proposal_pol_round
                        ps.proposal_pol = list(msg.proposal_pol)
        elif chan_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, VoteMessage):
                v = msg.vote
                ps.set_has_vote(v.height, v.round_, v.type_, v.validator_index)
                self.cs.add_peer_message(msg, peer.id)
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                ps.apply_vote_set_bits(msg)

    def _handle_maj23(self, peer, ps: PeerState, msg: VoteSetMaj23Message):
        """Record the peer's claimed +2/3 and answer with our bits
        (reference: reactor.go Receive StateChannel VoteSetMaj23Message)."""
        with self.cs._mtx:
            rs = self.cs.rs
            if rs.height != msg.height or rs.votes is None:
                return
            rs.votes.set_peer_maj23(msg.round_, msg.type_, peer.id, msg.block_id)
            vote_set = rs.votes.votes(msg.round_, msg.type_)
            bits = (
                vote_set.bit_array_by_block_id(msg.block_id) if vote_set else []
            )
        peer.try_send(
            VOTE_SET_BITS_CHANNEL,
            cmsg.encode_gossip_msg(
                VoteSetBitsMessage(
                    height=msg.height,
                    round_=msg.round_,
                    type_=msg.type_,
                    block_id=msg.block_id,
                    votes=bits,
                )
            ),
        )

    # -- broadcast paths ---------------------------------------------------

    def _broadcast_internal(self, msg) -> None:
        """Fast path: push our own proposal/parts/votes to every peer."""
        if self.switch is None:
            return
        if isinstance(msg, (ProposalMessage, BlockPartMessage)):
            self.switch.broadcast(DATA_CHANNEL, cmsg.encode_gossip_msg(msg))
        elif isinstance(msg, VoteMessage):
            self.switch.broadcast(VOTE_CHANNEL, cmsg.encode_gossip_msg(msg))

    def _our_nrs(self) -> NewRoundStepMessage:
        rs = self.cs.rs
        lcr = -1
        if rs.last_commit is not None:
            lcr = getattr(rs.last_commit, "round_", -1)
        return NewRoundStepMessage(
            height=rs.height,
            round_=rs.round_,
            step=rs.step,
            seconds_since_start_time=max(
                int(time.time() - rs.start_time), 0
            ),
            last_commit_round=lcr,
        )

    def _on_new_step(self, rs) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL, cmsg.encode_gossip_msg(self._our_nrs())
            )

    def _on_vote_added(self, vote: Vote) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL,
                cmsg.encode_gossip_msg(
                    HasVoteMessage(
                        height=vote.height,
                        round_=vote.round_,
                        type_=vote.type_,
                        index=vote.validator_index,
                    )
                ),
            )

    # -- gossip data (reference: reactor.go:590 gossipDataRoutine) ---------

    def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        while self.is_running and peer.is_running:
            try:
                if not self._gossip_data_once(peer, ps):
                    time.sleep(_GOSSIP_SLEEP)
            except Exception as e:  # noqa: BLE001
                self.logger.debug("gossip data error", err=repr(e))
                time.sleep(_GOSSIP_SLEEP)

    def _gossip_data_once(self, peer, ps: PeerState) -> bool:
        with self.cs._mtx:
            rs = self.cs.rs
            our_height = rs.height
            parts = rs.proposal_block_parts
            proposal = rs.proposal
            our_round = rs.round_
        with ps.lock:
            peer_height = ps.height
            peer_round = ps.round_
            peer_parts = list(ps.proposal_parts)
            peer_has_proposal = ps.proposal

        # 1. same height/round: send proposal + missing parts
        if peer_height == our_height and peer_round == our_round:
            if proposal is not None and not peer_has_proposal:
                peer.try_send(
                    DATA_CHANNEL,
                    cmsg.encode_gossip_msg(ProposalMessage(proposal)),
                )
                ps.set_has_proposal(
                    our_height, our_round, proposal.block_id.part_set_header
                )
                return True
            if parts is not None and peer_parts:
                our_bits = parts.bit_array()
                for i in range(parts.header.total):
                    if i >= len(our_bits) or not our_bits[i]:
                        continue
                    if i < len(peer_parts) and peer_parts[i]:
                        continue
                    peer.try_send(
                        DATA_CHANNEL,
                        cmsg.encode_gossip_msg(
                            BlockPartMessage(
                                height=our_height,
                                round_=our_round,
                                part=parts.get_part(i),
                            )
                        ),
                    )
                    ps.set_has_part(our_height, our_round, i)
                    return True

        # 2. peer behind: catch it up from the block store
        if 0 < peer_height < our_height and peer_height >= self.block_store.base():
            meta = self.block_store.load_block_meta(peer_height)
            if meta is None:
                return False
            with ps.lock:
                if ps.proposal_psh is None or ps.proposal_psh != meta.block_id.part_set_header:
                    # declare the stored block's part set to the peer state
                    ps.proposal_psh = meta.block_id.part_set_header
                    if len(ps.proposal_parts) != meta.block_id.part_set_header.total:
                        ps.proposal_parts = [False] * meta.block_id.part_set_header.total
                missing = [
                    i for i, have in enumerate(ps.proposal_parts) if not have
                ]
            if missing:
                idx = missing[0]
                part = self.block_store.load_block_part(peer_height, idx)
                if part is not None:
                    peer.try_send(
                        DATA_CHANNEL,
                        cmsg.encode_gossip_msg(
                            BlockPartMessage(
                                height=peer_height, round_=0, part=part
                            )
                        ),
                    )
                    with ps.lock:
                        if idx < len(ps.proposal_parts):
                            ps.proposal_parts[idx] = True
                    return True
        return False

    # -- gossip votes (reference: reactor.go:650 gossipVotesRoutine) -------

    def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        while self.is_running and peer.is_running:
            try:
                if not self._gossip_votes_once(peer, ps):
                    time.sleep(_GOSSIP_SLEEP)
            except Exception as e:  # noqa: BLE001
                self.logger.debug("gossip votes error", err=repr(e))
                time.sleep(_GOSSIP_SLEEP)

    def _send_vote(self, peer, ps: PeerState, vote: Optional[Vote]) -> bool:
        if vote is None:
            return False
        ok = peer.try_send(
            VOTE_CHANNEL, cmsg.encode_gossip_msg(VoteMessage(vote))
        )
        if ok:
            ps.set_has_vote(
                vote.height, vote.round_, vote.type_, vote.validator_index
            )
        return ok

    def _pick_missing(self, vote_set, bits: list[bool]) -> Optional[Vote]:
        if vote_set is None:
            return None
        ours = vote_set.bit_array()
        for i, have in enumerate(ours):
            if have and (i >= len(bits) or not bits[i]):
                return vote_set.get_by_index(i)
        return None

    def _peer_vote_bits(
        self, ps: PeerState, height: int, round_: int, type_: int, size: int
    ) -> list[bool]:
        """Snapshot of what the peer has for (height, round, type), resolved
        relative to the PEER's height (reference: reactor.go
        PeerState.getVoteBitArray) — the same table set_has_vote writes, so
        the picker actually advances."""
        with ps.lock:
            bits = ps._bits_for(height, round_, type_, size)
            return list(bits) if bits is not None else []

    def _gossip_votes_once(self, peer, ps: PeerState) -> bool:
        with self.cs._mtx:
            rs = self.cs.rs
            our_height = rs.height
            votes = rs.votes
            last_commit = rs.last_commit
        with ps.lock:
            peer_height = ps.height
            peer_round = ps.round_

        if peer_height == our_height and votes is not None and peer_round >= 0:
            # peer's current-round votes (prevotes then precommits; the bit
            # tables dedup, so re-offering both is safe)
            with self.cs._mtx:
                pv = votes.prevotes(peer_round)
                pc = votes.precommits(peer_round)
            for vs, type_ in ((pv, PREVOTE_TYPE), (pc, PRECOMMIT_TYPE)):
                if vs is None:
                    continue
                bits = self._peer_vote_bits(
                    ps, peer_height, peer_round, type_, vs.size()
                )
                if self._send_vote(peer, ps, self._pick_missing(vs, bits)):
                    return True

        if peer_height + 1 == our_height and last_commit is not None:
            # peer is finishing our previous height: send last-commit votes
            bits = self._peer_vote_bits(
                ps,
                last_commit.height,
                last_commit.round_,
                PRECOMMIT_TYPE,
                last_commit.size(),
            )
            if self._send_vote(peer, ps, self._pick_missing(last_commit, bits)):
                return True

        if 0 < peer_height < our_height - 1 and peer_height >= self.block_store.base():
            # catchup: send precommits reconstructed from the stored
            # commit — the EXTENDED commit at extension-enabled heights,
            # since the peer rejects extension-less precommits there
            # (reference: reactor.go gossipVotesForHeight:920-945)
            ext_h = self.cs.state.consensus_params.feature.vote_extensions_enable_height
            commit = None
            if 0 < ext_h <= peer_height:
                commit = self.block_store.load_extended_commit(peer_height)
            if commit is None:
                commit = self.block_store.load_block_commit(peer_height)
            if commit is not None:
                sigs = _commit_sigs(commit)
                bits = self._peer_vote_bits(
                    ps,
                    peer_height,
                    commit.round_,
                    PRECOMMIT_TYPE,
                    len(sigs),
                )
                for i, cs_sig in enumerate(sigs):
                    if cs_sig.absent():
                        continue
                    if i < len(bits) and bits[i]:
                        continue
                    if self._send_vote(peer, ps, _commit_vote(commit, i)):
                        return True
        return False

    # -- query maj23 (reference: reactor.go:716 queryMaj23Routine) ---------

    def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        while self.is_running and peer.is_running:
            time.sleep(_MAJ23_SLEEP)
            try:
                with self.cs._mtx:
                    rs = self.cs.rs
                    if rs.votes is None:
                        continue
                    height, round_ = rs.height, rs.round_
                    maj23s = []
                    for type_ in (PREVOTE_TYPE, PRECOMMIT_TYPE):
                        vs = rs.votes.votes(round_, type_)
                        if vs is not None:
                            bid = vs.two_thirds_majority()
                            if bid is not None:
                                maj23s.append((round_, type_, bid))
                with ps.lock:
                    peer_height = ps.height
                if peer_height != height:
                    continue
                for round_i, type_, bid in maj23s:
                    peer.try_send(
                        STATE_CHANNEL,
                        cmsg.encode_gossip_msg(
                            VoteSetMaj23Message(
                                height=height,
                                round_=round_i,
                                type_=type_,
                                block_id=bid,
                            )
                        ),
                    )
            except Exception as e:  # noqa: BLE001
                self.logger.debug("maj23 routine error", err=repr(e))
