"""Consensus round state + height vote set.

Reference: internal/consensus/types/{round_state,height_vote_set}.go.
``HeightVoteSet`` keeps one prevote + one precommit ``VoteSet`` per round of
the current height, tracks the proof-of-lock round, and caps peer-triggered
round creation (catchup rounds) the way the reference does.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.types.basic import PREVOTE_TYPE, PRECOMMIT_TYPE, BlockID, Timestamp
from cometbft_tpu_torch.types.block import Block, Commit
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.types.vote_set import VoteSet

# Round step state machine (reference: round_state.go RoundStepType).
(
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PROPOSE,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_COMMIT,
) = range(1, 9)

STEP_NAMES = {
    STEP_NEW_HEIGHT: "RoundStepNewHeight",
    STEP_NEW_ROUND: "RoundStepNewRound",
    STEP_PROPOSE: "RoundStepPropose",
    STEP_PREVOTE: "RoundStepPrevote",
    STEP_PREVOTE_WAIT: "RoundStepPrevoteWait",
    STEP_PRECOMMIT: "RoundStepPrecommit",
    STEP_PRECOMMIT_WAIT: "RoundStepPrecommitWait",
    STEP_COMMIT: "RoundStepCommit",
}


class HeightVoteSet:
    """Reference: internal/consensus/types/height_vote_set.go."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round_ = 0
        self._prevotes: dict[int, VoteSet] = {}
        self._precommits: dict[int, VoteSet] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self.set_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ not in self._prevotes:
            self._prevotes[round_] = VoteSet(
                self.chain_id, self.height, round_, PREVOTE_TYPE, self.val_set
            )
            self._precommits[round_] = VoteSet(
                self.chain_id, self.height, round_, PRECOMMIT_TYPE, self.val_set
            )

    def set_round(self, round_: int) -> None:
        """Create vote sets up to round+1 (catchup; reference: SetRound)."""
        for r in range(0, round_ + 2):
            self._add_round(r)
        self.round_ = round_

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._prevotes.get(round_)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._precommits.get(round_)

    def votes(self, round_: int, type_: int) -> Optional[VoteSet]:
        if type_ == PREVOTE_TYPE:
            return self.prevotes(round_)
        return self.precommits(round_)

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Reference: height_vote_set.go AddVote — peers may push us at most
        2 catchup rounds beyond our current one."""
        vs = self.votes(vote.round_, vote.type_)
        if vs is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round_)
                vs = self.votes(vote.round_, vote.type_)
                rounds.append(vote.round_)
            else:
                return False
        return vs.add_vote(vote)

    def pol_info(self) -> tuple[int, Optional[BlockID]]:
        """Highest round with a prevote 2/3 majority (reference: POLInfo)."""
        for r in sorted(self._prevotes, reverse=True):
            bid = self._prevotes[r].two_thirds_majority()
            if bid is not None:
                return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str, block_id: BlockID):
        self._add_round(round_)
        vs = self.votes(round_, type_)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """Reference: internal/consensus/types/round_state.go RoundState."""

    height: int = 0
    round_: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time: float = 0.0  # monotonic-ish wall time for NewHeight wait
    commit_time: float = 0.0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    proposal_receive_time: float = 0.0  # PBTS: local clock at proposal rx
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    def step_name(self) -> str:
        return STEP_NAMES.get(self.step, f"Unknown({self.step})")

    def proposal_complete(self) -> bool:
        return (
            self.proposal is not None
            and self.proposal_block is not None
            and self.proposal_block_parts is not None
            and self.proposal_block_parts.is_complete()
        )
