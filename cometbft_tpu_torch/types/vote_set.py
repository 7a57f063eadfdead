"""VoteSet: 2/3-majority tallying for one (height, round, type)
(reference: types/vote_set.go:169-243).

Tracks votes by validator index, per-block tallies, and conflicting votes
(equivocation evidence).  A vote set "has 2/3 majority" for a block once the
voting power of votes for that exact BlockID exceeds 2/3 of the total.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.types.basic import BlockID, ZERO_BLOCK_ID
from cometbft_tpu_torch.types.vote import CommitSig, Vote
from cometbft_tpu_torch.types.validator import ValidatorSet


class VoteError(Exception):
    pass


class ConflictingVoteError(VoteError):
    """Equivocation: same validator, same (H,R,type), different block."""

    def __init__(self, existing: Vote, conflicting: Vote):
        super().__init__("conflicting votes from validator")
        self.existing = existing
        self.conflicting = conflicting


@dataclass
class _BlockVotes:
    peer_maj23: bool = False
    votes: dict[int, Vote] = field(default_factory=dict)
    sum: int = 0


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        type_: int,
        val_set: ValidatorSet,
    ):
        self.chain_id = chain_id
        self.height = height
        self.round_ = round_
        self.type_ = type_
        self.val_set = val_set
        self.votes: list[Optional[Vote]] = [None] * len(val_set)
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    def size(self) -> int:
        return len(self.val_set)

    # -- adding votes -----------------------------------------------------

    def add_vote(self, vote: Vote, verify: bool = True) -> bool:
        """Returns True if the vote was added.  Raises VoteError on invalid
        votes, ConflictingVoteError on equivocation (the vote for the maj23
        block is still admitted, mirroring the reference)."""
        if vote is None:
            raise VoteError("nil vote")
        err = vote.validate_basic()
        if err:
            raise VoteError(err)
        if (
            vote.height != self.height
            or vote.round_ != self.round_
            or vote.type_ != self.type_
        ):
            raise VoteError(
                f"vote (H,R,T)=({vote.height},{vote.round_},{vote.type_}) "
                f"does not match set ({self.height},{self.round_},{self.type_})"
            )
        idx = vote.validator_index
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise VoteError(f"validator index {idx} out of range")
        if val.address != vote.validator_address:
            raise VoteError("validator address does not match index")

        existing = self.votes[idx]
        if existing is not None and existing.block_id == vote.block_id:
            return False  # duplicate

        # Verify the signature BEFORE any conflict handling, so a forged vote
        # cannot frame an honest validator for equivocation (reference:
        # vote_set.go verifies in addVote before addVerifiedVote).
        if verify and not vote.verify(self.chain_id, val.pub_key):
            raise VoteError("invalid signature")

        if existing is not None:
            # conflicting vote: only admit if it's for a block with peer-claimed
            # 2/3 majority (reference: vote_set.go addVerifiedVote conflict path)
            bv = self.votes_by_block.get(vote.block_id.key())
            if bv is None or not bv.peer_maj23:
                raise ConflictingVoteError(existing, vote)

        self._add_verified(vote, val.voting_power)
        return True

    def _add_verified(self, vote: Vote, power: int) -> None:
        idx = vote.validator_index
        key = vote.block_id.key()
        bv = self.votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes()
            self.votes_by_block[key] = bv
        conflicting = self.votes[idx] is not None
        if not conflicting:
            self.votes[idx] = vote
            self.sum += power
        elif self.votes[idx].block_id != vote.block_id:
            # vote switches to the peer-claimed maj23 block
            old_key = self.votes[idx].block_id.key()
            old_bv = self.votes_by_block.get(old_key)
            if old_bv and idx in old_bv.votes:
                pass  # keep historical record in old block bucket
            self.votes[idx] = vote
        if idx not in bv.votes:
            bv.votes[idx] = vote
            bv.sum += power
            quorum = self.val_set.total_voting_power() * 2 // 3 + 1
            if bv.sum >= quorum and self.maj23 is None:
                self.maj23 = vote.block_id

    # -- queries ----------------------------------------------------------

    def two_thirds_majority(self) -> Optional[BlockID]:
        return self.maj23

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        # integer arithmetic: voting powers can exceed float's 2^53 range
        return self.sum * 3 > self.val_set.total_voting_power() * 2

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def get_by_index(self, idx: int) -> Optional[Vote]:
        if 0 <= idx < len(self.votes):
            return self.votes[idx]
        return None

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        found = self.val_set.get_by_address(address)
        if found is None:
            return None
        return self.votes[found[0]]

    def bit_array(self) -> list[bool]:
        return [v is not None for v in self.votes]

    def bit_array_by_block_id(self, block_id: BlockID) -> list[bool]:
        bv = self.votes_by_block.get(block_id.key())
        out = [False] * len(self.votes)
        if bv:
            for i in bv.votes:
                out[i] = True
        return out

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims 2/3 majority for block_id (reference:
        vote_set.go SetPeerMaj23)."""
        if peer_id in self.peer_maj23s:
            return
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_id.key())
        if bv is None:
            bv = _BlockVotes(peer_maj23=True)
            self.votes_by_block[block_id.key()] = bv
        else:
            bv.peer_maj23 = True

    # -- commit construction ---------------------------------------------

    def make_commit(self) -> "Commit":
        from cometbft_tpu_torch.types.block import Commit

        if self.maj23 is None or self.maj23.is_zero():
            raise VoteError("cannot make commit: no 2/3 majority for a block")
        sigs = []
        for vote in self.votes:
            if vote is None:
                sigs.append(CommitSig.absent_sig())
                continue
            cs = CommitSig.from_vote(vote)
            # A precommit for a *different* block cannot be represented in a
            # Commit; record it as absent (reference: vote_set.go MakeCommit).
            if cs.for_block() and vote.block_id != self.maj23:
                cs = CommitSig.absent_sig()
            sigs.append(cs)
        return Commit(
            height=self.height,
            round_=self.round_,
            block_id=self.maj23,
            signatures=sigs,
        )

    def make_extended_commit(self) -> "ExtendedCommit":
        """Like ``make_commit`` but retaining each precommit's vote
        extension (reference: vote_set.go MakeExtendedCommit)."""
        from cometbft_tpu_torch.types.block import ExtendedCommit
        from cometbft_tpu_torch.types.vote import ExtendedCommitSig

        if self.maj23 is None or self.maj23.is_zero():
            raise VoteError("cannot make commit: no 2/3 majority for a block")
        sigs = []
        for vote in self.votes:
            if vote is None:
                sigs.append(ExtendedCommitSig.absent_ext_sig())
                continue
            cs = ExtendedCommitSig.from_extended_vote(vote)
            if cs.for_block() and vote.block_id != self.maj23:
                cs = ExtendedCommitSig.absent_ext_sig()
            sigs.append(cs)
        return ExtendedCommit(
            height=self.height,
            round_=self.round_,
            block_id=self.maj23,
            extended_signatures=sigs,
        )
