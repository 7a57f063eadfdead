"""Vote, CommitSig, ExtendedCommitSig and Proposal (reference:
types/vote.go, types/block.go, types/proposal.go)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from cometbft_tpu_torch.types.basic import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
    Timestamp,
)
from cometbft_tpu_torch.types.canonical import (
    canonical_proposal_sign_bytes,
    canonical_vote_extension_sign_bytes,
    canonical_vote_sign_bytes,
)


@dataclass
class Vote:
    type_: int
    height: int
    round_: int
    block_id: BlockID  # zero block id == vote for nil
    timestamp: Timestamp
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_sign_bytes(
            chain_id,
            self.type_,
            self.height,
            self.round_,
            None if self.block_id.is_zero() else self.block_id,
            self.timestamp,
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_extension_sign_bytes(
            chain_id, self.height, self.round_, self.extension
        )

    def validate_basic(self) -> str | None:
        if self.type_ not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            return "invalid vote type"
        if self.height < 0:
            return "negative height"
        if self.round_ < 0:
            return "negative round"
        if len(self.validator_address) != 20:
            return "invalid validator address"
        if self.validator_index < 0:
            return "negative validator index"
        if not self.signature:
            return "missing signature"
        if len(self.signature) > 96:
            return "signature too large"
        if self.type_ == PREVOTE_TYPE and (
            self.extension or self.extension_signature
        ):
            return "prevote cannot carry vote extension"
        return None

    def verify(self, chain_id: str, pub_key) -> bool:
        """Reference: types/vote.go:227 — single-signature path.

        Routed through the signature cache AND the continuous-batching
        scheduler at the consensus priority class: on a card-backed node,
        concurrent gossip-time verifications from many peers coalesce into
        one kernel launch; elsewhere this is the cached host path.  Either
        way a precommit verified here at gossip time makes the commit
        built from it free to re-verify (its CommitSig reconstructs
        byte-identical sign bytes from the same timestamp).  (The JAX
        package's "consensus.vote" span waits for libs/tracing.)"""
        from cometbft_tpu_torch import verifysched

        return verifysched.verify_cached(
            pub_key,
            self.sign_bytes(chain_id),
            self.signature,
            priority=verifysched.PRIO_CONSENSUS,
        )

    def copy(self) -> "Vote":
        return replace(self)


@dataclass
class CommitSig:
    """One commit signature (reference: types/block.go CommitSig)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp)
    signature: bytes = b""

    def absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    @staticmethod
    def absent_sig() -> "CommitSig":
        return CommitSig(BLOCK_ID_FLAG_ABSENT)

    @staticmethod
    def from_vote(vote: Vote) -> "CommitSig":
        flag = BLOCK_ID_FLAG_NIL if vote.is_nil() else BLOCK_ID_FLAG_COMMIT
        return CommitSig(
            block_id_flag=flag,
            validator_address=vote.validator_address,
            timestamp=vote.timestamp,
            signature=vote.signature,
        )


@dataclass
class ExtendedCommitSig(CommitSig):
    """CommitSig + the precommit's vote extension (reference:
    types/block.go ExtendedCommitSig)."""

    extension: bytes = b""
    extension_signature: bytes = b""

    @staticmethod
    def absent_ext_sig() -> "ExtendedCommitSig":
        return ExtendedCommitSig(BLOCK_ID_FLAG_ABSENT)

    @staticmethod
    def from_extended_vote(vote: Vote) -> "ExtendedCommitSig":
        flag = BLOCK_ID_FLAG_NIL if vote.is_nil() else BLOCK_ID_FLAG_COMMIT
        return ExtendedCommitSig(
            block_id_flag=flag,
            validator_address=vote.validator_address,
            timestamp=vote.timestamp,
            signature=vote.signature,
            extension=vote.extension,
            extension_signature=vote.extension_signature,
        )

    def to_commit_sig(self) -> CommitSig:
        return CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )


@dataclass
class Proposal:
    height: int
    round_: int
    pol_round: int  # -1 when no proof-of-lock
    block_id: BlockID
    timestamp: Timestamp
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_proposal_sign_bytes(
            chain_id,
            self.height,
            self.round_,
            self.pol_round,
            None if self.block_id.is_zero() else self.block_id,
            self.timestamp,
        )

    def validate_basic(self) -> str | None:
        if self.height < 0:
            return "negative height"
        if self.round_ < 0:
            return "negative round"
        if self.pol_round < -1 or self.pol_round >= self.round_:
            return "invalid pol_round"
        if not self.block_id.is_complete():
            return "proposal block id must be complete"
        if not self.signature:
            return "missing signature"
        return None
