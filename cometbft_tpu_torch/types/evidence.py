"""Evidence of byzantine behavior (reference: types/evidence.go).

Two kinds, as in the reference: ``DuplicateVoteEvidence`` (equivocation —
two signed votes for the same height/round/type but different blocks) and
``LightClientAttackEvidence`` (a conflicting light block signed by a subset
of a historical validator set).  Evidence hashes into the block header's
``evidence_hash`` and crosses ABCI as ``Misbehavior`` records.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types.basic import Timestamp
from cometbft_tpu_torch.types.light import LightBlock
from cometbft_tpu_torch.types.vote import Vote


class EvidenceError(Exception):
    pass


@dataclass
class DuplicateVoteEvidence:
    """Reference: types/evidence.go DuplicateVoteEvidence.

    vote_a/vote_b ordered by block-id hash (vote_a < vote_b), as the
    reference's NewDuplicateVoteEvidence normalizes.
    """

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp)

    TYPE = "duplicate_vote"

    @staticmethod
    def from_votes(
        vote1: Vote,
        vote2: Vote,
        block_time: Timestamp,
        validator_power: int,
        total_voting_power: int,
    ) -> "DuplicateVoteEvidence":
        """Normalized constructor (reference: NewDuplicateVoteEvidence)."""
        if vote1.block_id.key() < vote2.block_id.key():
            a, b = vote1, vote2
        else:
            a, b = vote2, vote1
        return DuplicateVoteEvidence(
            vote_a=a,
            vote_b=b,
            total_voting_power=total_voting_power,
            validator_power=validator_power,
            timestamp=block_time,
        )

    @property
    def height(self) -> int:
        return self.vote_a.height

    @property
    def time(self) -> Timestamp:
        return self.timestamp

    def bytes_(self) -> bytes:
        from cometbft_tpu_torch.types import codec

        return codec.encode_evidence(self)

    def hash(self) -> bytes:
        return tmhash.sum256(self.bytes_())

    def abci(self) -> list[at.Misbehavior]:
        return [
            at.Misbehavior(
                type_=at.MISBEHAVIOR_DUPLICATE_VOTE,
                validator=at.Validator(
                    address=self.vote_a.validator_address,
                    power=self.validator_power,
                ),
                height=self.vote_a.height,
                time_unix_ns=self.timestamp.to_ns(),
                total_voting_power=self.total_voting_power,
            )
        ]

    def validate_basic(self) -> Optional[str]:
        if self.vote_a is None or self.vote_b is None:
            return "missing vote"
        err = self.vote_a.validate_basic()
        if err:
            return f"invalid vote A: {err}"
        err = self.vote_b.validate_basic()
        if err:
            return f"invalid vote B: {err}"
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            return "duplicate votes in invalid order (or the same block id)"
        return None

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"DuplicateVoteEvidence{{val={self.vote_a.validator_address.hex()} "
            f"h={self.height}}}"
        )


@dataclass
class LightClientAttackEvidence:
    """Reference: types/evidence.go LightClientAttackEvidence."""

    conflicting_block: LightBlock
    common_height: int
    byzantine_validators: list = field(default_factory=list)  # [Validator]
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp)

    TYPE = "light_client_attack"

    @property
    def height(self) -> int:
        return self.common_height

    @property
    def time(self) -> Timestamp:
        return self.timestamp

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic attack: the conflicting header deviates in a field the
        validators cannot legitimately produce (reference:
        types/evidence.go ConflictingHeaderIsInvalid)."""
        h = self.conflicting_block.signed_header.header
        return (
            trusted_header.validators_hash != h.validators_hash
            or trusted_header.next_validators_hash != h.next_validators_hash
            or trusted_header.consensus_hash != h.consensus_hash
            or trusted_header.app_hash != h.app_hash
            or trusted_header.last_results_hash != h.last_results_hash
        )

    def bytes_(self) -> bytes:
        from cometbft_tpu_torch.types import codec

        return codec.encode_evidence(self)

    def hash(self) -> bytes:
        return tmhash.sum256(self.bytes_())

    def abci(self) -> list[at.Misbehavior]:
        return [
            at.Misbehavior(
                type_=at.MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                validator=at.Validator(
                    address=v.address, power=v.voting_power
                ),
                height=self.common_height,
                time_unix_ns=self.timestamp.to_ns(),
                total_voting_power=self.total_voting_power,
            )
            for v in self.byzantine_validators
        ]

    def validate_basic(self) -> Optional[str]:
        if self.conflicting_block is None:
            return "missing conflicting block"
        if self.conflicting_block.signed_header is None:
            return "missing conflicting header"
        if self.common_height <= 0:
            return "non-positive common height"
        h = self.conflicting_block.signed_header.header
        if self.common_height > h.height:
            return (
                f"common height {self.common_height} > conflicting block "
                f"height {h.height}"
            )
        return None

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"LightClientAttackEvidence{{common_height={self.common_height}}}"
        )


Evidence = object  # duck-typed: DuplicateVoteEvidence | LightClientAttackEvidence


def evidence_list_hash(evidence: list) -> bytes:
    from cometbft_tpu_torch.proofserve import plane

    return plane.tree_hash([ev.hash() for ev in evidence])


def evidence_list_bytes(evidence: list) -> int:
    return sum(len(ev.bytes_()) for ev in evidence)
