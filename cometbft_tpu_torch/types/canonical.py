"""Canonical sign-bytes construction (reference: types/canonical.go:57,
types/vote.go:151, types/proposal.go).

Sign bytes are the protoio length-delimited encoding of the Canonical*
message.  Byte-stability here is consensus-critical: every validator must
produce identical sign bytes for identical votes.
"""

from __future__ import annotations

from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types.basic import BlockID, Timestamp


def canonical_vote_sign_bytes(
    chain_id: str,
    type_: int,
    height: int,
    round_: int,
    block_id: BlockID | None,
    timestamp: Timestamp,
) -> bytes:
    body = b"".join(
        [
            pe.t_varint(1, type_),
            pe.t_sfixed64(2, height),
            pe.t_sfixed64(3, round_),
            pe.t_message(4, block_id.canonical_encode()) if block_id else b"",
            pe.t_message(5, timestamp.encode()),
            pe.t_string(6, chain_id),
        ]
    )
    return pe.length_prefixed(body)


def canonical_proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id: BlockID | None,
    timestamp: Timestamp,
) -> bytes:
    from cometbft_tpu_torch.types.basic import PROPOSAL_TYPE

    body = b"".join(
        [
            pe.t_varint(1, PROPOSAL_TYPE),
            pe.t_sfixed64(2, height),
            pe.t_sfixed64(3, round_),
            pe.t_sfixed64(4, pol_round),
            pe.t_message(5, block_id.canonical_encode()) if block_id else b"",
            pe.t_message(6, timestamp.encode()),
            pe.t_string(7, chain_id),
        ]
    )
    return pe.length_prefixed(body)


def canonical_vote_extension_sign_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """Reference: types/vote.go VoteExtensionSignBytes / CanonicalVoteExtension."""
    body = b"".join(
        [
            pe.t_bytes(1, extension),
            pe.t_sfixed64(2, height),
            pe.t_sfixed64(3, round_),
            pe.t_string(4, chain_id),
        ]
    )
    return pe.length_prefixed(body)
