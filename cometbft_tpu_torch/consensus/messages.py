"""Consensus messages + WAL serialization.

Reference: internal/consensus/msgs.go (p2p + WAL payloads).  The state
machine consumes three data messages (Proposal, BlockPart, Vote); the reactor
adds round-state gossip messages (NewRoundStep, NewValidBlock, HasVote,
VoteSetMaj23, VoteSetBits, ProposalPOL).  WAL records are tagged frames:
1-byte kind + payload in the same deterministic proto encoding used on the
wire, so crash replay feeds the identical bytes back through the handler.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.part_set import Part
from cometbft_tpu_torch.types.vote import Proposal, Vote

# message kinds (WAL + wire tags)
MSG_PROPOSAL = 1
MSG_BLOCK_PART = 2
MSG_VOTE = 3
MSG_TIMEOUT = 4  # WAL-only: timeout that was processed
MSG_EVENT_ROUND_STEP = 5  # WAL-only: state-transition marker for replay

MSG_NEW_ROUND_STEP = 16
MSG_NEW_VALID_BLOCK = 17
MSG_PROPOSAL_POL = 18
MSG_HAS_VOTE = 19
MSG_VOTE_SET_MAJ23 = 20
MSG_VOTE_SET_BITS = 21
MSG_HAS_PROPOSAL_BLOCK_PART = 22


@dataclass
class ProposalMessage:
    proposal: Proposal


@dataclass
class BlockPartMessage:
    height: int
    round_: int
    part: Part


@dataclass
class VoteMessage:
    vote: Vote


@dataclass
class NewRoundStepMessage:
    height: int
    round_: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1


@dataclass
class NewValidBlockMessage:
    height: int
    round_: int
    block_part_set_header: object = None  # PartSetHeader
    blockparts: list[bool] = field(default_factory=list)
    is_commit: bool = False


@dataclass
class HasVoteMessage:
    height: int
    round_: int
    type_: int
    index: int


@dataclass
class VoteSetMaj23Message:
    height: int
    round_: int
    type_: int
    block_id: BlockID = field(default_factory=BlockID)


@dataclass
class VoteSetBitsMessage:
    height: int
    round_: int
    type_: int
    block_id: BlockID = field(default_factory=BlockID)
    votes: list[bool] = field(default_factory=list)


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: list[bool] = field(default_factory=list)


@dataclass
class MsgInfo:
    """A message + where it came from ("" = internal).

    ``trace_ctx`` is the OPTIONAL flight-recorder trace context the gossip
    envelope carried (an encoded ``libs.tracing.TraceContext`` token, or
    None): pure observability metadata — it never reaches the WAL or the
    wire codec, so a node with tracing off is byte-compatible."""

    msg: object
    peer_id: str = ""
    trace_ctx: Optional[object] = None


# -- serialization ----------------------------------------------------------

def _encode_part(part: Part) -> bytes:
    proof = part.proof
    proof_enc = (
        pe.t_varint(1, proof.total)
        + pe.t_varint(2, proof.index)
        + pe.t_bytes(3, proof.leaf_hash)
    )
    for aunt in proof.aunts:
        proof_enc += pe.t_bytes(4, aunt)
    return (
        pe.t_varint(1, part.index)
        + pe.t_bytes(2, part.bytes_)
        + pe.t_message(3, proof_enc)
    )


def _decode_part(body: bytes) -> Part:
    from cometbft_tpu_torch.crypto.merkle import Proof

    fields = pe.fields_dict(body)
    pf = pe.fields_dict(fields.get(3, [b""])[0])
    proof = Proof(
        total=pf.get(1, [0])[0],
        index=pf.get(2, [0])[0],
        leaf_hash=pf.get(3, [b""])[0],
        aunts=pf.get(4, []),
    )
    return Part(
        index=fields.get(1, [0])[0], bytes_=fields.get(2, [b""])[0], proof=proof
    )


def encode_msg(msg: object) -> bytes:
    """Tagged encoding for WAL + wire."""
    if isinstance(msg, ProposalMessage):
        return bytes([MSG_PROPOSAL]) + codec.encode_proposal(msg.proposal)
    if isinstance(msg, BlockPartMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_message(3, _encode_part(msg.part))
        )
        return bytes([MSG_BLOCK_PART]) + body
    if isinstance(msg, VoteMessage):
        return bytes([MSG_VOTE]) + codec.encode_vote(msg.vote)
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_msg(raw: bytes) -> object:
    kind, body = raw[0], raw[1:]
    if kind == MSG_PROPOSAL:
        return ProposalMessage(codec.decode_proposal(body))
    if kind == MSG_BLOCK_PART:
        fields = pe.fields_dict(body)
        return BlockPartMessage(
            height=fields.get(1, [0])[0],
            round_=fields.get(2, [0])[0],
            part=_decode_part(fields.get(3, [b""])[0]),
        )
    if kind == MSG_VOTE:
        return VoteMessage(codec.decode_vote(body))
    raise ValueError(f"unknown message kind {kind}")


def encode_timeout_wal(duration: float, height: int, round_: int, step: int) -> bytes:
    body = (
        pe.t_varint(1, int(duration * 1e9))
        + pe.t_varint(2, height)
        + pe.t_varint(3, round_)
        + pe.t_varint(4, step)
    )
    return bytes([MSG_TIMEOUT]) + body


def decode_timeout_wal(raw: bytes):
    fields = pe.fields_dict(raw[1:])
    return (
        fields.get(1, [0])[0] / 1e9,
        fields.get(2, [0])[0],
        fields.get(3, [0])[0],
        fields.get(4, [0])[0],
    )


# -- gossip message serialization (reactor channels 0x20-0x23) ---------------

def _encode_bits(bits: list[bool]) -> bytes:
    n = len(bits)
    packed = bytearray((n + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            packed[i // 8] |= 1 << (i % 8)
    return pe.t_varint(1, n) + pe.t_bytes(2, bytes(packed))


def _decode_bits(body: bytes) -> list[bool]:
    f = pe.fields_dict(body)
    n = f.get(1, [0])[-1]
    packed = f.get(2, [b""])[-1]
    return [
        bool(packed[i // 8] & (1 << (i % 8))) if i // 8 < len(packed) else False
        for i in range(n)
    ]


def _encode_psh(psh) -> bytes:
    return pe.t_varint(1, psh.total) + pe.t_bytes(2, psh.hash)


def _decode_psh(body: bytes):
    from cometbft_tpu_torch.types.basic import PartSetHeader

    f = pe.fields_dict(body)
    return PartSetHeader(total=f.get(1, [0])[-1], hash=bytes(f.get(2, [b""])[-1]))


def encode_gossip_msg(msg: object) -> bytes:
    """Tagged encoding for the reactor's state/data/vote channels
    (reference: internal/consensus/msgs.go MsgToProto)."""
    if isinstance(msg, (ProposalMessage, BlockPartMessage, VoteMessage)):
        return encode_msg(msg)
    if isinstance(msg, NewRoundStepMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_varint(3, msg.step)
            + pe.t_varint(4, msg.seconds_since_start_time)
            + pe.t_varint(5, msg.last_commit_round + 1)
        )
        return bytes([MSG_NEW_ROUND_STEP]) + body
    if isinstance(msg, NewValidBlockMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_message(3, _encode_psh(msg.block_part_set_header), always=True)
            + pe.t_message(4, _encode_bits(msg.blockparts), always=True)
            + pe.t_varint(5, 1 if msg.is_commit else 0)
        )
        return bytes([MSG_NEW_VALID_BLOCK]) + body
    if isinstance(msg, HasVoteMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_varint(3, msg.type_)
            + pe.t_varint(4, msg.index + 1)
        )
        return bytes([MSG_HAS_VOTE]) + body
    if isinstance(msg, VoteSetMaj23Message):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_varint(3, msg.type_)
            + pe.t_message(4, msg.block_id.encode(), always=True)
        )
        return bytes([MSG_VOTE_SET_MAJ23]) + body
    if isinstance(msg, VoteSetBitsMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.round_)
            + pe.t_varint(3, msg.type_)
            + pe.t_message(4, msg.block_id.encode(), always=True)
            + pe.t_message(5, _encode_bits(msg.votes), always=True)
        )
        return bytes([MSG_VOTE_SET_BITS]) + body
    if isinstance(msg, ProposalPOLMessage):
        body = (
            pe.t_varint(1, msg.height)
            + pe.t_varint(2, msg.proposal_pol_round)
            + pe.t_message(3, _encode_bits(msg.proposal_pol), always=True)
        )
        return bytes([MSG_PROPOSAL_POL]) + body
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_gossip_msg(raw: bytes) -> object:
    from cometbft_tpu_torch.types import codec as _codec
    from cometbft_tpu_torch.types.codec import decode_block_id

    kind = raw[0]
    if kind in (MSG_PROPOSAL, MSG_BLOCK_PART, MSG_VOTE):
        return decode_msg(raw)
    body = raw[1:]
    f = pe.fields_dict(body)
    if kind == MSG_NEW_ROUND_STEP:
        return NewRoundStepMessage(
            height=pe.to_int64(f.get(1, [0])[-1]),
            round_=f.get(2, [0])[-1],
            step=f.get(3, [0])[-1],
            seconds_since_start_time=f.get(4, [0])[-1],
            last_commit_round=f.get(5, [0])[-1] - 1,
        )
    if kind == MSG_NEW_VALID_BLOCK:
        return NewValidBlockMessage(
            height=pe.to_int64(f.get(1, [0])[-1]),
            round_=f.get(2, [0])[-1],
            block_part_set_header=_decode_psh(f[3][-1]),
            blockparts=_decode_bits(f[4][-1]) if 4 in f else [],
            is_commit=bool(f.get(5, [0])[-1]),
        )
    if kind == MSG_HAS_VOTE:
        return HasVoteMessage(
            height=pe.to_int64(f.get(1, [0])[-1]),
            round_=f.get(2, [0])[-1],
            type_=f.get(3, [0])[-1],
            index=f.get(4, [0])[-1] - 1,
        )
    if kind == MSG_VOTE_SET_MAJ23:
        return VoteSetMaj23Message(
            height=pe.to_int64(f.get(1, [0])[-1]),
            round_=f.get(2, [0])[-1],
            type_=f.get(3, [0])[-1],
            block_id=decode_block_id(f[4][-1]) if 4 in f else BlockID(),
        )
    if kind == MSG_VOTE_SET_BITS:
        return VoteSetBitsMessage(
            height=pe.to_int64(f.get(1, [0])[-1]),
            round_=f.get(2, [0])[-1],
            type_=f.get(3, [0])[-1],
            block_id=decode_block_id(f[4][-1]) if 4 in f else BlockID(),
            votes=_decode_bits(f[5][-1]) if 5 in f else [],
        )
    if kind == MSG_PROPOSAL_POL:
        return ProposalPOLMessage(
            height=pe.to_int64(f.get(1, [0])[-1]),
            proposal_pol_round=f.get(2, [0])[-1],
            proposal_pol=_decode_bits(f[3][-1]) if 3 in f else [],
        )
    raise ValueError(f"unknown gossip message kind {kind}")
