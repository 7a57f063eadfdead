"""Deterministic protobuf-wire codec for core types.

Encode/decode for Block, Header, Commit, Vote, etc. — used by part sets,
stores and the WAL.  Field numbering follows the reference's proto schema
(proto/cometbft/types/types.proto) so the wire shapes are comparable.
"""

from __future__ import annotations

from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, Timestamp
from cometbft_tpu_torch.types.block import (
    Block,
    Commit,
    ConsensusVersion,
    Data,
    Header,
)
from cometbft_tpu_torch.types.vote import CommitSig, Proposal, Vote


# -- timestamps -------------------------------------------------------------

def decode_timestamp(body: bytes) -> Timestamp:
    f = pe.fields_dict(body)
    return Timestamp(
        seconds=pe.to_int64(f.get(1, [0])[-1]), nanos=pe.to_int64(f.get(2, [0])[-1])
    )


# -- block id ---------------------------------------------------------------

def decode_part_set_header(body: bytes) -> PartSetHeader:
    f = pe.fields_dict(body)
    return PartSetHeader(total=f.get(1, [0])[-1], hash=bytes(f.get(2, [b""])[-1]))


def decode_block_id(body: bytes) -> BlockID:
    f = pe.fields_dict(body)
    psh = f.get(2)
    return BlockID(
        hash=bytes(f.get(1, [b""])[-1]),
        part_set_header=decode_part_set_header(psh[-1]) if psh else PartSetHeader(),
    )


# -- header -----------------------------------------------------------------

def encode_header(h: Header) -> bytes:
    return b"".join(
        [
            pe.t_message(1, h.version.encode()),
            pe.t_string(2, h.chain_id),
            pe.t_varint(3, h.height),
            pe.t_message(4, h.time.encode()),
            pe.t_message(5, h.last_block_id.encode()),
            pe.t_bytes(6, h.last_commit_hash),
            pe.t_bytes(7, h.data_hash),
            pe.t_bytes(8, h.validators_hash),
            pe.t_bytes(9, h.next_validators_hash),
            pe.t_bytes(10, h.consensus_hash),
            pe.t_bytes(11, h.app_hash),
            pe.t_bytes(12, h.last_results_hash),
            pe.t_bytes(13, h.evidence_hash),
            pe.t_bytes(14, h.proposer_address),
        ]
    )


def decode_header(body: bytes) -> Header:
    f = pe.fields_dict(body)
    ver = ConsensusVersion(0, 0)
    if 1 in f:
        vf = pe.fields_dict(f[1][-1])
        ver = ConsensusVersion(vf.get(1, [0])[-1], vf.get(2, [0])[-1])
    return Header(
        version=ver,
        chain_id=bytes(f.get(2, [b""])[-1]).decode(),
        height=pe.to_int64(f.get(3, [0])[-1]),
        time=decode_timestamp(f[4][-1]) if 4 in f else Timestamp(),
        last_block_id=decode_block_id(f[5][-1]) if 5 in f else BlockID(),
        last_commit_hash=bytes(f.get(6, [b""])[-1]),
        data_hash=bytes(f.get(7, [b""])[-1]),
        validators_hash=bytes(f.get(8, [b""])[-1]),
        next_validators_hash=bytes(f.get(9, [b""])[-1]),
        consensus_hash=bytes(f.get(10, [b""])[-1]),
        app_hash=bytes(f.get(11, [b""])[-1]),
        last_results_hash=bytes(f.get(12, [b""])[-1]),
        evidence_hash=bytes(f.get(13, [b""])[-1]),
        proposer_address=bytes(f.get(14, [b""])[-1]),
    )


# -- commit -----------------------------------------------------------------

def encode_commit_sig(cs: CommitSig) -> bytes:
    return b"".join(
        [
            pe.t_varint(1, cs.block_id_flag),
            pe.t_bytes(2, cs.validator_address),
            pe.t_message(3, cs.timestamp.encode()),
            pe.t_bytes(4, cs.signature),
        ]
    )


def decode_commit_sig(body: bytes) -> CommitSig:
    f = pe.fields_dict(body)
    return CommitSig(
        block_id_flag=f.get(1, [0])[-1],
        validator_address=bytes(f.get(2, [b""])[-1]),
        timestamp=decode_timestamp(f[3][-1]) if 3 in f else Timestamp(),
        signature=bytes(f.get(4, [b""])[-1]),
    )


def encode_commit(c: Commit) -> bytes:
    out = [
        pe.t_varint(1, c.height),
        pe.t_varint(2, c.round_),
        pe.t_message(3, c.block_id.encode(), always=True),
    ]
    for cs in c.signatures:
        out.append(pe.t_message(4, encode_commit_sig(cs), always=True))
    return b"".join(out)


def decode_commit(body: bytes) -> Commit:
    f = pe.fields_dict(body)
    return Commit(
        height=pe.to_int64(f.get(1, [0])[-1]),
        round_=f.get(2, [0])[-1],
        block_id=decode_block_id(f[3][-1]) if 3 in f else BlockID(),
        signatures=[decode_commit_sig(b) for b in f.get(4, [])],
    )


def encode_extended_commit_sig(cs) -> bytes:
    """Reference wire shape: cometbft.types.v1.ExtendedCommitSig."""
    return encode_commit_sig(cs) + pe.t_bytes(5, cs.extension) + pe.t_bytes(
        6, cs.extension_signature
    )


def decode_extended_commit_sig(body: bytes):
    from cometbft_tpu_torch.types.vote import ExtendedCommitSig

    base = decode_commit_sig(body)
    f = pe.fields_dict(body)
    return ExtendedCommitSig(
        block_id_flag=base.block_id_flag,
        validator_address=base.validator_address,
        timestamp=base.timestamp,
        signature=base.signature,
        extension=bytes(f.get(5, [b""])[-1]),
        extension_signature=bytes(f.get(6, [b""])[-1]),
    )


def encode_extended_commit(c) -> bytes:
    out = [
        pe.t_varint(1, c.height),
        pe.t_varint(2, c.round_),
        pe.t_message(3, c.block_id.encode(), always=True),
    ]
    for cs in c.extended_signatures:
        out.append(pe.t_message(4, encode_extended_commit_sig(cs), always=True))
    return b"".join(out)


def decode_extended_commit(body: bytes):
    from cometbft_tpu_torch.types.block import ExtendedCommit

    f = pe.fields_dict(body)
    return ExtendedCommit(
        height=pe.to_int64(f.get(1, [0])[-1]),
        round_=f.get(2, [0])[-1],
        block_id=decode_block_id(f[3][-1]) if 3 in f else BlockID(),
        extended_signatures=[
            decode_extended_commit_sig(b) for b in f.get(4, [])
        ],
    )


# -- data / block -----------------------------------------------------------

def encode_data(d: Data) -> bytes:
    return b"".join(pe.t_message(1, tx, always=True) for tx in d.txs)


def decode_data(body: bytes) -> Data:
    f = pe.fields_dict(body)
    return Data(txs=[bytes(t) for t in f.get(1, [])])


def encode_block(b: Block) -> bytes:
    b.fill_header_hashes()
    ev_list = b"".join(
        pe.t_message(1, encode_evidence(ev), always=True) for ev in b.evidence
    )
    return b"".join(
        [
            pe.t_message(1, encode_header(b.header), always=True),
            pe.t_message(2, encode_data(b.data), always=True),
            pe.t_message(3, ev_list, always=True),
            pe.t_message(4, encode_commit(b.last_commit), always=True),
        ]
    )


def decode_block(body: bytes) -> Block:
    f = pe.fields_dict(body)
    evidence = []
    if 3 in f:
        ef = pe.fields_dict(f[3][-1])
        evidence = [decode_evidence(e) for e in ef.get(1, [])]
    return Block(
        header=decode_header(f[1][-1]),
        data=decode_data(f[2][-1]) if 2 in f else Data(),
        last_commit=decode_commit(f[4][-1]) if 4 in f else Commit(0, 0, BlockID(), []),
        evidence=evidence,
    )


# -- vote / proposal --------------------------------------------------------

def encode_vote(v: Vote) -> bytes:
    return b"".join(
        [
            pe.t_varint(1, v.type_),
            pe.t_varint(2, v.height),
            pe.t_varint(3, v.round_),
            pe.t_message(4, v.block_id.encode()),
            pe.t_message(5, v.timestamp.encode()),
            pe.t_bytes(6, v.validator_address),
            pe.t_varint(7, v.validator_index + 1),  # +1: index 0 must survive
            pe.t_bytes(8, v.signature),
            pe.t_bytes(9, v.extension),
            pe.t_bytes(10, v.extension_signature),
        ]
    )


def decode_vote(body: bytes) -> Vote:
    f = pe.fields_dict(body)
    return Vote(
        type_=f.get(1, [0])[-1],
        height=pe.to_int64(f.get(2, [0])[-1]),
        round_=f.get(3, [0])[-1],
        block_id=decode_block_id(f[4][-1]) if 4 in f else BlockID(),
        timestamp=decode_timestamp(f[5][-1]) if 5 in f else Timestamp(),
        validator_address=bytes(f.get(6, [b""])[-1]),
        validator_index=f.get(7, [0])[-1] - 1,
        signature=bytes(f.get(8, [b""])[-1]),
        extension=bytes(f.get(9, [b""])[-1]),
        extension_signature=bytes(f.get(10, [b""])[-1]),
    )


def encode_proposal(p: Proposal) -> bytes:
    return b"".join(
        [
            pe.t_varint(1, p.height),
            pe.t_varint(2, p.round_),
            pe.t_varint(3, p.pol_round + 1),  # shift: -1 -> 0 omitted
            pe.t_message(4, p.block_id.encode()),
            pe.t_message(5, p.timestamp.encode()),
            pe.t_bytes(6, p.signature),
        ]
    )


def decode_proposal(body: bytes) -> Proposal:
    f = pe.fields_dict(body)
    return Proposal(
        height=pe.to_int64(f.get(1, [0])[-1]),
        round_=f.get(2, [0])[-1],
        pol_round=f.get(3, [0])[-1] - 1,
        block_id=decode_block_id(f[4][-1]) if 4 in f else BlockID(),
        timestamp=decode_timestamp(f[5][-1]) if 5 in f else Timestamp(),
        signature=bytes(f.get(6, [b""])[-1]),
    )


# -- validators / validator sets (wire form for evidence + light blocks) ----

def encode_validator(v) -> bytes:
    """Proto Validator{pub_key{type=key}, voting_power, proposer_priority}
    (reference: proto/cometbft/types/validator.proto)."""
    key_field = {"ed25519": 1, "secp256k1": 2, "bls12_381": 3}[v.pub_key.type_]
    pub = pe.t_bytes(key_field, v.pub_key.bytes())
    return (
        pe.t_message(1, pub, always=True)
        + pe.t_varint(2, v.voting_power)
        + pe.t_varint(3, v.proposer_priority)
    )


def decode_validator(body: bytes):
    from cometbft_tpu_torch.crypto import keys as ck
    from cometbft_tpu_torch.types.validator import Validator

    f = pe.fields_dict(body)
    pf = pe.fields_dict(f[1][-1])
    for field_num, key_type in ((1, "ed25519"), (2, "secp256k1"), (3, "bls12_381")):
        if field_num in pf:
            pub = ck.pub_key_from_type(key_type, bytes(pf[field_num][-1]))
            break
    else:
        raise ValueError("validator has no public key")
    return Validator(
        pub_key=pub,
        voting_power=pe.to_int64(f.get(2, [0])[-1]),
        proposer_priority=pe.to_int64(f.get(3, [0])[-1]),
    )


def encode_validator_set(vals) -> bytes:
    out = [pe.t_message(1, encode_validator(v), always=True) for v in vals.validators]
    out.append(pe.t_message(2, encode_validator(vals.get_proposer()), always=True))
    return b"".join(out)


def decode_validator_set(body: bytes):
    from cometbft_tpu_torch.types.validator import ValidatorSet

    f = pe.fields_dict(body)
    vs = ValidatorSet.__new__(ValidatorSet)
    vals = [decode_validator(v) for v in f.get(1, [])]
    # bypass __init__ (which re-increments proposer priorities) to preserve
    # the wire-carried priorities exactly
    vs.validators = vals
    vs.proposer = decode_validator(f[2][-1]) if 2 in f else None
    vs._total_voting_power = None
    vs._addr_index = None
    return vs


# -- signed headers / light blocks ------------------------------------------

def encode_signed_header(sh) -> bytes:
    return pe.t_message(1, encode_header(sh.header), always=True) + pe.t_message(
        2, encode_commit(sh.commit), always=True
    )


def decode_signed_header(body: bytes):
    from cometbft_tpu_torch.types.light import SignedHeader

    f = pe.fields_dict(body)
    return SignedHeader(
        header=decode_header(f[1][-1]),
        commit=decode_commit(f[2][-1]),
    )


def encode_light_block(lb) -> bytes:
    return pe.t_message(
        1, encode_signed_header(lb.signed_header), always=True
    ) + pe.t_message(2, encode_validator_set(lb.validator_set), always=True)


def decode_light_block(body: bytes):
    from cometbft_tpu_torch.types.light import LightBlock

    f = pe.fields_dict(body)
    return LightBlock(
        signed_header=decode_signed_header(f[1][-1]),
        validator_set=decode_validator_set(f[2][-1]),
    )


# -- evidence ----------------------------------------------------------------

def encode_evidence(ev) -> bytes:
    """Proto Evidence oneof: 1=DuplicateVoteEvidence, 2=LightClientAttackEvidence
    (reference: proto/cometbft/types/evidence.proto)."""
    from cometbft_tpu_torch.types.evidence import (
        DuplicateVoteEvidence,
        LightClientAttackEvidence,
    )

    if isinstance(ev, DuplicateVoteEvidence):
        body = (
            pe.t_message(1, encode_vote(ev.vote_a), always=True)
            + pe.t_message(2, encode_vote(ev.vote_b), always=True)
            + pe.t_varint(3, ev.total_voting_power)
            + pe.t_varint(4, ev.validator_power)
            + pe.t_message(5, ev.timestamp.encode())
        )
        return pe.t_message(1, body, always=True)
    if isinstance(ev, LightClientAttackEvidence):
        body = (
            pe.t_message(1, encode_light_block(ev.conflicting_block), always=True)
            + pe.t_varint(2, ev.common_height)
            + b"".join(
                pe.t_message(3, encode_validator(v), always=True)
                for v in ev.byzantine_validators
            )
            + pe.t_varint(4, ev.total_voting_power)
            + pe.t_message(5, ev.timestamp.encode())
        )
        return pe.t_message(2, body, always=True)
    raise TypeError(f"cannot encode evidence {type(ev).__name__}")


def decode_evidence(body: bytes):
    from cometbft_tpu_torch.types.evidence import (
        DuplicateVoteEvidence,
        LightClientAttackEvidence,
    )

    f = pe.fields_dict(body)
    if 1 in f:
        df = pe.fields_dict(f[1][-1])
        return DuplicateVoteEvidence(
            vote_a=decode_vote(df[1][-1]),
            vote_b=decode_vote(df[2][-1]),
            total_voting_power=pe.to_int64(df.get(3, [0])[-1]),
            validator_power=pe.to_int64(df.get(4, [0])[-1]),
            timestamp=decode_timestamp(df[5][-1]) if 5 in df else Timestamp(),
        )
    if 2 in f:
        lf = pe.fields_dict(f[2][-1])
        return LightClientAttackEvidence(
            conflicting_block=decode_light_block(lf[1][-1]),
            common_height=pe.to_int64(lf.get(2, [0])[-1]),
            byzantine_validators=[decode_validator(v) for v in lf.get(3, [])],
            total_voting_power=pe.to_int64(lf.get(4, [0])[-1]),
            timestamp=decode_timestamp(lf[5][-1]) if 5 in lf else Timestamp(),
        )
    raise ValueError("unknown evidence kind")
