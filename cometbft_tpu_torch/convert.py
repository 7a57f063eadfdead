"""Carry state from the JAX package's objects into the port's.

This system has no weights: its state is the validator set, the commit and
the packed signature batch, the votes gossiped between validators, a
node's key and the keys and nonce counters of its encrypted streams, and
a node's chain: its genesis document, blocks, evidence and consensus
state.
The readers below are duck-typed — they read
only plain attributes (``pub_key.bytes()``, ``voting_power``, ``height``,
``block_id.hash``, ``signatures[i].timestamp.seconds``, ...) — so the port
never imports the JAX package, and a test can build one commit and verify
it in both.
"""

from __future__ import annotations

import dataclasses

from cometbft_tpu_torch.crypto.keys import (
    ED25519_KEY_TYPE,
    Ed25519PrivKey,
    pub_key_from_type,
)
from cometbft_tpu_torch.ops.verify import batch_to_device
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, Timestamp
from cometbft_tpu_torch.types import params as tparams
from cometbft_tpu_torch.types.block import (
    Block,
    Commit,
    ConsensusVersion,
    Data,
    Header,
)
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import CommitSig, Vote


def batch_from_numpy(arrays: dict, device) -> dict:
    """The JAX ``prepare_batch`` dict of numpy arrays (``a_bytes``,
    ``r_bytes``, ``s_bytes``, ``m_bytes``: (B, 32) uint8; ``s_ok``: (B,)
    bool) -> the port's tensors on ``device``, ready for
    ``ops.cuda_verify.verify_core_cuda``."""
    return batch_to_device(arrays, device)


def timestamp_from(t) -> Timestamp:
    return Timestamp(int(t.seconds), int(t.nanos))


def validator_from(v) -> Validator:
    """A validator with the same key, voting power and proposer priority."""
    return Validator(
        pub_key_from_type(v.pub_key.type_, bytes(v.pub_key.bytes())),
        int(v.voting_power),
        int(v.proposer_priority),
    )


def validator_set_from(obj) -> ValidatorSet:
    """A validator set with the same validators (Ed25519, secp256k1 or
    BLS12-381 keys, by their ``type_``), order, voting powers, proposer
    priorities and proposer.  The set is rebuilt as it stands: the
    constructor's proposer-priority increment is not run again."""
    vals = [validator_from(v) for v in obj.validators]
    out = ValidatorSet.__new__(ValidatorSet)
    out.validators = vals
    out._total_voting_power = None
    out._addr_index = None
    out.proposer = None
    if obj.proposer is not None:
        found = out.get_by_address(bytes(obj.proposer.pub_key.address()))
        out.proposer = found[1] if found else None
    return out


def block_id_from(b) -> BlockID:
    psh = b.part_set_header
    return BlockID(bytes(b.hash), PartSetHeader(int(psh.total), bytes(psh.hash)))


def commit_from(obj) -> Commit:
    """A commit with the same height, round, block id and signatures."""
    return Commit(
        height=int(obj.height),
        round_=int(obj.round_),
        block_id=block_id_from(obj.block_id),
        signatures=[
            CommitSig(
                block_id_flag=int(cs.block_id_flag),
                validator_address=bytes(cs.validator_address),
                timestamp=timestamp_from(cs.timestamp),
                signature=bytes(cs.signature),
            )
            for cs in obj.signatures
        ],
    )


def header_from(obj) -> Header:
    """A header with the same fields (and so the same hash)."""
    return Header(
        version=ConsensusVersion(int(obj.version.block), int(obj.version.app)),
        chain_id=str(obj.chain_id),
        height=int(obj.height),
        time=timestamp_from(obj.time),
        last_block_id=block_id_from(obj.last_block_id),
        **{f: bytes(getattr(obj, f)) for f in (
            "last_commit_hash", "data_hash", "validators_hash",
            "next_validators_hash", "consensus_hash", "app_hash",
            "last_results_hash", "evidence_hash", "proposer_address")},
    )


def signed_header_from(obj) -> SignedHeader:
    return SignedHeader(header_from(obj.header), commit_from(obj.commit))


def light_block_from(obj) -> LightBlock:
    """A light block with the same signed header and validator set."""
    return LightBlock(signed_header_from(obj.signed_header),
                      validator_set_from(obj.validator_set))


def vote_from(obj) -> Vote:
    """A vote with the same fields, signature and vote extension."""
    return Vote(
        type_=int(obj.type_),
        height=int(obj.height),
        round_=int(obj.round_),
        block_id=block_id_from(obj.block_id),
        timestamp=timestamp_from(obj.timestamp),
        validator_address=bytes(obj.validator_address),
        validator_index=int(obj.validator_index),
        signature=bytes(obj.signature),
        extension=bytes(obj.extension),
        extension_signature=bytes(obj.extension_signature),
    )


def priv_key_from(obj) -> Ed25519PrivKey:
    """A node key (Ed25519, the key a SecretConnection authenticates with)
    with the same 32-byte seed."""
    if getattr(obj, "type_", None) != ED25519_KEY_TYPE:
        raise ValueError(f"a node key is Ed25519, not {getattr(obj, 'type_', None)!r}")
    return Ed25519PrivKey(bytes(obj.bytes()))


def half_duplex_from(obj, device=None):
    """One direction of a SecretConnection carried across: the same AEAD
    key and nonce counter, so the port seals and opens the frames that
    stream would seal and open next."""
    from cometbft_tpu_torch.p2p.secret_connection import _HalfDuplex

    hd = _HalfDuplex(bytes(obj._key), device)
    hd.nonce = int(obj.nonce)
    return hd


def _frozen_from(cls, obj):
    """A params dataclass of the port read field by field from ``obj``."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def params_from(obj) -> "tparams.ConsensusParams":
    """Consensus params with the same values (and so the same hash)."""
    return tparams.ConsensusParams(
        block=_frozen_from(tparams.BlockParams, obj.block),
        evidence=_frozen_from(tparams.EvidenceParams, obj.evidence),
        validator=tparams.ValidatorParams(
            pub_key_types=tuple(obj.validator.pub_key_types)),
        feature=_frozen_from(tparams.FeatureParams, obj.feature),
        synchrony=_frozen_from(tparams.SynchronyParams, obj.synchrony),
    )


def evidence_from(obj):
    """A ``DuplicateVoteEvidence`` or ``LightClientAttackEvidence`` (by the
    object's ``TYPE``) with the same votes or conflicting block, powers and
    timestamp, and so the same bytes and hash."""
    if obj.TYPE == DuplicateVoteEvidence.TYPE:
        return DuplicateVoteEvidence(
            vote_a=vote_from(obj.vote_a),
            vote_b=vote_from(obj.vote_b),
            total_voting_power=int(obj.total_voting_power),
            validator_power=int(obj.validator_power),
            timestamp=timestamp_from(obj.timestamp),
        )
    if obj.TYPE == LightClientAttackEvidence.TYPE:
        return LightClientAttackEvidence(
            conflicting_block=light_block_from(obj.conflicting_block),
            common_height=int(obj.common_height),
            byzantine_validators=[validator_from(v)
                                  for v in obj.byzantine_validators],
            total_voting_power=int(obj.total_voting_power),
            timestamp=timestamp_from(obj.timestamp),
        )
    raise ValueError(f"unknown evidence type {obj.TYPE!r}")


def block_from(obj) -> Block:
    """A block with the same header, txs, last commit and evidence."""
    return Block(
        header=header_from(obj.header),
        data=Data(txs=[bytes(tx) for tx in obj.data.txs]),
        last_commit=commit_from(obj.last_commit),
        evidence=[evidence_from(ev) for ev in obj.evidence],
    )


def genesis_from(obj) -> GenesisDoc:
    """A genesis document with the same fields (and so the same JSON)."""
    return GenesisDoc(
        chain_id=str(obj.chain_id),
        genesis_time=timestamp_from(obj.genesis_time),
        initial_height=int(obj.initial_height),
        consensus_params=params_from(obj.consensus_params),
        validators=[
            GenesisValidator(
                pub_key_from_type(v.pub_key.type_, bytes(v.pub_key.bytes())),
                int(v.power),
                str(v.name),
            )
            for v in obj.validators
        ],
        app_hash=bytes(obj.app_hash),
        app_state=bytes(obj.app_state),
    )


def state_from(obj):
    """A consensus state with the same chain position, validator sets
    (priorities and proposers as they stand), params and hashes."""
    from cometbft_tpu_torch.state.state import State

    return State(
        chain_id=str(obj.chain_id),
        initial_height=int(obj.initial_height),
        last_block_height=int(obj.last_block_height),
        last_block_id=block_id_from(obj.last_block_id),
        last_block_time=timestamp_from(obj.last_block_time),
        validators=validator_set_from(obj.validators),
        next_validators=validator_set_from(obj.next_validators),
        last_validators=(None if obj.last_validators is None
                         else validator_set_from(obj.last_validators)),
        last_height_validators_changed=int(obj.last_height_validators_changed),
        consensus_params=params_from(obj.consensus_params),
        last_height_consensus_params_changed=int(
            obj.last_height_consensus_params_changed),
        last_results_hash=bytes(obj.last_results_hash),
        app_hash=bytes(obj.app_hash),
        version_app=int(obj.version_app),
    )
