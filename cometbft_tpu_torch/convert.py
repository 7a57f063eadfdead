"""Carry state from the JAX package's objects into the port's.

This system has no weights: its state is the validator set, the commit and
the packed signature batch, and the votes gossiped between validators.
The readers below are duck-typed — they read
only plain attributes (``pub_key.bytes()``, ``voting_power``, ``height``,
``block_id.hash``, ``signatures[i].timestamp.seconds``, ...) — so the port
never imports the JAX package, and a test can build one commit and verify
it in both.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.ops.verify import batch_to_device
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, Timestamp
from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import CommitSig, Vote


def batch_from_numpy(arrays: dict, device) -> dict:
    """The JAX ``prepare_batch`` dict of numpy arrays (``a_bytes``,
    ``r_bytes``, ``s_bytes``, ``m_bytes``: (B, 32) uint8; ``s_ok``: (B,)
    bool) -> the port's tensors on ``device``, ready for
    ``ops.cuda_verify.verify_core_cuda``."""
    return batch_to_device(arrays, device)


def validator_set_from(obj) -> ValidatorSet:
    """A validator set with the same validators, order, voting powers,
    proposer priorities and proposer.  The set is rebuilt as it stands:
    the constructor's proposer-priority increment is not run again."""
    vals = [
        Validator(
            Ed25519PubKey(bytes(v.pub_key.bytes())),
            int(v.voting_power),
            int(v.proposer_priority),
        )
        for v in obj.validators
    ]
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
                timestamp=Timestamp(
                    int(cs.timestamp.seconds), int(cs.timestamp.nanos)
                ),
                signature=bytes(cs.signature),
            )
            for cs in obj.signatures
        ],
    )


def vote_from(obj) -> Vote:
    """A vote with the same fields, signature and vote extension."""
    return Vote(
        type_=int(obj.type_),
        height=int(obj.height),
        round_=int(obj.round_),
        block_id=block_id_from(obj.block_id),
        timestamp=Timestamp(int(obj.timestamp.seconds), int(obj.timestamp.nanos)),
        validator_address=bytes(obj.validator_address),
        validator_index=int(obj.validator_index),
        signature=bytes(obj.signature),
        extension=bytes(obj.extension),
        extension_signature=bytes(obj.extension_signature),
    )
