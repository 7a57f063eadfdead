"""Header and Commit (reference: types/block.go).

``Header.hash()`` is the Merkle root over the proto-encoded header fields
(reference: types/block.go Header.Hash).  A Commit carries one CommitSig
per validator in validator-set order, and ``vote_sign_bytes``
reconstructs the exact canonical vote each validator signed (reference:
types/block.go:901).  Both hashes go through the port's hashing plane
(``proofserve/plane``), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cometbft_tpu_torch import native
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.proofserve import plane
from cometbft_tpu_torch.types.basic import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    PRECOMMIT_TYPE,
    BlockID,
    Timestamp,
)
from cometbft_tpu_torch.types.canonical import canonical_vote_sign_bytes
from cometbft_tpu_torch.types.vote import CommitSig


@dataclass(frozen=True)
class ConsensusVersion:
    """Proto Consensus{block, app} version pair."""

    block: int
    app: int = 0

    def encode(self) -> bytes:
        return pe.t_varint(1, self.block) + pe.t_varint(2, self.app)


@dataclass
class Header:
    version: ConsensusVersion
    chain_id: str
    height: int
    time: Timestamp
    last_block_id: BlockID
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self, device=None) -> bytes:
        """Merkle root over the proto encodings of each field, in order (14
        leaves: hashed on the host by the plane's size gate; ``device`` as
        for ``plane.tree_hash``)."""
        if not self.validators_hash:
            return b""
        fields = [
            self.version.encode(),
            self.chain_id.encode(),
            pe.uvarint(self.height),
            self.time.encode(),
            self.last_block_id.encode(),
            self.last_commit_hash,
            self.data_hash,
            self.validators_hash,
            self.next_validators_hash,
            self.consensus_hash,
            self.app_hash,
            self.last_results_hash,
            self.evidence_hash,
            self.proposer_address,
        ]
        return plane.tree_hash(fields, device)

    def validate_basic(self) -> "str | None":
        if not self.chain_id or len(self.chain_id) > 50:
            return "invalid chain id"
        if self.height < 0:
            return "negative height"
        if self.proposer_address and len(self.proposer_address) != 20:
            return "invalid proposer address"
        return None


@dataclass
class Commit:
    height: int
    round_: int
    block_id: BlockID
    signatures: list[CommitSig]

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Reconstruct the canonical sign bytes of validator idx's precommit
        (reference: types/block.go:901 -> vote.go:151 -> canonical.go:57)."""
        cs = self.signatures[idx]
        block_id = self.block_id if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT else None
        return canonical_vote_sign_bytes(
            chain_id,
            PRECOMMIT_TYPE,
            self.height,
            self.round_,
            block_id,
            cs.timestamp,
        )

    def all_vote_sign_bytes(
        self, chain_id: str, indices: "list[int] | None" = None
    ) -> list[bytes]:
        """Sign bytes for many signatures at once (all of them when
        ``indices`` is None): one call of the host library's
        ``commit_sign_bytes`` (``csrc/host_prep.cpp``) builds every
        CanonicalVote.  ``vote_sign_bytes`` is its per-index reference.
        Raises if the host library cannot be built or its output buffer
        is too small."""
        idxs = range(len(self.signatures)) if indices is None else indices
        n = len(idxs)
        if n == 0:
            return []
        lib = native.lib()
        sigs = [self.signatures[i] for i in idxs]
        flags = np.fromiter((cs.block_id_flag for cs in sigs), np.int64, n)
        ts_s = np.fromiter((cs.timestamp.seconds for cs in sigs), np.int64, n)
        ts_ns = np.fromiter((cs.timestamp.nanos for cs in sigs), np.int64, n)
        cid = chain_id.encode()
        bid, psh = self.block_id, self.block_id.part_set_header
        # per-vote ceiling: type 2 + height/round 18 + block id ~80 +
        # timestamp ~16 + chain id + delimited framing 5
        cap = n * (128 + len(cid)) + 256
        out = np.empty(cap, np.uint8)
        offs = np.empty(n + 1, np.int64)
        total = lib.commit_sign_bytes(
            cid, len(cid), self.height, self.round_,
            bid.hash, len(bid.hash), psh.total, psh.hash, len(psh.hash),
            flags.ctypes.data, ts_s.ctypes.data, ts_ns.ctypes.data, n,
            out.ctypes.data, cap, offs.ctypes.data,
        )
        if total < 0:
            raise RuntimeError(
                f"commit_sign_bytes: a vote does not fit its buffer "
                f"({cap} bytes for {n} votes, chain id of {len(cid)} bytes)"
            )
        raw = out[:total].tobytes()
        o = offs.tolist()
        return [raw[o[i] : o[i + 1]] for i in range(n)]

    def hash(self) -> bytes:
        """Merkle root of the proto-encoded CommitSigs, in order."""
        items = [
            pe.t_varint(1, cs.block_id_flag)
            + pe.t_bytes(2, cs.validator_address)
            + pe.t_message(3, cs.timestamp.encode())
            + pe.t_bytes(4, cs.signature)
            for cs in self.signatures
        ]
        return plane.tree_hash(items)

    def validate_basic(self) -> str | None:
        if self.height < 0:
            return "negative height"
        if self.round_ < 0:
            return "negative round"
        if self.height >= 1:
            if self.block_id.is_zero():
                return "commit cannot be for nil block"
            if not self.signatures:
                return "no signatures in commit"
        for cs in self.signatures:
            if cs.block_id_flag not in (
                BLOCK_ID_FLAG_ABSENT,
                BLOCK_ID_FLAG_COMMIT,
                BLOCK_ID_FLAG_NIL,
            ):
                return "invalid block id flag"
            if cs.block_id_flag == BLOCK_ID_FLAG_ABSENT:
                if cs.validator_address or cs.signature:
                    return "absent signature with data"
            else:
                if len(cs.validator_address) != 20:
                    return "invalid validator address"
                if not cs.signature or len(cs.signature) > 96:
                    return "invalid signature size"
        return None
