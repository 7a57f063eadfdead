"""Block, Header, Data and Commit (reference: types/block.go).

``Header.hash()`` is the Merkle root over the proto-encoded header fields
(reference: types/block.go Header.Hash).  A Commit carries one CommitSig
per validator in validator-set order, and ``vote_sign_bytes``
reconstructs the exact canonical vote each validator signed (reference:
types/block.go:901).  Every hash (header, commit, data, evidence list,
and the part set a block is cut into) goes through the port's hashing
plane (``proofserve/plane``), as in the JAX package: a tree of 32 or more
leaves is one pass of the card's tree kernel once the plane's gate is
open.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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
from cometbft_tpu_torch.types.part_set import PartSet
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
class Data:
    txs: list[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        return plane.tree_hash(list(self.txs))


@dataclass
class ExtendedCommit:
    """A commit whose signatures carry the precommits' vote extensions
    (reference: types/block.go ExtendedCommit).  Persisted by the block
    store when extensions are enabled so a restarting proposer can still
    hand the app its ExtendedCommitInfo."""

    height: int
    round_: int
    block_id: "BlockID"
    extended_signatures: list

    def to_commit(self) -> "Commit":
        return Commit(
            height=self.height,
            round_=self.round_,
            block_id=self.block_id,
            signatures=[s.to_commit_sig() for s in self.extended_signatures],
        )


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


def empty_commit() -> Commit:
    return Commit(height=0, round_=0, block_id=BlockID(), signatures=[])


def commit_sigs(commit) -> list:
    """Signature list of a plain or extended commit (``is None`` test, not
    truthiness: a decoded-empty extended signature list must not fall
    through to a ``signatures`` attribute ExtendedCommit lacks)."""
    ext = getattr(commit, "extended_signatures", None)
    return commit.signatures if ext is None else ext


def commit_vote(commit, idx: int):
    """Reconstruct validator idx's precommit from a stored commit
    (reference: types/block.go Commit.GetByIndex).  Works for plain and
    extended commits — extended signatures restore the vote extension,
    without which peers at extension-enabled heights reject the vote.
    Returns None for an absent signature."""
    from cometbft_tpu_torch.types.vote import Vote

    cs = commit_sigs(commit)[idx]
    if cs.absent():
        return None
    return Vote(
        type_=PRECOMMIT_TYPE,
        height=commit.height,
        round_=commit.round_,
        block_id=cs.block_id(commit.block_id),
        timestamp=cs.timestamp,
        validator_address=cs.validator_address,
        validator_index=idx,
        signature=cs.signature,
        extension=getattr(cs, "extension", b""),
        extension_signature=getattr(cs, "extension_signature", b""),
    )


@dataclass
class Block:
    header: Header
    data: Data
    last_commit: Commit
    evidence: list = field(default_factory=list)

    def fill_header_hashes(self) -> None:
        if not self.header.last_commit_hash:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = plane.tree_hash(
                [ev.hash() for ev in self.evidence]
            )

    def hash(self) -> bytes:
        self.fill_header_hashes()
        return self.header.hash()

    def encode(self) -> bytes:
        """Deterministic serialization for parts/storage."""
        from cometbft_tpu_torch.types import codec

        return codec.encode_block(self)

    def make_part_set(self, part_size: int = 65536) -> PartSet:
        return PartSet.from_data(self.encode(), part_size)

    def block_id(self, part_set: Optional[PartSet] = None) -> BlockID:
        ps = part_set or self.make_part_set()
        return BlockID(hash=self.hash(), part_set_header=ps.header)

    def validate_basic(self) -> str | None:
        err = self.header.validate_basic()
        if err:
            return err
        err = self.last_commit.validate_basic()
        if err:
            return err
        self.fill_header_hashes()
        if self.header.last_commit_hash != self.last_commit.hash():
            return "last commit hash mismatch"
        if self.header.data_hash != self.data.hash():
            return "data hash mismatch"
        if self.header.evidence_hash != plane.tree_hash(
            [ev.hash() for ev in self.evidence]
        ):
            return "evidence hash mismatch"
        return None
