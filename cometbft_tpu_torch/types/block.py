"""Commit (reference: types/block.go).

A Commit carries one CommitSig per validator in validator-set order, and
``vote_sign_bytes`` reconstructs the exact canonical vote each validator
signed (reference: types/block.go:901).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cometbft_tpu_torch import native
from cometbft_tpu_torch.types.basic import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    PRECOMMIT_TYPE,
    BlockID,
)
from cometbft_tpu_torch.types.canonical import canonical_vote_sign_bytes
from cometbft_tpu_torch.types.vote import CommitSig


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
