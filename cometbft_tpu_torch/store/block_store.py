"""Block store: blocks as parts + metas + commits (reference: store/store.go).

Key layout mirrors the reference (store/store.go:58-84): block metas, parts,
commits and seen-commits keyed by height, plus a persisted [base, height]
range for pruning.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.store.kv import KVStore
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.block import Block, Commit
from cometbft_tpu_torch.types.part_set import Part, PartSet


def _k_meta(height: int) -> bytes:
    return b"H:" + height.to_bytes(8, "big")


def _k_part(height: int, index: int) -> bytes:
    return b"P:" + height.to_bytes(8, "big") + index.to_bytes(4, "big")


def _k_commit(height: int) -> bytes:
    return b"C:" + height.to_bytes(8, "big")


def _k_seen_commit(height: int) -> bytes:
    return b"SC:" + height.to_bytes(8, "big")


def _k_ext_commit(height: int) -> bytes:
    return b"EC:" + height.to_bytes(8, "big")


_K_STATE = b"blockStore"


@dataclass
class BlockMeta:
    """Reference: types/block_meta.go — carries the full header so RPC
    routes (blockchain, header, status) need not load block parts."""

    block_id: BlockID
    block_size: int
    num_txs: int
    header: "Header"

    @property
    def header_height(self) -> int:
        return self.header.height

    def encode(self) -> bytes:
        return b"".join(
            [
                pe.t_message(1, self.block_id.encode(), always=True),
                pe.t_varint(2, self.block_size),
                pe.t_varint(3, self.num_txs),
                pe.t_message(4, codec.encode_header(self.header), always=True),
            ]
        )

    @staticmethod
    def decode(body: bytes) -> "BlockMeta":
        f = pe.fields_dict(body)
        return BlockMeta(
            block_id=codec.decode_block_id(f[1][-1]) if 1 in f else BlockID(),
            block_size=f.get(2, [0])[-1],
            num_txs=f.get(3, [0])[-1],
            header=codec.decode_header(f[4][-1]),
        )


class BlockStore:
    """Reference: store/store.go:124 (BlockStore struct + methods)."""

    def __init__(self, db: KVStore):
        self._db = db
        self._lock = threading.RLock()
        raw = db.get(_K_STATE)
        if raw:
            st = json.loads(raw.decode())
            self._base, self._height = st["base"], st["height"]
        else:
            self._base, self._height = 0, 0

    def base(self) -> int:
        with self._lock:
            return self._base

    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return 0 if self._height == 0 else self._height - self._base + 1

    def _save_range(self) -> None:
        self._db.set(
            _K_STATE,
            json.dumps({"base": self._base, "height": self._height}).encode(),
        )

    # -- writes -----------------------------------------------------------

    def save_block(
        self,
        block: Block,
        part_set: PartSet,
        seen_commit: Commit,
        extended_commit=None,
    ):
        """Reference: store/store.go:586 SaveBlock / SaveBlockWithExtendedCommit
        — ``extended_commit`` is stored when vote extensions are enabled so
        a restarting proposer can rebuild the app's ExtendedCommitInfo."""
        height = block.header.height
        with self._lock:
            if self._height > 0 and height != self._height + 1:
                raise ValueError(
                    f"cannot save block at height {height}; expected {self._height + 1}"
                )
            if not part_set.is_complete():
                raise ValueError("cannot save block with incomplete part set")
            sets = []
            meta = BlockMeta(
                block_id=BlockID(hash=block.hash(), part_set_header=part_set.header),
                block_size=part_set.byte_size,
                num_txs=len(block.data.txs),
                header=block.header,
            )
            sets.append((_k_meta(height), meta.encode()))
            for i in range(part_set.header.total):
                part = part_set.get_part(i)
                sets.append((_k_part(height, i), self._encode_part(part)))
            sets.append(
                (_k_commit(height - 1), codec.encode_commit(block.last_commit))
            )
            sets.append((_k_seen_commit(height), codec.encode_commit(seen_commit)))
            if extended_commit is not None:
                sets.append(
                    (
                        _k_ext_commit(height),
                        codec.encode_extended_commit(extended_commit),
                    )
                )
            self._db.write_batch(sets, [])
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_range()

    @staticmethod
    def _encode_part(part: Part) -> bytes:
        proof = part.proof
        proof_enc = b"".join(
            [
                pe.t_varint(1, proof.total),
                pe.t_varint(2, proof.index + 1),
                pe.t_bytes(3, proof.leaf_hash),
            ]
            + [pe.t_bytes(4, a) for a in proof.aunts]
        )
        return b"".join(
            [
                pe.t_varint(1, part.index + 1),
                pe.t_bytes(2, part.bytes_),
                pe.t_message(3, proof_enc, always=True),
            ]
        )

    @staticmethod
    def _decode_part(body: bytes) -> Part:
        from cometbft_tpu_torch.crypto.merkle import Proof

        f = pe.fields_dict(body)
        pf = pe.fields_dict(f[3][-1])
        proof = Proof(
            total=pf.get(1, [0])[-1],
            index=pf.get(2, [1])[-1] - 1,
            leaf_hash=bytes(pf.get(3, [b""])[-1]),
            aunts=[bytes(a) for a in pf.get(4, [])],
        )
        return Part(
            index=f.get(1, [1])[-1] - 1, bytes_=bytes(f.get(2, [b""])[-1]), proof=proof
        )

    # -- reads ------------------------------------------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_k_meta(height))
        return BlockMeta.decode(raw) if raw else None

    def load_block(self, height: int) -> Optional[Block]:
        """Reference: store/store.go:222 LoadBlock (reassembles parts)."""
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        chunks = []
        for i in range(meta.block_id.part_set_header.total):
            raw = self._db.get(_k_part(height, i))
            if raw is None:
                return None
            chunks.append(self._decode_part(raw).bytes_)
        return codec.decode_block(b"".join(chunks))

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_k_part(height, index))
        return self._decode_part(raw) if raw else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """Commit for block at `height` (stored with block height+1)."""
        raw = self._db.get(_k_commit(height))
        return codec.decode_commit(raw) if raw else None

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        """Reference: store.go SaveSeenCommit (used by statesync bootstrap)."""
        self._db.set(_k_seen_commit(height), codec.encode_commit(commit))

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(_k_seen_commit(height))
        return codec.decode_commit(raw) if raw else None

    def load_extended_commit(self, height: int):
        """Reference: store.go LoadBlockExtendedCommit."""
        raw = self._db.get(_k_ext_commit(height))
        return codec.decode_extended_commit(raw) if raw else None

    def load_block_meta_by_hash(self, block_hash: bytes) -> Optional[BlockMeta]:
        """Reference: store.go LoadBlockMetaByHash — meta only, so callers
        like header_by_hash never decode a full block's txs."""
        with self._lock:
            lo, hi = self._base, self._height
        for h in range(hi, lo - 1, -1):
            meta = self.load_block_meta(h)
            if meta and meta.block_id.hash == block_hash:
                return meta
        return None

    def load_block_by_hash(self, block_hash: bytes) -> Optional[Block]:
        meta = self.load_block_meta_by_hash(block_hash)
        return self.load_block(meta.header.height) if meta else None

    # -- pruning ----------------------------------------------------------

    def delete_latest_block(self) -> None:
        """Remove the highest block (reference: store/store.go
        DeleteLatestBlock, used by hard rollback)."""
        with self._lock:
            h = self._height
            if h == 0:
                return
            # keep _k_commit(h-1): it certifies the block that REMAINS the
            # head (reference: store/store.go DeleteLatestBlock deletes the
            # commit key at the target height only)
            deletes = [
                _k_meta(h),
                _k_commit(h),
                _k_seen_commit(h),
                _k_ext_commit(h),
            ]
            meta = self.load_block_meta(h)
            if meta:
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_k_part(h, i))
            self._db.write_batch([], deletes)
            self._height = h - 1
            self._save_range()

    def prune_blocks(self, retain_height: int) -> int:
        """Reference: store/store.go:474 PruneBlocks.  Returns pruned count."""
        with self._lock:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height + 1:
                raise ValueError("cannot prune beyond store height + 1")
            deletes = []
            pruned = 0
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta:
                    for i in range(meta.block_id.part_set_header.total):
                        deletes.append(_k_part(h, i))
                deletes += [
                    _k_meta(h),
                    _k_commit(h - 1),
                    _k_seen_commit(h),
                    _k_ext_commit(h),
                ]
                pruned += 1
            self._db.write_batch([], deletes)
            self._base = retain_height
            self._save_range()
            return pruned
