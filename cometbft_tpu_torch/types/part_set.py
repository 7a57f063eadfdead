"""Block part sets: chunking + merkle proofs for gossip
(reference: types/part_set.go:182).

Blocks are chunked into fixed-size parts; the part-set hash is the merkle
root over the part bytes, letting peers verify each part independently and
gossip them in parallel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.types.basic import PartSetHeader

BLOCK_PART_SIZE_BYTES = 65536  # reference: types/params.go BlockPartSizeBytes


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> str | None:
        if self.index < 0:
            return "negative part index"
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            return "part too large"
        if self.proof.index != self.index:
            return "part proof index mismatch"
        return None


class PartSet:
    def __init__(self, header: PartSetHeader):
        self.header = header
        self.parts: list[Optional[Part]] = [None] * header.total
        self.count = 0
        self.byte_size = 0

    @staticmethod
    def from_data(data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)]
        if not chunks:
            chunks = [b""]
        from cometbft_tpu_torch.proofserve import plane

        root, proofs = plane.tree_proofs(chunks)
        ps = PartSet(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps.parts[i] = Part(index=i, bytes_=chunk, proof=proof)
        ps.count = len(chunks)
        ps.byte_size = len(data)
        return ps

    def add_part(self, part: Part) -> tuple[bool, str | None]:
        if part.index >= self.header.total:
            return False, "part index out of bounds"
        if self.parts[part.index] is not None:
            return False, None  # duplicate, not an error
        err = part.validate_basic()
        if err:
            return False, err
        if not part.proof.verify(self.header.hash, part.bytes_):
            return False, "invalid part proof"
        self.parts[part.index] = part
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True, None

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < len(self.parts):
            return self.parts[index]
        return None

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise ValueError("part set incomplete")
        return b"".join(p.bytes_ for p in self.parts)  # type: ignore

    def bit_array(self) -> list[bool]:
        return [p is not None for p in self.parts]
