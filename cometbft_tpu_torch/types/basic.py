"""Basic shared types: BlockID, PartSetHeader, signed-message types, time.

Reference: types/block.go (BlockID), types/part_set.go (PartSetHeader),
types/signable.go / proto SignedMsgType.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.libs import protoenc as pe

# SignedMsgType (proto enum value, reference: proto/cometbft/types/types.proto)
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2

# CommitSig block-ID flags (reference: types/block.go BlockIDFlag)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return pe.t_varint(1, self.total) + pe.t_bytes(2, self.hash)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def encode(self) -> bytes:
        """Regular proto encoding (BlockID: hash=1, part_set_header=2)."""
        return pe.t_bytes(1, self.hash) + pe.t_message(
            2, self.part_set_header.encode()
        )

    def canonical_encode(self) -> bytes:
        """CanonicalBlockID (reference: types/canonical.go): same layout but
        the part-set header is the canonical variant."""
        psh = pe.t_varint(1, self.part_set_header.total) + pe.t_bytes(
            2, self.part_set_header.hash
        )
        return pe.t_bytes(1, self.hash) + pe.t_message(2, psh)


def encode_timestamp(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp message body."""
    return pe.t_varint(1, seconds) + pe.t_varint(2, nanos)


@dataclass(frozen=True, order=True)
class Timestamp:
    """Nanosecond-precision UTC time (the reference uses Go time.Time)."""

    seconds: int = 0
    nanos: int = 0

    def encode(self) -> bytes:
        return encode_timestamp(self.seconds, self.nanos)

    def to_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos
