"""Consensus parameters (reference: types/params.go).

Chain-wide parameters updatable by the application per block
(reference: state/execution.go:290).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs import protoenc as pe

MAX_BLOCK_SIZE_BYTES = 100 * 1024 * 1024


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 4 * 1024 * 1024  # 4 MiB default (reference: params.go)
    max_gas: int = -1

    def validate(self) -> str | None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            return "block.max_bytes must be -1 or positive"
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            return "block.max_bytes too large"
        if self.max_gas < -1:
            return "block.max_gas must be >= -1"
        return None


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1024 * 1024

    def validate(self) -> str | None:
        if self.max_age_num_blocks <= 0:
            return "evidence.max_age_num_blocks must be positive"
        if self.max_age_duration_ns <= 0:
            return "evidence.max_age_duration must be positive"
        return None


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = ("ed25519",)

    def validate(self) -> str | None:
        if not self.pub_key_types:
            return "validator.pub_key_types must not be empty"
        return None


@dataclass(frozen=True)
class FeatureParams:
    """Feature-activation heights (reference: types/params.go FeatureParams).
    0 = disabled; h > 0 = enabled from height h."""

    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0

    def validate(self) -> str | None:
        if self.vote_extensions_enable_height < 0:
            return "feature.vote_extensions_enable_height cannot be negative"
        if self.pbts_enable_height < 0:
            return "feature.pbts_enable_height cannot be negative"
        return None


@dataclass(frozen=True)
class SynchronyParams:
    """PBTS clock-synchrony bounds (reference: types/params.go)."""

    precision_ns: int = 505_000_000
    message_delay_ns: int = 15_000_000_000

    def validate(self) -> str | None:
        if self.precision_ns < 0 or self.message_delay_ns < 0:
            return "synchrony params cannot be negative"
        return None


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    feature: FeatureParams = field(default_factory=FeatureParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)

    def validate(self) -> str | None:
        for part in (self.block, self.evidence, self.validator, self.feature, self.synchrony):
            err = part.validate()
            if err:
                return err
        return None

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.feature.vote_extensions_enable_height
        return h > 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.feature.pbts_enable_height
        return h > 0 and height >= h

    def hash(self) -> bytes:
        """Deterministic hash for Header.consensus_hash (reference:
        types/params.go HashConsensusParams)."""
        body = b"".join(
            [
                pe.t_varint(1, self.block.max_bytes),
                pe.t_varint(2, self.block.max_gas),
                pe.t_varint(3, self.evidence.max_age_num_blocks),
                pe.t_varint(4, self.evidence.max_age_duration_ns),
                pe.t_varint(5, self.evidence.max_bytes),
                b"".join(pe.t_string(6, t) for t in self.validator.pub_key_types),
                pe.t_varint(7, self.feature.vote_extensions_enable_height),
                pe.t_varint(8, self.feature.pbts_enable_height),
            ]
        )
        return tmhash.sum256(body)

    def update(self, **kwargs) -> "ConsensusParams":
        return replace(self, **kwargs)


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
