"""SignedHeader and LightBlock (reference: types/light.go).

A ``SignedHeader`` is a header plus the commit that signed it; a
``LightBlock`` adds the validator set that produced the commit.  These are
the units the light client verifies and the payload of light-client-attack
evidence.  The port's counterparts of the JAX package's ``types/light.py``;
``LightBlock.validate_basic`` hashes the validator set through the
hashing plane (the card's tree kernel at 32 or more validators) on the
``device`` it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.types.block import Commit, Header
from cometbft_tpu_torch.types.validator import ValidatorSet


@dataclass
class SignedHeader:
    """Reference: types/light.go SignedHeader."""

    header: Header
    commit: Commit

    def hash(self) -> bytes:
        return self.header.hash()

    @property
    def height(self) -> int:
        return self.header.height

    def validate_basic(self, chain_id: str, device=None) -> Optional[str]:
        if self.header is None:
            return "missing header"
        if self.commit is None:
            return "missing commit"
        err = self.header.validate_basic()
        if err:
            return err
        err = self.commit.validate_basic()
        if err:
            return err
        if self.header.chain_id != chain_id:
            return f"header chain id {self.header.chain_id!r} != {chain_id!r}"
        if self.commit.height != self.header.height:
            return (
                f"commit height {self.commit.height} != header height "
                f"{self.header.height}"
            )
        if self.commit.block_id.hash != self.header.hash(device):
            return "commit signs a different header"
        return None


@dataclass
class LightBlock:
    """Reference: types/light.go LightBlock."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    def hash(self) -> bytes:
        return self.signed_header.hash()

    def validate_basic(self, chain_id: str, device=None) -> Optional[str]:
        """``device`` names where the hashes go (``plane.tree_hash``)."""
        if self.signed_header is None:
            return "missing signed header"
        if self.validator_set is None:
            return "missing validator set"
        err = self.signed_header.validate_basic(chain_id, device)
        if err:
            return err
        if (
            self.signed_header.header.validators_hash
            != self.validator_set.hash(device)
        ):
            return "validator set does not match header validators_hash"
        return None
