"""Validator and ValidatorSet (reference: types/validator.go,
types/validator_set.go).

The proposer-priority arithmetic is consensus-critical and mirrors the
reference exactly (validator_set.go:17-23,131-263): priorities are rescaled
into a window of 2*TotalVotingPower, centered around zero, incremented by
voting power each round, and the max-priority validator proposes and pays
TotalVotingPower.  Total voting power is capped at MaxInt64/8 to keep all
intermediate sums inside int64.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Optional

from cometbft_tpu_torch.libs import protoenc as pe

MAX_INT64 = (1 << 63) - 1
MAX_TOTAL_VOTING_POWER = MAX_INT64 // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _int64_guard(v: int) -> int:
    if not (-(1 << 63) <= v < (1 << 63)):
        raise OverflowError(f"int64 overflow in proposer priority arithmetic: {v}")
    return v


@dataclass
class Validator:
    pub_key: object  # crypto key object with .bytes()/.address()/.verify_signature
    voting_power: int
    proposer_priority: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties broken by smaller address (reference:
        validator.go CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("duplicate validator address")

    def simple_encode(self) -> bytes:
        """SimpleValidator proto used for the validator-set Merkle hash
        (reference: types/validator.go ToSimpleValidator / Hash).  As the
        JAX package does, every key is tagged as field 1 of PublicKey (the
        Ed25519 field), whatever its type."""
        pub = pe.t_message(1, pe.t_bytes(1, self.pub_key.bytes()))
        return pub + pe.t_varint(2, self.voting_power)

    def copy(self) -> "Validator":
        return replace(self)


class ValidatorSet:
    """Ordered validator set.  Validators are kept sorted by address;
    the proposer is tracked via proposer priorities."""

    def __init__(self, validators: Iterable[Validator]):
        vals = [v.copy() for v in validators]
        vals.sort(key=lambda v: v.address)
        addrs = [v.address for v in vals]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        for v in vals:
            if v.voting_power < 0:
                raise ValueError("negative voting power")
        self.validators: list[Validator] = vals
        self.proposer: Optional[Validator] = None
        self._total_voting_power: Optional[int] = None
        self._addr_index: Optional[dict] = None
        if vals:
            self.increment_proposer_priority(1)

    # -- lookups ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def has_address(self, address: bytes) -> bool:
        return self.get_by_address(address) is not None

    def get_by_address(self, address: bytes) -> Optional[tuple[int, Validator]]:
        idx_map = self._addr_index
        if idx_map is None or len(idx_map) != len(self.validators):
            idx_map = {v.address: i for i, v in enumerate(self.validators)}
            self._addr_index = idx_map
        i = idx_map.get(address)
        if i is None or self.validators[i].address != address:
            # index stale (validators mutated in place): rebuild once
            idx_map = {v.address: j for j, v in enumerate(self.validators)}
            self._addr_index = idx_map
            i = idx_map.get(address)
            if i is None:
                return None
        return i, self.validators[i]

    def get_by_index(self, index: int) -> Optional[Validator]:
        if 0 <= index < len(self.validators):
            return self.validators[index]
        return None

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            total = sum(v.voting_power for v in self.validators)
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power {total} exceeds cap {MAX_TOTAL_VOTING_POWER}"
                )
            self._total_voting_power = total
        return self._total_voting_power

    # -- proposer rotation (consensus-critical) ---------------------------

    def increment_proposer_priority(self, times: int) -> None:
        if times <= 0:
            raise ValueError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self._rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_once()
        self.proposer = proposer

    def _increment_once(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _int64_guard(
                v.proposer_priority + v.voting_power
            )
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        mostest.proposer_priority = _int64_guard(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0 or not self.validators:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                # Go integer division truncates toward zero.
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _shift_by_avg_proposer_priority(self) -> None:
        if not self.validators:
            return
        n = len(self.validators)
        total = sum(v.proposer_priority for v in self.validators)
        # truncate toward zero, like the reference's big.Int Quo
        avg = abs(total) // n
        if total < 0:
            avg = -avg
        for v in self.validators:
            v.proposer_priority = _int64_guard(v.proposer_priority - avg)

    def get_proposer(self) -> Validator:
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        return mostest

    # -- updates ----------------------------------------------------------

    def copy(self) -> "ValidatorSet":
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new._addr_index = None
        new.proposer = None
        if self.proposer is not None:
            found = new.get_by_address(self.proposer.address)
            new.proposer = found[1] if found else self.proposer.copy()
        new._total_voting_power = self._total_voting_power
        return new

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        new = self.copy()
        new.increment_proposer_priority(times)
        return new

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply validator updates: power 0 removes, new addresses join with
        priority -1.125*P (reference: validator_set.go updateWithChangeSet,
        computeNewPriorities), with the JAX package's errors and order."""
        if not changes:
            return
        by_addr = {}
        for c in changes:
            if c.address in by_addr:
                raise ValueError("duplicate address in change set")
            if c.voting_power < 0:
                raise ValueError("negative voting power in update")
            by_addr[c.address] = c

        removals = {a for a, c in by_addr.items() if c.voting_power == 0}
        for a in removals:
            if self.get_by_address(a) is None:
                raise ValueError("removal of non-existent validator")

        kept = [v for v in self.validators if v.address not in removals]
        kept_addrs = {v.address for v in kept}
        for v in kept:
            c = by_addr.get(v.address)
            if c is not None and c.voting_power > 0:
                v.voting_power = c.voting_power
        joining = [c for a, c in by_addr.items()
                   if c.voting_power > 0 and a not in kept_addrs]

        new_total = sum(v.voting_power for v in kept) + sum(
            c.voting_power for c in joining)
        if new_total > MAX_TOTAL_VOTING_POWER:
            raise OverflowError("updated total voting power exceeds cap")
        if new_total == 0:
            raise ValueError("validator set update would empty the set")

        for c in joining:
            nv = c.copy()
            # New validators start out "in debt" so they cannot propose
            # immediately (reference: validator_set.go:~computeNewPriorities).
            nv.proposer_priority = -(new_total + (new_total >> 3))
            kept.append(nv)

        kept.sort(key=lambda v: v.address)
        self.validators = kept
        self._addr_index = None
        self._total_voting_power = None
        self.total_voting_power()  # validate cap
        self._shift_by_avg_proposer_priority()
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        if self.proposer is not None:
            found = self.get_by_address(self.proposer.address)
            self.proposer = found[1] if found else None

    # -- hashing ----------------------------------------------------------

    def hash(self, device=None) -> bytes:
        """Merkle root of SimpleValidator encodings in set order (reference:
        types/validator_set.go Hash), through the hashing plane at 32 or
        more validators: on ``device``, or with None on the card's tree
        kernel once the card is trusted."""
        from cometbft_tpu_torch.proofserve import plane

        return plane.tree_hash([v.simple_encode() for v in self.validators],
                               device)
