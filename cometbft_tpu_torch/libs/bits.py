"""Thread-safe bit array (reference: internal/bits/bit_array.go).

Gossiped in proto form between peers to advertise which votes / block parts a
peer already has; ``pick_random`` selects a set bit for gossip, ``sub`` and
``not_`` compute what a peer is missing.

The port's copy of the JAX package's ``libs/bits.py``: the same packed
bytes (bit ``i`` in byte ``i // 8`` at ``1 << (i % 8)``) and the same
results.  ``pick_random`` takes the ``random.Random`` to draw with, and
draws with the module's ``random`` without one, as the JAX method always
does.
"""

from __future__ import annotations

import random
import threading
from typing import Optional


class BitArray:
    def __init__(self, bits: int):
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)
        self._mtx = threading.Lock()

    @staticmethod
    def from_bools(bools: list[bool]) -> "BitArray":
        ba = BitArray(len(bools))
        for i, b in enumerate(bools):
            if b:
                ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._mtx:
            return bool(self._elems[i // 8] >> (i % 8) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._mtx:
            if v:
                self._elems[i // 8] |= 1 << (i % 8)
            else:
                self._elems[i // 8] &= ~(1 << (i % 8))
            return True

    def copy(self) -> "BitArray":
        out = BitArray(self.bits)
        with self._mtx:
            out._elems = bytearray(self._elems)
        return out

    def or_(self, other: "BitArray") -> "BitArray":
        out = BitArray(max(self.bits, other.bits))
        with self._mtx:
            for i, b in enumerate(self._elems):
                out._elems[i] |= b
        with other._mtx:
            for i, b in enumerate(other._elems):
                out._elems[i] |= b
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.bits, other.bits))
        with self._mtx, other._mtx:
            for i in range(len(out._elems)):
                out._elems[i] = self._elems[i] & other._elems[i]
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        with self._mtx:
            for i in range(len(self._elems)):
                out._elems[i] = ~self._elems[i] & 0xFF
        # mask tail bits beyond self.bits
        extra = len(out._elems) * 8 - self.bits
        if extra and out._elems:
            out._elems[-1] &= 0xFF >> extra
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (what `other` is missing)."""
        out = self.copy()
        with other._mtx:
            for i in range(min(len(out._elems), len(other._elems))):
                out._elems[i] &= ~other._elems[i] & 0xFF
        return out

    def is_empty(self) -> bool:
        with self._mtx:
            return not any(self._elems)

    def is_full(self) -> bool:
        with self._mtx:
            if self.bits == 0:
                return True
            full, extra = divmod(self.bits, 8)
            if any(b != 0xFF for b in self._elems[:full]):
                return False
            if extra:
                return self._elems[full] == (1 << extra) - 1
            return True

    def pick_random(self, rng: Optional[random.Random] = None) -> Optional[int]:
        indices = self.true_indices()
        if not indices:
            return None
        return (rng or random).choice(indices)

    def true_indices(self) -> list[int]:
        with self._mtx:
            return [
                i
                for i in range(self.bits)
                if self._elems[i // 8] >> (i % 8) & 1
            ]

    def update(self, other: "BitArray") -> None:
        """Overwrite with other's contents (same size assumed)."""
        with self._mtx, other._mtx:
            n = min(len(self._elems), len(other._elems))
            self._elems[:n] = other._elems[:n]

    def to_bools(self) -> list[bool]:
        with self._mtx:
            return [
                bool(self._elems[i // 8] >> (i % 8) & 1) for i in range(self.bits)
            ]

    def __str__(self) -> str:
        return "".join("x" if b else "_" for b in self.to_bools())
