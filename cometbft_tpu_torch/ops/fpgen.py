"""Batched prime-field arithmetic over any odd prime, in plain PyTorch.

The port's counterpart of ``cometbft_tpu/ops/fpgen.py``: one ``Field(p)``
serves every prime the curve layer needs (secp256k1's in
``ops.secp_verify``, BLS12-381's in ``ops.fp381``), with the JAX class's
API: ``pack``/``unpack``, ``to_mont``/``from_mont``, ``add``, ``sub``,
``neg``, ``mul_small``, ``mul``, ``square`` and ``carry``.  ``unpack`` gives the same canonical ints as the
JAX ``Field.unpack`` for the same field elements.

Layout (chosen for torch, not carried over from the TPU's 21 x 13-bit
int32 limbs): a batch is an ``(NLIMBS, B)`` int64 tensor of 16-bit limbs,
little-endian, batch last, in the Montgomery domain (value * R mod p,
R = 2^(16 * NLIMBS)).  Every limb is NON-NEGATIVE, and limbs are lazily
reduced: an ``F`` carries static bounds (Python ints) on its low limbs and
on its value, and every op derives its output's bounds from its inputs'.
The top limb's bound follows from the value's (no limb is negative).

  * ``add`` adds limbs; ``sub``/``neg`` add a multiple of p whose low limbs
    dominate the subtrahend's and whose top limb its top (``_bias``), so
    limbs stay non-negative without a carry;
  * ``mul`` forms the product columns from an outer product (its
    anti-diagonals summed by ``index_add_``) and reduces them by Montgomery
    REDC written limb-parallel: m = T mod R * (-1/p) mod R from the low
    columns, U = T + m*p, a few parallel carry rounds, and the carry out of
    U's low half, which is divisible by R, read as "any low limb nonzero"
    (its limbs are non-negative and its value below 2R, so it is 0 or R);
    the number of carry rounds of each stage follows from the bounds;
  * NLIMBS leaves at least 32 bits of headroom over p (R/p >= 2^32), so
    REDC contracts: products of the values the curve formulas reach reduce
    to about p again, and no bound grows along a 256-step ladder.

Integer columns are summed with ``sum``, never ``matmul``: ``torch.matmul``
has no integer path on CUDA, and TF32 must never touch a limb.
``canonical`` gives the fully reduced value's limbs on the device, for
comparisons and parity.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as tf

BITS = 16
HEADROOM_BITS = 32
INT64_LIMIT = 1 << 62  # column sums stay below this


class F(NamedTuple):
    """A batch of field elements: (NLIMBS, B) int64 limbs, each >= 0;
    ``hi`` bounds limbs 0..NLIMBS-2, ``val`` the encoded value."""

    v: torch.Tensor
    hi: int
    val: int


def select(bit: torch.Tensor, a: F, b: F) -> F:
    """Per lane (``bit``: (B,) int or bool): a where bit, else b."""
    return F(torch.where(bit[None, :] != 0, a.v, b.v), max(a.hi, b.hi),
             max(a.val, b.val))


class Field:
    """All field ops bound to one prime."""

    def __init__(self, p: int, bits: int = BITS):
        assert p % 2 == 1 and p > 2
        self.P_INT = p
        self.BITS = bits
        self.BASE = 1 << bits
        self.MASK = self.BASE - 1
        self.NLIMBS = -(-(p.bit_length() + HEADROOM_BITS) // bits)
        self.TOP_SHIFT = bits * (self.NLIMBS - 1)
        self.R_INT = 1 << (bits * self.NLIMBS)
        self.R_MOD_P = self.R_INT % p
        self.R2_MOD_P = self.R_INT * self.R_INT % p
        self.R_INV = pow(self.R_INT, -1, p)
        self.NPRIME = (-pow(p, -1, self.R_INT)) % self.R_INT

    # -- host helpers ------------------------------------------------------

    def limbs_of_int(self, n: int) -> list:
        assert 0 <= n < self.R_INT, "value does not fit"
        return [(n >> (self.BITS * i)) & self.MASK for i in range(self.NLIMBS)]

    def int_of_limbs(self, x) -> int:
        n = 0
        for limb in reversed(list(x)):
            n = (n << self.BITS) + int(limb)
        return n

    def to_mont(self, n: int) -> int:
        """Canonical int -> Montgomery representative (host packing)."""
        return n * self.R_MOD_P % self.P_INT

    def from_mont(self, n: int) -> int:
        """Montgomery representative (any value) -> canonical int."""
        return n * self.R_INV % self.P_INT

    def pack(self, vals, device=None) -> F:
        """Host: canonical ints -> a Montgomery-domain batch."""
        rows = [self.limbs_of_int(self.to_mont(n % self.P_INT)) for n in vals]
        v = torch.tensor(rows, dtype=torch.int64, device=device).reshape(
            len(rows), self.NLIMBS).T.contiguous()
        return F(v, self.MASK, self.P_INT - 1)

    def unpack(self, f: F) -> list:
        """Batch -> canonical ints."""
        cols = f.v.cpu().T.tolist()
        return [self.from_mont(self.int_of_limbs(c)) for c in cols]

    def const(self, n: int, batch: int = 1, device=None) -> F:
        """The Montgomery-domain constant n broadcast over ``batch`` lanes."""
        m = self.to_mont(n % self.P_INT)
        v = self._column(m, device).expand(self.NLIMBS, batch).contiguous()
        return F(v, self.MASK, m)

    @lru_cache(maxsize=64)
    def _column(self, n: int, device) -> torch.Tensor:
        """(NLIMBS, 1) limbs of the host int n, cached per device."""
        return torch.tensor(self.limbs_of_int(n), dtype=torch.int64,
                            device=device).reshape(self.NLIMBS, 1)

    # -- bounds ------------------------------------------------------------

    def top(self, a: F) -> int:
        """Bound of the top limb: no limb is negative, so top * 2^TOP_SHIFT
        <= value."""
        return a.val >> self.TOP_SHIFT

    def absmax(self, a: F) -> int:
        return max(a.hi, self.top(a))

    def _after_round(self, bound: int) -> int:
        return self.MASK + (bound >> self.BITS)

    def _settle_rounds(self, bound: int) -> tuple[int, int]:
        """Carry rounds taking limbs below ``bound`` to settled ones (at
        most 2 * MASK), and the bound after them."""
        rounds = 0
        while bound > 2 * self.MASK:
            bound = self._after_round(bound)
            rounds += 1
        return rounds, bound

    def _carry_round(self, v: torch.Tensor) -> torch.Tensor:
        """One parallel carry round: every limb keeps its low BITS and
        passes the rest up.  The top limb's own carry is dropped: exact
        where the value is below BASE^rows (every caller), and the mod-R
        truncation where it is not (m)."""
        c = v >> self.BITS
        out = v & self.MASK
        out[1:] += c[:-1]
        return out

    # -- ring ops ----------------------------------------------------------

    def add(self, a: F, b: F) -> F:
        return F(a.v + b.v, a.hi + b.hi, a.val + b.val)

    @lru_cache(maxsize=256)
    def _bias_int(self, hi: int, top: int) -> tuple:
        """(limbs, value) of a multiple of p whose low limbs are all >= hi
        and whose top limb is >= top: X - (X mod p) for X with low limbs h
        and top limb t, h and t powers of two."""
        h = 1 << (hi + self.MASK).bit_length()
        t = 1 << top.bit_length()
        x = sum(h << (self.BITS * j) for j in range(self.NLIMBS - 1))
        x += t << self.TOP_SHIFT
        r = x % self.P_INT
        r_limbs = self.limbs_of_int(r)  # its top two limbs are 0 (headroom)
        limbs = [h - r_limbs[j] for j in range(self.NLIMBS - 1)] + [t]
        return tuple(limbs), x - r

    def _bias(self, b: F, device) -> tuple:
        limbs, value = self._bias_int(b.hi, self.top(b))
        col = self._bias_column(limbs, device)
        return col, max(limbs[:-1]), value

    @lru_cache(maxsize=256)
    def _bias_column(self, limbs: tuple, device) -> torch.Tensor:
        return torch.tensor(limbs, dtype=torch.int64, device=device).reshape(-1, 1)

    def sub(self, a: F, b: F) -> F:
        col, hi, value = self._bias(b, b.v.device)
        return F(a.v + (col - b.v), a.hi + hi, a.val + value)

    def neg(self, a: F) -> F:
        col, hi, value = self._bias(a, a.v.device)
        return F(col - a.v, hi, value)

    def mul_small(self, a: F, k: int) -> F:
        assert k >= 0
        return F(a.v * k, a.hi * k, a.val * k)

    def carry(self, a: F) -> F:
        """The same value with settled limbs (each at most 2 * MASK)."""
        assert a.val < self.R_INT, "value past R: carry would drop bits"
        rounds, hi = self._settle_rounds(self.absmax(a))
        v = a.v
        for _ in range(rounds):
            v = self._carry_round(v)
        return F(v, hi, a.val)

    # -- multiplication ----------------------------------------------------

    def _cols(self, av: torch.Tensor, bv: torch.Tensor) -> torch.Tensor:
        """(2n, B) schoolbook product columns of two (n, B) limb arrays:
        the outer product's anti-diagonals summed by ``index_add_`` (row
        i + j takes a_i * b_j), and one empty top column."""
        n, b = av.shape
        prod = (av[:, None, :] * bv[None, :, :]).reshape(n * n, b)
        out = torch.zeros(2 * n, b, dtype=prod.dtype, device=prod.device)
        return out.index_add_(0, self._diagonals(n, prod.device), prod)

    @lru_cache(maxsize=8)
    def _diagonals(self, n: int, device) -> torch.Tensor:
        i = torch.arange(n, device=device)
        return (i[:, None] + i[None, :]).reshape(-1)

    def _redc(self, t: torch.Tensor, tb: int, tval: int) -> F:
        """Montgomery reduction of (2n, B) product columns ``t`` (each at
        most ``tb``, value at most ``tval`` < R^2): (T + m p) / R."""
        n, mask, p = self.NLIMBS, self.MASK, self.P_INT
        assert tval < self.R_INT * self.R_INT
        # T's low limbs small enough that their product with N' fits
        while n * tb * mask >= INT64_LIMIT:
            t = self._carry_round(t)
            tb = self._after_round(tb)
        # m = T mod R * N' mod R: the low columns, carries past R dropped
        m = self._cols(t[:n], self._column(self.NPRIME, t.device).expand_as(t[:n]))[:n]
        rounds, mb = self._settle_rounds(n * tb * mask)
        for _ in range(rounds):
            m = self._carry_round(m)
        mval = mb * ((self.R_INT - 1) // mask)
        # U = T + m p; its low half is divisible by R
        u = t + self._cols(m, self._column(p, t.device).expand_as(m))
        ub = tb + n * mb * mask
        assert ub < INT64_LIMIT
        uval = tval + mval * p
        assert uval < self.R_INT * self.R_INT
        rounds, ub = self._settle_rounds(ub)
        for _ in range(rounds):
            u = self._carry_round(u)
        # low limbs >= 0, settled, so their value is below 2R; it is
        # divisible by R: 0 or R
        out = u[n:].clone()
        out[0] += (u[:n] != 0).any(0)
        return F(out, ub + 1, uval // self.R_INT)

    def mul(self, a: F, b: F) -> F:
        """Montgomery product REDC(a * b)."""
        while self.NLIMBS * self.absmax(a) * self.absmax(b) >= INT64_LIMIT:
            if self.absmax(a) >= self.absmax(b):
                a = self.carry(a)
            else:
                b = self.carry(b)
        tb = self.NLIMBS * self.absmax(a) * self.absmax(b)
        return self._redc(self._cols(a.v, b.v), tb, a.val * b.val)

    def square(self, a: F) -> F:
        return self.mul(a, a)

    def mul_many(self, pairs) -> list:
        """[a * b for (a, b) in pairs] as one ``mul`` over the pairs stacked
        along the batch: independent products of a formula step cost one
        call's tensor ops instead of one call each."""
        a = F(torch.cat([x.v for x, _ in pairs], 1), max(x.hi for x, _ in pairs),
              max(x.val for x, _ in pairs))
        b = F(torch.cat([y.v for _, y in pairs], 1), max(y.hi for _, y in pairs),
              max(y.val for _, y in pairs))
        out = self.mul(a, b)
        return [F(v, out.hi, out.val) for v in out.v.chunk(len(pairs), 1)]

    # -- plain integers on the device ----------------------------------------

    def from_bytes_be(self, t: torch.Tensor) -> F:
        """(B, k) uint8 big-endian integers -> their Montgomery-domain batch
        (one mul by R^2 mod p)."""
        le = t.flip(1).to(torch.int64)
        if le.shape[1] % 2:
            le = tf.pad(le, (0, 1))
        limbs = le[:, 0::2] | (le[:, 1::2] << 8)
        assert limbs.shape[1] <= self.NLIMBS - 2
        plain = tf.pad(limbs, (0, self.NLIMBS - limbs.shape[1])).T.contiguous()
        x = F(plain, self.MASK, (1 << (8 * t.shape[1])) - 1)
        r2 = self._column(self.R2_MOD_P, t.device).expand_as(plain)
        return self.mul(x, F(r2, self.MASK, self.R2_MOD_P))

    def _ripple(self, v: torch.Tensor) -> torch.Tensor:
        """Sequential carry: limbs 0..n-2 in [0, BASE) (floor carries, so
        negative limbs borrow)."""
        v = v.clone()
        for j in range(self.NLIMBS - 1):
            c = v[j] >> self.BITS
            v[j] &= self.MASK
            v[j + 1] += c
        return v

    @staticmethod
    def compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B,) sign of a - b (-1, 0, 1) for normalized limbs (n, B)."""
        d = a - b
        n = d.shape[0]
        idx = torch.arange(n, device=d.device).reshape(n, 1)
        top = torch.where(d != 0, idx, -1).max(0).values
        return torch.where(top >= 0, d.gather(0, top.clamp(min=0)[None])[0].sign(),
                           torch.zeros_like(top))

    def canonical(self, a: F) -> torch.Tensor:
        """(NLIMBS, B) limbs of the fully reduced plain value, in [0, p)."""
        one = F(self._column(1, a.v.device).expand_as(a.v), 1, 1)
        y = self.mul(a, one)  # REDC(aR * 1): a, below a few p
        v = self._ripple(y.v)
        p = self._column(self.P_INT, v.device).expand_as(v)
        bound = y.val
        while bound >= self.P_INT:
            ge = (self.compare(v, p) >= 0).to(torch.int64)
            v = self._ripple(v - p * ge)
            bound -= self.P_INT
        return v

    def is_zero(self, a: F) -> torch.Tensor:
        return (self.canonical(a) == 0).all(0)

    def eq(self, a: F, b: F) -> torch.Tensor:
        return (self.canonical(a) == self.canonical(b)).all(0)
