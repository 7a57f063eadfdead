"""BLS12-381's base field: ``ops.fpgen.Field`` bound to P381.

The port's counterpart of ``cometbft_tpu/ops/fp381.py``, its ``F2`` ops
(Fp2 = Fp[u]/(u^2 + 1)) included.  The limb
machine, the lazy bounds and Montgomery REDC live in ``ops.fpgen``:
26 x 16-bit limbs, R = 2^416 (the JAX module keeps 30 x 13-bit limbs and
R = 2^390).  Canonical values, which ``unpack`` and ``canonical`` give,
do not depend on the radix, so the two modules' results compare as ints.
"""

from __future__ import annotations

from typing import NamedTuple

from cometbft_tpu_torch.ops.fpgen import F, Field

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

FIELD = Field(P_INT)

NLIMBS = FIELD.NLIMBS
R_INT = FIELD.R_INT

pack = FIELD.pack
unpack = FIELD.unpack
add = FIELD.add
sub = FIELD.sub
neg = FIELD.neg
mul_small = FIELD.mul_small
mul = FIELD.mul
square = FIELD.square


# -- Fp2 = Fp[u]/(u^2 + 1): elements are (c0, c1) pairs of F batches ---------


class F2(NamedTuple):
    c0: F
    c1: F


def f2_pack(vals, device=None) -> F2:
    """Host: (a, b) canonical int pairs -> an F2 batch."""
    return F2(pack([v[0] for v in vals], device), pack([v[1] for v in vals], device))


def f2_unpack(x: F2) -> list:
    return list(zip(unpack(x.c0), unpack(x.c1)))


def f2_add(x: F2, y: F2) -> F2:
    return F2(add(x.c0, y.c0), add(x.c1, y.c1))


def f2_sub(x: F2, y: F2) -> F2:
    return F2(sub(x.c0, y.c0), sub(x.c1, y.c1))


def f2_neg(x: F2) -> F2:
    return F2(neg(x.c0), neg(x.c1))


def f2_mul(x: F2, y: F2) -> F2:
    """Karatsuba, 3 multiplies: (a + bu)(c + du) = (ac - bd) + ((a + b)(c +
    d) - ac - bd) u."""
    ac, bd, cross = FIELD.mul_many([(x.c0, y.c0), (x.c1, y.c1),
                                    (add(x.c0, x.c1), add(y.c0, y.c1))])
    return F2(sub(ac, bd), sub(sub(cross, ac), bd))


def f2_square(x: F2) -> F2:
    """(a + bu)^2 = (a + b)(a - b) + 2ab u, 2 multiplies."""
    t, ab = FIELD.mul_many([(add(x.c0, x.c1), sub(x.c0, x.c1)), (x.c0, x.c1)])
    return F2(t, mul_small(ab, 2))


def f2_mul_small(x: F2, k: int) -> F2:
    return F2(mul_small(x.c0, k), mul_small(x.c1, k))
