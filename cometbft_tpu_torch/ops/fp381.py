"""BLS12-381's base field: ``ops.fpgen.Field`` bound to P381.

The port's counterpart of ``cometbft_tpu/ops/fp381.py`` (its ``F2`` ops
have no device caller in the JAX package and are not ported).  The limb
machine, the lazy bounds and Montgomery REDC live in ``ops.fpgen``:
26 x 16-bit limbs, R = 2^416 (the JAX module keeps 30 x 13-bit limbs and
R = 2^390).  Canonical values, which ``unpack`` and ``canonical`` give,
do not depend on the radix, so the two modules' results compare as ints.
"""

from __future__ import annotations

from cometbft_tpu_torch.ops.fpgen import Field

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
