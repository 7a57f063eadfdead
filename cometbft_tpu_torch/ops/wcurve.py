"""Batched short-Weierstrass (a = 0) curve arithmetic over an
``ops.fpgen.Field``, in plain PyTorch: the curve layer of secp256k1
(b = 7, ``ops.secp_verify``) and BLS12-381 G1 (b = 4, ``ops.bls_g1``).

The port's counterpart of ``cometbft_tpu/ops/wcurve.py``.  Points are
projective (X : Y : Z) batches, one point per lane, with the complete
addition formulas of Renes-Costello-Batina 2015 (algorithm 7 for a = 0):
one branch-free formula for every input pair, doubling and the identity
(0 : 1 : 0) included.  ``add``, ``double`` and ``_tail`` are the JAX
module's field operations, op for op, so a ladder's (X, Y, Z) are the same
field elements there and here, not only the same point; the independent
products of each stage go through one ``Field.mul_many`` call (three for an
addition or a doubling, where the JAX module makes twelve calls).

The JAX module clamps loop-carried coordinates to fixed static bounds
(``fix_point``) because ``fori_loop`` needs one signature per iteration;
a Python loop needs none, and ``ops.fpgen``'s bounds settle by themselves
(REDC contracts), so nothing is clamped here.  ``scalar_mul`` is the JAX
single-scalar ladder (the plain version of the BLS G1 kernel; its host
side packs raw bytes, ``ops.bls_g1``), and ``lane_sum`` the JAX pairwise
fold of the lane axis (``ops.bls_g1.msm``/``sum_points``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cometbft_tpu_torch.ops.fpgen import F, Field, select


class Point(NamedTuple):
    x: F
    y: F
    z: F


class Curve:
    """All point ops bound to one (field, b3 = 3 * b) configuration."""

    def __init__(self, field: Field, b3: int):
        self.fp = field
        self.B3 = b3

    def add(self, p: Point, q: Point) -> Point:
        """Complete projective addition (RCB15 alg. 7, a = 0)."""
        fp = self.fp
        x1, y1, z1 = p.x, p.y, p.z
        x2, y2, z2 = q.x, q.y, q.z
        t0, t1, t2 = fp.mul_many([(x1, x2), (y1, y2), (z1, z2)])
        t3, t4, xz = fp.mul_many([
            (fp.add(x1, y1), fp.add(x2, y2)),
            (fp.add(y1, z1), fp.add(y2, z2)),
            (fp.add(x1, z1), fp.add(x2, z2)),
        ])
        t3 = fp.sub(t3, fp.add(t0, t1))  # X1Y2 + X2Y1
        t4 = fp.sub(t4, fp.add(t1, t2))  # Y1Z2 + Y2Z1
        xz = fp.sub(xz, fp.add(t0, t2))  # X1Z2 + X2Z1
        return self._tail(t0, t1, t2, t3, t4, xz)

    def double(self, p: Point) -> Point:
        """The same complete formula with squarings where operands
        coincide."""
        fp = self.fp
        x1, y1, z1 = p.x, p.y, p.z
        t0, t1, t2 = fp.mul_many([(x1, x1), (y1, y1), (z1, z1)])
        s1, s2, s3 = fp.add(x1, y1), fp.add(y1, z1), fp.add(x1, z1)
        t3, t4, xz = fp.mul_many([(s1, s1), (s2, s2), (s3, s3)])
        t3 = fp.sub(t3, fp.add(t0, t1))  # 2XY
        t4 = fp.sub(t4, fp.add(t1, t2))  # 2YZ
        xz = fp.sub(xz, fp.add(t0, t2))  # 2XZ
        return self._tail(t0, t1, t2, t3, t4, xz)

    def _tail(self, t0, t1, t2, t3, t4, xz) -> Point:
        """Shared tail of the complete a = 0 formula."""
        fp = self.fp
        s0 = fp.add(fp.add(t0, t0), t0)  # 3 * X1X2
        t2 = fp.mul_small(t2, self.B3)
        z3 = fp.add(t1, t2)
        t1 = fp.sub(t1, t2)
        y3 = fp.mul_small(xz, self.B3)
        a, b, c, d, e, f = fp.mul_many(
            [(t3, t1), (t4, y3), (t1, z3), (y3, s0), (z3, t4), (s0, t3)])
        return Point(fp.sub(a, b), fp.add(c, d), fp.add(e, f))

    def identity(self, batch: int, device=None) -> Point:
        """(0 : 1 : 0), exact limbs."""
        fp = self.fp
        return Point(
            fp.const(0, batch, device), fp.const(1, batch, device),
            fp.const(0, batch, device),
        )

    def select(self, bit: torch.Tensor, a: Point, b: Point) -> Point:
        """Per lane (``bit``: (B,) int or bool): a where bit, else b."""
        return Point(select(bit, a.x, b.x), select(bit, a.y, b.y),
                     select(bit, a.z, b.z))

    def double_scalar_mul(
        self, p: Point, q: Point, pbits: torch.Tensor, qbits: torch.Tensor
    ) -> Point:
        """Per-lane u*P + v*Q in one Straus/Shamir ladder: at each bit,
        MSB first, the addend is picked among {O, P, Q, P+Q} and the add
        always runs (the complete formula absorbs O)."""
        assert pbits.shape == qbits.shape
        pq = self.add(p, q)
        acc = self.identity(pbits.shape[1], pbits.device)
        ident = acc
        for i in range(pbits.shape[0]):
            acc = self.double(acc)
            pb, qb = pbits[i], qbits[i]
            addend = self.select(pb & qb, pq, ident)
            addend = self.select(pb & (1 - qb), p, addend)
            addend = self.select((1 - pb) & qb, q, addend)
            acc = self.add(acc, addend)
        return acc

    def scalar_mul(self, base: Point, bits: torch.Tensor) -> Point:
        """Per-lane double-and-add, MSB first.  ``bits``: (nbits, B) int
        rows of 0/1.  Branch-free: the add always runs and the bit
        selects (the JAX ``scalar_mul``, op for op)."""
        acc = self.identity(bits.shape[1], bits.device)
        for i in range(bits.shape[0]):
            acc = self.double(acc)
            acc = self.select(bits[i], self.add(acc, base), acc)
        return acc

    def lane_sum(self, p: Point) -> Point:
        """Fold the lane axis down to one point by pairwise complete
        additions: log2(B) additions over halving widths, the JAX
        ``lane_sum``.  B must be a power of two (the caller pads with the
        identity)."""
        width = p.x.v.shape[1]
        assert width and width & (width - 1) == 0, "lane_sum needs a power-of-two batch"
        while width > 1:
            half = width // 2
            lo = Point(*(F(f.v[:, :half], f.hi, f.val) for f in p))
            hi = Point(*(F(f.v[:, half:], f.hi, f.val) for f in p))
            p = self.add(lo, hi)
            width = half
        return p
