"""Batched GF(2^255-19) field arithmetic in plain PyTorch.

The plain version beside the CUDA kernel (``ops.cuda_verify``): the CPU
tests run it, and ``chip_smoke.py`` holds the kernel against it on the
card.  It keeps the JAX package's layout so the two compare limb for limb:
a batch of field elements is an int32 tensor of shape ``(20, B)`` — 20
little-endian limbs of 13 bits each, batch on the last axis.  Limbs are
SIGNED and lazily reduced: a "reduced" element has limbs in [-4704, 4703]
(the fixpoint of the rounding-shift carry below); sums and differences of
reduced elements are valid unreduced elements and feed the multiplier
directly — no carry after add/sub.

Every element carries *static* per-limb bounds (python ints) threaded
through all ops.  ``mul``/``square`` check the bound product against int32
overflow before computing and insert the minimal number of parallel carry
steps, so the overflow discipline is machine-checked.  torch int32 wraps
and ``>>`` is arithmetic, as in ``jnp``, so the same bounds hold.

Reference behavior being re-derived: the field layer that curve25519-voi
supplies to the reference's batch verifier (crypto/ed25519/ed25519.go:
189-222).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

NLIMBS = 20
BITS = 13
BASE = 1 << BITS  # 8192
HALF = BASE // 2  # rounding offset for the centered carry
MASK = BASE - 1
P_INT = 2**255 - 19
# carry out of limb 19 has weight 2^260 = 2^5 * 2^255 ≡ 32*19 (mod p)
FOLD = 19 * 32  # 608

# Reduced-limb bounds: fixpoint of one carry round (see _sim_carry_rounds).
RED_LO, RED_HI = -(HALF + FOLD), HALF - 1 + FOLD
# int32 budget for a 20-term column of products, with headroom for the
# rounding offset added during carries.
_I32_LIMIT = 2**31 - 1 - HALF


class F(NamedTuple):
    """A batch of field elements: (20, B) int32 limbs + static bounds."""

    v: torch.Tensor
    lo: int
    hi: int

    @property
    def absmax(self) -> int:
        return max(abs(self.lo), abs(self.hi))


# ---------------------------------------------------------------------------
# Host helpers (numpy / python ints) — used by tests and constant baking.
# ---------------------------------------------------------------------------

def limbs_of_int(n: int) -> np.ndarray:
    """Python int in [0, 2^260) -> (20,) int32 nonneg limb vector."""
    out = np.zeros(NLIMBS, np.int64)
    for i in range(NLIMBS):
        out[i] = n & MASK
        n >>= BITS
    if n:
        raise ValueError("value does not fit in 20x13 bits")
    return out.astype(np.int32)


def int_of_limbs(x) -> int:
    """(20,) limbs (any signedness) -> python int (not reduced mod p)."""
    n = 0
    for i in reversed(range(NLIMBS)):
        n = (n << BITS) + int(x[i])
    return n


@lru_cache(maxsize=64)
def _column(limbs: tuple, device: torch.device) -> torch.Tensor:
    """(len(limbs), 1) int32 constant column, broadcast over the batch."""
    return torch.tensor(limbs, dtype=torch.int32, device=device).view(-1, 1)


def const(n: int, device="cpu") -> F:
    """A field constant of width 1, broadcastable over the batch."""
    limbs = tuple(int(x) for x in limbs_of_int(n % P_INT))
    return F(_column(limbs, torch.device(device)), 0, MASK)


# ---------------------------------------------------------------------------
# Carry machinery: static interval analysis drives the emitted step count.
# ---------------------------------------------------------------------------

def _sim_carry_rounds(bounds: list) -> tuple[int, list]:
    """Exact per-limb interval simulation of repeated ``_carry_once``.

    ``bounds``: 20 (lo, hi) pairs.  Returns (#rounds, final per-limb
    bounds), stopping when every limb is inside the RED hull.  Only limb 0
    receives the x608 wrap fold, so the big post-multiply bound rotates
    upward one limb per round and shrinks by >>13."""
    rounds = 0
    while min(l for l, _ in bounds) < RED_LO or max(h for _, h in bounds) > RED_HI:
        c = [((l + HALF) >> BITS, (h + HALF) >> BITS) for l, h in bounds]
        bounds = [
            (
                -HALF + (FOLD * c[-1][0] if i == 0 else c[i - 1][0]),
                HALF - 1 + (FOLD * c[-1][1] if i == 0 else c[i - 1][1]),
            )
            for i in range(NLIMBS)
        ]
        rounds += 1
        if rounds > 8:
            raise AssertionError("carry interval analysis diverged")
    return rounds, bounds


def _carry_once(v: torch.Tensor) -> torch.Tensor:
    """One parallel carry round over (20, B): centered remainders, carries
    move up one limb, the top carry folds into limb 0 with weight 608."""
    c = (v + HALF) >> BITS  # arithmetic shift: floor((x + 4096)/8192)
    r = v - (c << BITS)  # in [-4096, 4095]
    carry_in = torch.cat([FOLD * c[-1:], c[:-1]], dim=0)
    return r + carry_in


@lru_cache(maxsize=None)
def _carry_plan(lo: int, hi: int) -> tuple[int, int, int]:
    """(rounds, lo, hi) of ``carry`` on limbs in [lo, hi]: the static
    analysis depends on the bounds alone, so it runs once per pair."""
    rounds, bounds = _sim_carry_rounds([(lo, hi)] * NLIMBS)
    return rounds, min(l for l, _ in bounds), max(h for _, h in bounds)


def carry(a: F) -> F:
    """Reduce to the RED fixpoint; runs exactly as many parallel rounds as
    the static bounds require (0 if already reduced)."""
    rounds, lo, hi = _carry_plan(a.lo, a.hi)
    v = a.v
    for _ in range(rounds):
        v = _carry_once(v)
    return F(v, lo, hi)


def red(a: F) -> F:
    """Carry, then *widen* the static bounds to the exact RED hull, so loop
    bodies see one fixed bound signature."""
    c = carry(a)
    return F(c.v, RED_LO, RED_HI)


# ---------------------------------------------------------------------------
# Ring ops.  add/sub are carry-free; mul/square auto-reduce their inputs.
# ---------------------------------------------------------------------------

def _check_i32(lo: int, hi: int, what: str) -> None:
    if not (-(2**31) < lo and hi < 2**31):
        raise AssertionError(f"{what} overflow (carry an operand)")


def add(a: F, b: F) -> F:
    lo, hi = a.lo + b.lo, a.hi + b.hi
    _check_i32(lo, hi, "add")
    return F(a.v + b.v, lo, hi)


def sub(a: F, b: F) -> F:
    lo, hi = a.lo - b.hi, a.hi - b.lo
    _check_i32(lo, hi, "sub")
    return F(a.v - b.v, lo, hi)


def neg(a: F) -> F:
    return F(-a.v, -a.hi, -a.lo)


def mul_small(a: F, k: int) -> F:
    """Multiply by a small static nonneg integer (e.g. 2)."""
    lo, hi = min(a.lo * k, a.hi * k), max(a.lo * k, a.hi * k)
    _check_i32(lo, hi, "mul_small")
    return F(a.v * k, lo, hi)


@lru_cache(maxsize=None)
def _reduce_plan(prodmax: int) -> tuple[int, int, int, int]:
    """The static interval analysis of ``_reduce_cols``, which depends on
    ``prodmax`` alone: (stage-A steps, stage-C rounds, lo, hi).

    All three stages run on exact per-column interval vectors: column k of
    a 20x20 schoolbook product has min(k+1, 39-k) terms.  Limb 39 (the zero
    pad) receives carries from limb 38 but never emits one (a carry out of
    it would have weight 2^520); it accumulates with its own interval and
    stage B folds it like the rest.
    """
    b = [
        (-min(k + 1, 39 - k) * prodmax, min(k + 1, 39 - k) * prodmax)
        for k in range(39)
    ] + [(0, 0)]
    # stage A (fold-free carry; limb 39 accumulates, never emits)
    steps = 0
    while (
        min(l for l, _ in b[:-1]) < -HALF - 1
        or max(h for _, h in b[:-1]) > HALF + 1
    ):
        c = [((l + HALF) >> BITS, (h + HALF) >> BITS) for l, h in b[:-1]]
        b = (
            [(-HALF, HALF - 1)]
            + [
                (-HALF + c[i - 1][0], HALF - 1 + c[i - 1][1])
                for i in range(1, 39)
            ]
            + [(b[39][0] + c[38][0], b[39][1] + c[38][1])]
        )
        steps += 1
        if steps > 6:
            raise AssertionError("column carry analysis diverged")
    vb = []
    for i in range(NLIMBS):
        l = b[i][0] + FOLD * b[NLIMBS + i][0]
        h = b[i][1] + FOLD * b[NLIMBS + i][1]
        _check_i32(l, h, "stage-B fold")
        vb.append((l, h))
    rounds, vb = _sim_carry_rounds(vb)
    return steps, rounds, min(l for l, _ in vb), max(h for _, h in vb)


def _reduce_cols(x: torch.Tensor, prodmax: int) -> F:
    """(40, B) product columns (39 + zero pad) -> reduced F.  ``prodmax``
    is a static bound on one limb product |a_i * b_j|.

    Stage A: parallel-carry the column array as a plain 40-limb number
    (no fold) until limbs are small; stage B: fold the high 20 limbs into
    the low 20 with weight 2^260 ≡ 608; stage C: carry to RED.  The step
    counts and the bounds come from ``_reduce_plan``."""
    steps, rounds, lo, hi = _reduce_plan(prodmax)
    for _ in range(steps):
        c = (x + HALF) >> BITS
        # zero limb 39's carry: it must accumulate, not emit (_reduce_plan)
        c = torch.cat([c[:-1], torch.zeros_like(c[-1:])], dim=0)
        r = x - (c << BITS)
        x = r + torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)
    # stage B: value = lo20 + 2^260 * hi20
    lo20, hi20 = x[:NLIMBS], x[NLIMBS:]
    v = lo20 + FOLD * hi20
    # stage C: carry to RED, per-limb
    for _ in range(rounds):
        v = _carry_once(v)
    return F(v, lo, hi)


def _cols(a: F, b: F) -> torch.Tensor:
    """(40, B) product columns via skew-reshape: pad each row i of the
    (20, 20, B) outer product to width 40, flatten the leading two axes
    and re-view as (20, 39, B) — element (i, j) lands at (i, j - i), so a
    single axis-0 sum produces the 39 polynomial columns."""
    n = NLIMBS
    prod = a.v[:, None, :] * b.v[None, :, :]  # (20, 20, B)
    B = prod.shape[2]
    z = torch.cat([prod, prod.new_zeros((n, n, B))], dim=1)  # (20, 40, B)
    skew = z.reshape(2 * n * n, B)[: n * (2 * n - 1)].reshape(n, 2 * n - 1, B)
    cols = skew.sum(dim=0, dtype=torch.int32)  # (39, B)
    return torch.cat([cols, cols.new_zeros((1, B))], dim=0)


def mul(a: F, b: F) -> F:
    """Schoolbook 20x20 product."""
    if a is b:
        return square(a)
    # auto-reduce operands until the 20-term column bound fits int32
    while NLIMBS * a.absmax * b.absmax >= _I32_LIMIT:
        a, b = (carry(a), b) if a.absmax >= b.absmax else (a, carry(b))
    return _reduce_cols(_cols(a, b), a.absmax * b.absmax)


def square(a: F) -> F:
    """a^2: the columns of ``mul`` with both operands ``a`` (a handful of
    tensor ops; a half-triangle loop of 20 steps issues ten times as
    many, which is what a plain version's time goes to)."""
    while NLIMBS * a.absmax * a.absmax >= _I32_LIMIT:
        a = carry(a)
    return _reduce_cols(_cols(a, a), a.absmax * a.absmax)


# ---------------------------------------------------------------------------
# Canonicalization & predicates.
# ---------------------------------------------------------------------------

def _nonneg_pad(lo: int) -> tuple[np.ndarray, int]:
    """A limb vector representing K*p whose every limb is >= -lo (so adding
    it makes any value with limbs >= lo nonneg, without changing the class
    mod p).  Returns (limbs, max_limb)."""
    need = max(-lo, 0) + 1
    base = 1 << max(need - 1, 1).bit_length()  # power of two >= need
    v0 = base * ((1 << (BITS * NLIMBS)) - 1) // (BASE - 1)
    k = -(-v0 // P_INT) + 1  # ceil + 1
    delta = k * P_INT - v0
    dl = np.zeros(NLIMBS, np.int64)
    for i in range(NLIMBS):
        dl[i] = delta & MASK
        delta >>= BITS
    if delta:
        raise AssertionError("pad construction overflow")
    limbs = dl + base
    return limbs.astype(np.int64), int(limbs.max())


def _ripple(v: torch.Tensor):
    """Exact sequential carry pass.  Input limbs must be nonneg; outputs
    limbs in [0, 2^13) plus the final carry out of limb 19 (weight 2^260,
    shape (1, B))."""
    rows = []
    cin = torch.zeros_like(v[:1])
    for i in range(NLIMBS):
        t = v[i : i + 1] + cin
        cin = t >> BITS
        rows.append(t & MASK)
    return torch.cat(rows, dim=0), cin


def freeze(a: F) -> torch.Tensor:
    """Canonical representative in [0, p) as plain (20, B) int32 nonneg
    limbs.  Used for equality and the decompression sign."""
    a = carry(a)
    pad, pad_max = _nonneg_pad(a.lo)
    v = a.v + _column(tuple(int(x) for x in pad), a.v.device)
    hi = a.hi + pad_max
    # parallel floor-carries down to the fixpoint (limbs <= MASK + FOLD)
    steps = 0
    while hi > MASK + FOLD:
        hi = MASK + max(hi >> BITS, FOLD * (hi >> BITS))
        steps += 1
    for _ in range(steps):
        c = v >> BITS
        v = (v & MASK) + torch.cat([FOLD * c[-1:], c[:-1]], dim=0)
    # exact ripple; fold carry-out (2^260 ≡ 608) and top bits 255..259
    # (2^255 ≡ 19); after two rounds the value is < p + small, then at most
    # two conditional subtracts of p give the canonical representative.
    topshift = 255 - BITS * (NLIMBS - 1)  # limb 19 holds bits 247..259
    p_limbs = limbs_of_int(P_INT)
    for _ in range(2):
        v, cout = _ripple(v)
        hi_bits = v[NLIMBS - 1 :] >> topshift  # (1, B)
        v = torch.cat(
            [
                v[:1] + 19 * hi_bits + FOLD * cout,
                v[1 : NLIMBS - 1],
                v[NLIMBS - 1 :] - (hi_bits << topshift),
            ],
            dim=0,
        )
    v, _ = _ripple(v)
    for _ in range(2):
        # borrow-propagating subtract; keep v - p when nonnegative
        rows = []
        cin = torch.zeros_like(v[:1])
        for i in range(NLIMBS):
            t = v[i : i + 1] - int(p_limbs[i]) + cin
            cin = t >> BITS
            rows.append(t - (cin << BITS))
        dv = torch.cat(rows, dim=0)
        geq = cin == 0  # (1, B): no final borrow => v >= p
        v = torch.where(geq, dv, v)
    return v


def eq(a: F, b: F) -> torch.Tensor:
    """(B,) bool: a == b mod p."""
    return torch.all(freeze(sub(a, b)) == 0, dim=0)


def is_zero(a: F) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=0)


def select(cond: torch.Tensor, a: F, b: F) -> F:
    """Per-lane select: cond (B,) bool -> a else b."""
    return F(
        torch.where(cond[None, :], a.v, b.v), min(a.lo, b.lo), max(a.hi, b.hi)
    )


# ---------------------------------------------------------------------------
# Exponentiation: the 2^252-3 chain (decompression square root).
# ---------------------------------------------------------------------------

def _nsquares(x: F, n: int) -> F:
    """x^(2^n) by n squarings, bounds widened to RED each step."""
    x = red(x)
    for _ in range(n):
        x = red(square(x))
    return x


def pow_p58(z: F) -> F:
    """z^((p-5)/8) = z^(2^252 - 3) with the standard 11-mul addition chain
    (the reference gets this from curve25519-voi's field inversion chains)."""
    z2 = square(z)  # 2
    z4 = square(z2)
    z8 = square(z4)
    z9 = mul(z8, z)  # 9
    z11 = mul(z9, z2)  # 11
    z22 = square(z11)  # 22
    z_5_0 = mul(z22, z9)  # 2^5 - 2^0 = 31
    z_10_5 = _nsquares(z_5_0, 5)
    z_10_0 = mul(z_10_5, z_5_0)  # 2^10 - 1
    z_20_10 = _nsquares(z_10_0, 10)
    z_20_0 = mul(z_20_10, z_10_0)  # 2^20 - 1
    z_40_20 = _nsquares(z_20_0, 20)
    z_40_0 = mul(z_40_20, z_20_0)  # 2^40 - 1
    z_50_40 = _nsquares(z_40_0, 10)
    z_50_0 = mul(z_50_40, z_10_0)  # 2^50 - 1
    z_100_50 = _nsquares(z_50_0, 50)
    z_100_0 = mul(z_100_50, z_50_0)  # 2^100 - 1
    z_200_100 = _nsquares(z_100_0, 100)
    z_200_0 = mul(z_200_100, z_100_0)  # 2^200 - 1
    z_250_200 = _nsquares(z_200_0, 50)
    z_250_0 = mul(z_250_200, z_50_0)  # 2^250 - 1
    z_252_2 = _nsquares(z_250_0, 2)  # 2^252 - 4
    return mul(z_252_2, z)  # 2^252 - 3


SQRT_M1_INT = pow(2, (P_INT - 1) // 4, P_INT)


def sqrt_ratio(u: F, v: F):
    """(ok, x) with x = sqrt(u/v) when it exists (parity not normalized
    here).  ZIP-215 semantics: ok false iff u/v is a non-square."""
    v3 = mul(square(v), v)
    v7 = mul(square(v3), v)
    r = pow_p58(mul(u, v7))
    x = mul(mul(u, v3), r)
    vx2 = mul(v, square(x))
    ok1 = eq(vx2, u)
    ok2 = eq(vx2, neg(u))
    x = select(ok2, mul(x, const(SQRT_M1_INT, x.v.device)), x)
    return ok1 | ok2, x


# ---------------------------------------------------------------------------
# Byte unpacking (the wire format is bytes; limb packing on the device keeps
# the host->device transfer at 32 B per element).
# ---------------------------------------------------------------------------

def unpack255(b: torch.Tensor):
    """(B, 32) uint8 little-endian -> (F of the low 255 bits, sign bits).

    Returns (y: F with nonneg 13-bit limbs, sign: (B,) int32 from bit 255).
    """
    x = b.to(torch.int32)  # (B, 32)
    rows = []
    for i in range(NLIMBS):
        bit0 = BITS * i
        k = bit0 >> 3
        off = bit0 & 7
        w = x[:, k]
        if k + 1 < 32:
            w = w | (x[:, k + 1] << 8)
        if off + BITS > 16 and k + 2 < 32:
            w = w | (x[:, k + 2] << 16)
        limb = (w >> off) & MASK
        if i == NLIMBS - 1:
            limb = limb & 0xFF  # bits 247..254 only (strip sign bit 255)
        rows.append(limb)
    y = torch.stack(rows)  # (20, B)
    sign = (x[:, 31] >> 7) & 1
    return F(y, 0, MASK), sign


def signed_digits_msb_first(b: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 little-endian scalar -> (64, B) int32 SIGNED radix-16
    digits in [-8, 7], most-significant first.

    Recoding d'_k = d_k + c_in - 16*c_out (carry when the digit would
    exceed 7) keeps the value identical while the per-lane table shrinks to
    {0..8}*A — negation is a sign flip on X and T.  Scalars here are < L <
    2^253 (mod-L reduced on the host), so the top nibble is <= 1 and the
    final carry is always absorbed."""
    x = b.to(torch.int32)
    digs = []
    c = torch.zeros_like(x[:, 0])
    for k in range(64):  # LSB-first recode, carry rippling upward
        d = ((x[:, k >> 1] >> (4 * (k & 1))) & 0xF) + c
        c = (d >= 8).to(torch.int32)
        digs.append(d - (c << 4))
    return torch.stack(digs[::-1])  # (64, B), row 0 = most significant


def mul_sign(a: F, sgn: torch.Tensor) -> F:
    """Multiply by a per-lane sign in {-1, +1} ((B,) int32)."""
    return F(a.v * sgn[None, :], min(a.lo, -a.hi), max(a.hi, -a.lo))
