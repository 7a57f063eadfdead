"""The port's generic prime field (``cometbft_tpu_torch/ops/fpgen.py``)
against the JAX package's (``cometbft_tpu/ops/fpgen.py``) and against
Python integers.

Each JAX field op is wrapped in ``jax.jit`` on its own: one op compiles in
about a second, where its eager dispatch compiles each of its few hundred
primitives apart (~6 s for a multiply on an x86 CPU).

The two layouts differ (16-bit int64 limbs with 32 bits of Montgomery
headroom here, 13-bit int32 limbs there), so the comparison is of field
elements: ``unpack`` of the same op on the same inputs gives the same
canonical ints, exactly.  Inputs come from a numpy seed and include 0,
1, p - 1 and values whose limbs sit at the edges of their bounds (long
lazy sums and subtractions, 2^k - 1 patterns).
"""

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import fp381 as jfp381
from cometbft_tpu.ops import secp_verify as jsv
from cometbft_tpu_torch.ops import fpgen
from cometbft_tpu_torch.ops import secp_verify as tsv

P = tsv.P
FP = tsv.FIELD
JFP = jsv.FIELD


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (1 << (p.bit_length() - 1)) - 1,
            int("ffff" * (p.bit_length() // 16), 16) % p]
    rand = [int.from_bytes(rng.bytes(64), "big") % p for _ in range(n - len(edge))]
    return edge + rand


OPS = {
    "add": (lambda f, a, b: f.add(a, b), lambda x, y, p: (x + y) % p),
    "sub": (lambda f, a, b: f.sub(a, b), lambda x, y, p: (x - y) % p),
    "neg": (lambda f, a, b: f.neg(a), lambda x, y, p: -x % p),
    "mul_small": (lambda f, a, b: f.mul_small(a, 21), lambda x, y, p: 21 * x % p),
    "mul": (lambda f, a, b: f.mul(a, b), lambda x, y, p: x * y % p),
    "square": (lambda f, a, b: f.square(a), lambda x, y, p: x * x % p),
    "carry": (lambda f, a, b: f.carry(f.add(a, b)), lambda x, y, p: (x + y) % p),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_secp_field_op_matches_jax_and_ints(op):
    xs, ys = _values(P, 12, 1), _values(P, 12, 2)[::-1]
    fn, want = OPS[op]
    got = FP.unpack(fn(FP, FP.pack(xs), FP.pack(ys)))
    jgot = JFP.unpack(jax.jit(lambda a, b: fn(JFP, a, b))(JFP.pack(xs), JFP.pack(ys)))
    assert got == jgot == [want(x, y, P) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", sorted(OPS))
def test_field_is_generic_over_the_prime(op):
    """BLS12-381's 381-bit prime (the JAX package's ``fp381``), the next
    slice's field: the same class, against Python integers."""
    p = jfp381.P_INT
    f = fpgen.Field(p)
    xs, ys = _values(p, 8, 3), _values(p, 8, 4)
    fn, want = OPS[op]
    assert f.unpack(fn(f, f.pack(xs), f.pack(ys))) == [want(x, y, p) for x, y in zip(xs, ys)]
    assert f.NLIMBS == 26 and f.R_INT >= p << 32


def test_lazy_chain_matches_ints_and_bounds_settle():
    """Products of sums and differences, fed back 300 times without a
    carry: limbs stay non-negative, the bounds settle (REDC contracts) and
    every value is right."""
    xs, ys = _values(P, 16, 5), _values(P, 16, 6)
    x, y = FP.pack(xs), FP.pack(ys)
    his, vals = [], []
    for _ in range(300):
        x = FP.sub(FP.mul(FP.add(x, y), FP.mul_small(FP.sub(y, x), 21)),
                   FP.add(FP.mul(x, x), y))
        y = FP.mul(x, FP.sub(y, FP.neg(FP.mul(x, x))))
        xs = [((a + b) * 21 * (b - a) - a * a - b) % P for a, b in zip(xs, ys)]
        ys = [a * (b + a * a) % P for a, b in zip(xs, ys)]
        assert int(x.v.min()) >= 0 and int(y.v.min()) >= 0
        his.append((x.hi, y.hi))
        vals.append((x.val, y.val))
    assert FP.unpack(x) == xs and FP.unpack(y) == ys
    assert his[-1] == his[-50] and vals[-1] == vals[-50]
    assert max(v for pair in vals for v in pair) < FP.R_INT >> 8


def test_canonical_bytes_compare_and_zero():
    vals = [0, 1, P - 1, P, P + 1, (1 << 256) - 1, 12345]
    be = torch.tensor([list(v.to_bytes(32, "big")) for v in vals], dtype=torch.uint8)
    f = FP.from_bytes_be(be)
    assert FP.unpack(f) == [v % P for v in vals]
    canon = FP.canonical(FP.add(f, FP.pack([P - 1] * len(vals))))  # lazy limbs
    want = [(v - 1) % P for v in vals]
    assert [FP.int_of_limbs(c) for c in canon.T.tolist()] == want
    assert FP.is_zero(FP.sub(f, FP.pack([v % P for v in vals]))).all()
    assert FP.eq(f, FP.pack([v % P for v in vals])).all()
    assert not FP.eq(f, FP.pack([(v + 1) % P for v in vals])).any()
    a = torch.tensor([FP.limbs_of_int(v) for v in (5, 1 << 200, 7)]).T
    b = torch.tensor([FP.limbs_of_int(v) for v in (6, 1 << 200, 3)]).T
    assert FP.compare(a, b).tolist() == [-1, 0, 1]


def test_pack_const_and_montgomery_helpers():
    xs = _values(P, 8, 7)
    f = FP.pack(xs)
    assert f.v.dtype == torch.int64 and tuple(f.v.shape) == (FP.NLIMBS, 8)
    for j, x in enumerate(xs):
        assert FP.int_of_limbs(f.v[:, j].tolist()) == FP.to_mont(x)
        assert FP.from_mont(FP.to_mont(x)) == x
    assert FP.unpack(FP.const(7, 3)) == [7, 7, 7]
    assert FP.NLIMBS == 18 and FP.R_INT >= P << 32
