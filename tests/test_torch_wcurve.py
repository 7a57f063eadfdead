"""The port's short-Weierstrass curve layer (``cometbft_tpu_torch/ops/
wcurve.py``) against the JAX package's (``cometbft_tpu/ops/wcurve.py``) and
against affine arithmetic in Python integers.

``add`` and ``double`` are the JAX module's field operations, so their
projective outputs are the same field elements on both sides, not only
the same point; the JAX pair is traced and compiled once for the module
(about 10-15 s on an x86 CPU, most of it tracing).  The ladder is held against
the JAX module's affine ``_pt_mul``/``_pt_add`` at full 256-bit scalars.
"""

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.ops import secp_verify as jsv
from cometbft_tpu.ops import wcurve as jwc
from cometbft_tpu_torch.ops import secp_verify as tsv

from test_torch_cuda_secp import affine, pack_points

FP, CV = tsv.FIELD, tsv.CURVE
G = (tsv.GX, tsv.GY)


def _neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % tsv.P)


def _points(seed):
    """Eight (P, Q) lane pairs: random multiples of G, P = Q (a doubling
    inside the addition), Q = -P (the sum is O), and the identity on
    either side and both."""
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "big") % tsv.N for _ in range(6)]
    a = [jsecp._pt_mul(k, jsecp._G) for k in ks]
    ps = [a[0], a[1], a[2], a[3], None, a[4], None, G]
    qs = [a[5], a[1], _neg(a[2]), None, a[4], a[0], None, G]
    return ps, qs


def _coords(field, pt) -> list:
    return [field.unpack(c) for c in (pt.x, pt.y, pt.z)]


@pytest.fixture(scope="module")
def pairs():
    ps, qs = _points(11)
    jp, jq = jsv.CURVE.pack_points(ps), jsv.CURVE.pack_points(qs)
    jadd, jdbl = jax.jit(lambda p, q: (jsv.CURVE.add(p, q), jsv.CURVE.double(p)))(jp, jq)
    tp, tq = pack_points(ps), pack_points(qs)
    return {
        "add": (_coords(FP, CV.add(tp, tq)), _coords(jsv.FIELD, jadd),
                [jsecp._pt_add(p, q) for p, q in zip(ps, qs)]),
        "double": (_coords(FP, CV.double(tp)), _coords(jsv.FIELD, jdbl),
                   [jsecp._pt_add(p, p) for p in ps]),
    }


@pytest.mark.parametrize("op", ["add", "double"])
def test_complete_formulas_match_jax_coordinates(pairs, op):
    port, jax_, affine = pairs[op]
    assert port == jax_  # X, Y, Z: the same field elements
    xs, ys, zs = port
    for x, y, z, want in zip(xs, ys, zs, affine):
        if want is None:
            assert z == 0
        else:
            zi = pow(z, -1, tsv.P)
            assert (x * zi % tsv.P, y * zi % tsv.P) == want


def _bits(scalars) -> torch.Tensor:
    """(256, B) bit rows, MSB first, of the scalars (``scalar_bits``)."""
    return tsv.scalar_bits(torch.tensor([list(k.to_bytes(32, "big")) for k in scalars],
                                        dtype=torch.uint8))


def test_double_scalar_mul_matches_affine_oracle():
    """u1*G + u2*Q in one Straus/Shamir ladder at full 256-bit scalars,
    including zero scalars, Q = G (G + Q a doubling) and Q = -G (G + Q =
    O)."""
    rng = np.random.default_rng(12)
    rand = lambda: int.from_bytes(rng.bytes(32), "big") % tsv.N
    qs = [jsecp._pt_mul(rand(), jsecp._G) for _ in range(4)] + [G, _neg(G), G, G]
    u1 = [rand(), 0, rand(), 0, rand(), rand(), tsv.N - 1, (1 << 255) + 1]
    u2 = [rand(), rand(), 0, 0, rand(), rand(), rand(), (1 << 255) - 1]
    got = CV.double_scalar_mul(pack_points([G] * len(qs)), pack_points(qs),
                               _bits(u1), _bits(u2))
    want = [jsecp._pt_add(jsecp._pt_mul(a, jsecp._G), jsecp._pt_mul(c, q))
            for a, c, q in zip(u1, u2, qs)]
    assert affine(got) == want


def test_select_identity_and_bits_match_jax():
    ps, _ = _points(13)
    tp, jp = pack_points(ps), jsv.CURVE.pack_points(ps)
    assert _coords(FP, tp) == _coords(jsv.FIELD, jp)
    ident = CV.identity(len(ps))
    assert _coords(FP, ident) == _coords(jsv.FIELD, jsv.CURVE.identity(len(ps)))
    bit = torch.tensor([1, 0] * 4)
    assert affine(CV.select(bit, tp, ident)) == [
        p if k % 2 == 0 else None for k, p in enumerate(ps)]
    scalars = [0, 1, tsv.N - 1, 12345, (1 << 255) + 7]
    np.testing.assert_array_equal(_bits(scalars).numpy(),
                                  jwc.pack_scalar_bits(scalars, 256, 5))


def test_mul_many_equals_separate_products():
    rng = np.random.default_rng(14)
    vals = [[int.from_bytes(rng.bytes(32), "big") % tsv.P for _ in range(4)]
            for _ in range(6)]
    fs = [FP.pack(v) for v in vals]
    got = FP.mul_many([(fs[0], fs[1]), (fs[2], fs[3]), (fs[4], fs[5])])
    for k, g in enumerate(got):
        assert FP.unpack(g) == FP.unpack(FP.mul(fs[2 * k], fs[2 * k + 1])) == [
            a * b % tsv.P for a, b in zip(vals[2 * k], vals[2 * k + 1])]


def test_lane_sum_equals_the_oracle():
    """``Curve.lane_sum`` (the JAX pairwise fold) at 8 lanes: a point and
    its negation, a doubling and the identity among them; at 1 lane the
    point itself."""
    ps, qs = _points(15)
    pts = ps[:4] + [_neg(ps[0]), ps[1], None, qs[0]]
    want = None
    for pt in pts:
        want = jsecp._pt_add(want, pt)
    assert affine(CV.lane_sum(pack_points(pts))) == [want]
    assert affine(CV.lane_sum(pack_points(pts[:1]))) == pts[:1]
    with pytest.raises(AssertionError):
        CV.lane_sum(pack_points(pts[:3]))
