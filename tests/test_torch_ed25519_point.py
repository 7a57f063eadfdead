"""The port's point layer (cometbft_tpu_torch.ops.ed25519_point) against the
JAX package's, called eagerly on the same seeded limbs, and its ladder
against the pure-Python oracle.  Exact comparisons throughout: integer
code, identical formulas and identical carry insertion.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cometbft_tpu.ops import ed25519_point as jep
from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import ed25519_point as tep
from cometbft_tpu_torch.ops import fe25519 as tfe

P = ref.P


def _points(n, salt=b"pt"):
    """n curve points: small-order points first, then seeded multiples of B."""
    pts = [ref.IDENTITY]
    for enc in ((P - 1).to_bytes(32, "little"), bytes(32)):  # orders 2 and 4
        pts.append(ref.pt_decompress_zip215(enc))
    i = 0
    while len(pts) < n:
        k = int.from_bytes(hashlib.sha512(salt + bytes([i])).digest(), "little")
        pts.append(ref.pt_mul(k % ref.L, ref.BASE))
        i += 1
    return pts[:n]


def _coords(pts):
    """(4, 20, n) int32 limbs of the X, Y, Z, T of each point (mod p)."""
    return np.stack(
        [
            np.stack([tfe.limbs_of_int(p[c] % P) for p in pts], axis=1)
            for c in range(4)
        ]
    )


def _pair(pts):
    arr = _coords(pts)
    t = tep.PointBatch(*(tfe.F(torch.from_numpy(arr[c].copy()), 0, tfe.MASK) for c in range(4)))
    j = jep.PointBatch(*(jfe.F(jnp.asarray(arr[c]), 0, jfe.MASK) for c in range(4)))
    return t, j


def _same(t, j):
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))
    assert (t.lo, t.hi) == (j.lo, j.hi)


def _affine(pb: tep.PointBatch, i: int):
    x, y, z = (tfe.int_of_limbs(tfe.freeze(c).numpy()[:, i]) for c in pb[:3])
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def _ref_affine(pt):
    zi = pow(pt[2], P - 2, P)
    return pt[0] * zi % P, pt[1] * zi % P


def test_niels_base_table_equals_jax():
    got = tep._niels_base_table()
    want = jep._niels_base_table()
    assert got.dtype == want.dtype and got.shape == want.shape == (60, 9)
    np.testing.assert_array_equal(got, want)


_OPS = ["double", "double_no_t", "add", "add_table", "madd_niels", "negate"]


@pytest.mark.parametrize("op", _OPS)
def test_point_op_matches_jax(op):
    p_pts, q_pts = _points(8, b"p"), _points(8, b"q")[::-1]
    tp, jp = _pair(p_pts)
    tq, jq = _pair(q_pts)
    if op == "double":
        got, want = tep.double(tp), jep.double(jp)
        expect = [ref.pt_double(p) for p in p_pts]
    elif op == "double_no_t":
        got, want = tep.double(tp, need_t=False), jep.double(jp, need_t=False)
        assert got.t is None  # never broadcast into later arithmetic
        for c in range(3):
            _same(got[c], want[c])
        for i, p in enumerate(p_pts):
            assert _affine(got, i) == _ref_affine(ref.pt_double(p))
        return
    elif op == "add":
        got, want = tep.add(tp, tq), jep.add(jp, jq)
        expect = [ref.pt_add(a, b) for a, b in zip(p_pts, q_pts)]
    elif op == "add_table":
        d2 = tfe.const(ref.D2)
        tt = tep.TablePoint(tq.x, tq.y, tq.z, tfe.mul(tq.t, d2))
        jt = jep.TablePoint(jq.x, jq.y, jq.z, jfe.mul(jq.t, jfe.const(ref.D2)))
        got, want = tep.add_table(tp, tt), jep.add_table(jp, jt)
        expect = [ref.pt_add(a, b) for a, b in zip(p_pts, q_pts)]
    elif op == "madd_niels":
        aff = [_ref_affine(q) for q in q_pts]
        rows = [
            np.stack([tfe.limbs_of_int(f(x, y) % P) for x, y in aff], axis=1)
            for f in (
                lambda x, y: y + x,
                lambda x, y: y - x,
                lambda x, y: 2 * ref.D * x * y,
            )
        ]
        tn = [tfe.F(torch.from_numpy(r.copy()), 0, tfe.MASK) for r in rows]
        jn = [jfe.F(jnp.asarray(r), 0, jfe.MASK) for r in rows]
        got, want = tep.madd_niels(tp, *tn), jep.madd_niels(jp, *jn)
        expect = [ref.pt_add(a, b) for a, b in zip(p_pts, q_pts)]
    else:
        got, want = tep.negate(tp), jep.negate(jp)
        expect = [ref.pt_neg(p) for p in p_pts]
    for c in range(4):
        _same(got[c], want[c])
    for i, e in enumerate(expect):
        assert _affine(got, i) == _ref_affine(e)


def _encodings():
    """Edge encodings for decompression: identity, non-canonical identity
    (P+1), '-0' (y=1 with the sign bit), order-2/4 points, y >= p, a
    non-square y, and seeded valid points with both signs."""
    encs = [
        (1).to_bytes(32, "little"),
        (P + 1).to_bytes(32, "little"),
        (1 | (1 << 255)).to_bytes(32, "little"),
        (P - 1).to_bytes(32, "little"),
        bytes(32),
        ((1 << 255) - 1).to_bytes(32, "little"),  # y = 2^255 - 1 >= p
        (2).to_bytes(32, "little"),  # x^2 non-square
    ]
    for p in _points(13, b"enc")[3:]:
        e = bytearray(ref.pt_compress(p))
        if len(encs) % 2:
            e[31] ^= 0x80
        encs.append(bytes(e))
    return encs[:16]


def test_decompress_matches_jax_and_oracle():
    encs = _encodings()
    b = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)
    ty, ts = tfe.unpack255(torch.from_numpy(b.copy()))
    jy, js = jfe.unpack255(jnp.asarray(b))
    tok, tpt = tep.decompress(ty, ts)
    jok, jpt = jax.jit(jep.decompress)(jy, js)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    for c in range(4):
        np.testing.assert_array_equal(
            tfe.freeze(tpt[c]).numpy(), np.asarray(jfe.freeze(jpt[c]))
        )
    for i, enc in enumerate(encs):
        want = ref.pt_decompress_zip215(enc)
        assert bool(tok[i]) == (want is not None)
        if want is not None:
            assert _affine(tpt, i) == _ref_affine(want)


def test_tables_match_jax():
    pts = _points(8, b"tbl")
    tp, jp = _pair(pts)
    ttab, jtab = tep.build_table_a(tp), jep.build_table_a(jp)
    for tc, jc in zip(ttab, jtab):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    digits = np.array([-8, -5, -1, 0, 1, 4, 7, 8], np.int32)
    tsel = tep.select_table_a(ttab, torch.from_numpy(digits))
    jsel = jep.select_table_a(jtab, jnp.asarray(digits))
    for c in range(4):
        _same(tsel[c], jsel[c])
    tb = tep.select_base(torch.from_numpy(digits))
    jb = jep.select_base(jnp.asarray(digits))
    for t, j in zip(tb, jb):
        _same(t, j)


def test_double_base_scalar_mul_matches_oracle():
    rng = np.random.default_rng(11)
    pts = _points(6, b"ladder")
    s_vals = [0, 1, ref.L - 1] + [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in pts[3:]]
    m_vals = [ref.L - 1, 0, 7] + [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in pts[3:]]
    enc = lambda vals: torch.from_numpy(
        np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), np.uint8)
        .reshape(-1, 32)
        .copy()
    )
    tp, _ = _pair(pts)
    got = tep.double_base_scalar_mul(
        tfe.signed_digits_msb_first(enc(s_vals)),
        tfe.signed_digits_msb_first(enc(m_vals)),
        tp,
    )
    for i, (a, s, m) in enumerate(zip(pts, s_vals, m_vals)):
        want = ref.pt_add(ref.pt_mul(s, ref.BASE), ref.pt_mul(m, a))
        assert _affine(got, i) == _ref_affine(want)


def test_identity_predicate():
    pts = [ref.IDENTITY, ref.BASE, ref.pt_decompress_zip215((P - 1).to_bytes(32, "little"))]
    tp, jp = _pair(pts)
    np.testing.assert_array_equal(tep.is_identity(tp).numpy(), [True, False, False])
    np.testing.assert_array_equal(
        tep.is_identity(tp).numpy(), np.asarray(jep.is_identity(jp))
    )
    ident = tep.identity(3)
    assert tep.is_identity(ident).all()
