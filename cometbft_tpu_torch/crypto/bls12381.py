"""BLS12-381 signatures (min-pubkey-size): the port's own copy of
``cometbft_tpu/crypto/bls12381.py``, importing nothing of JAX.

Mirrors the reference's blst-backed key type
(crypto/bls12381/key_bls12381.go:31-188, crypto/bls12381/const.go:1-17)
bit for bit in its conventions:

  * public keys are sk*G1, serialized **uncompressed** (96 bytes, ZCash
    flag encoding) — const.go PubKeySize = 96;
  * signatures are sk*H(msg) in G2, serialized **compressed** (96 bytes);
  * the hash-to-curve DST is the literal byte string the reference passes
    to blst — ``BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_``
    (key_bls12381.go:30; the G1 label is historical — the hash runs on
    G2, exactly as blst's P2Affine.Sign does with that tag);
  * key generation is the BLS-signature-draft HKDF KeyGen blst implements
    (salt "BLS-SIG-KEYGEN-SALT-", re-hashed until sk != 0);
  * verification parses the pubkey with a subgroup + non-infinity check
    (KeyValidate, key_bls12381.go:160-165) and the signature with a
    subgroup check that *allows* infinity (SigValidate(false),
    key_bls12381.go:180-185), then checks e(pk, H(msg)) == e(G1, sig).

Two halves:

  * the pure-Python oracle, from the public specifications: the
    Fp/Fp2/Fp6/Fp12 towers, G1 and G2 (``E1``, ``E2``), SSWU + 3-isogeny
    hash-to-curve (RFC 9380 section 8.8.2, ``hash_to_g2``), the optimal-ate
    Miller loop and final exponentiation (``pairing``,
    ``_pairing_product_is_one``), the ZCash serialization and KeyGen.
    Tests call it directly; no path of the port falls back to it;
  * the public API (``pubkey``, ``sign``, ``verify``,
    ``aggregate_signatures``) in the port's host library
    ``csrc/bls12381.cpp`` (``native.bls()``), which is built at first use
    and raises if it cannot be built or fails its self-check.  The JAX
    module falls back to the oracle when its library is missing (and on
    ``COMETBFT_TPU_NO_NATIVE``); the port has no such switch.  The JAX
    module's ``pubkey_validate`` and ``aggregate_verify`` have no caller
    on the port's path and are not copied (the batch verifier calls the
    library's ``bls_pubkey_validate`` itself).
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import os
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Base field and curve constants.
# ---------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # group order
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551
# BLS parameter x (the Miller loop count is -x; x < 0 for BLS12-381).
X_ABS = 0xD201000000010000

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

DST = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
KEYGEN_SALT = b"BLS-SIG-KEYGEN-SALT-"

PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 96       # uncompressed G1 (reference const.go:7)
SIGNATURE_SIZE = 96     # compressed G2 (reference const.go:9)


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1); elements are (a, b) = a + b*u as int tuples.
# ---------------------------------------------------------------------------

def _f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def _f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def _f2_neg(x):
    return (-x[0] % P, -x[1] % P)


def _f2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c % P
    bd = b * d % P
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def _f2_sq(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def _f2_scalar(x, k: int):
    return (x[0] * k % P, x[1] * k % P)


def _f2_conj(x):
    return (x[0], -x[1] % P)


def _f2_inv(x):
    a, b = x
    t = pow(a * a + b * b, P - 2, P)
    return (a * t % P, -b * t % P)


def _f2_pow(x, e: int):
    out = (1, 0)
    base = x
    while e:
        if e & 1:
            out = _f2_mul(out, base)
        base = _f2_sq(base)
        e >>= 1
    return out


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def _f2_sgn0(x) -> int:
    """RFC 9380 sgn0 for m=2."""
    s0 = x[0] % 2
    z0 = x[0] == 0
    s1 = x[1] % 2
    return s0 | (z0 & s1)


def _f2_is_square(x) -> bool:
    # norm(x) = a^2+b^2 must be a QR in Fp  <=>  x is a square in Fp2
    n = (x[0] * x[0] + x[1] * x[1]) % P
    return n == 0 or pow(n, (P - 1) // 2, P) == 1


def _f2_sqrt(x) -> Optional[tuple]:
    """sqrt in Fp2 (p ≡ 3 mod 4): candidate x^((p^2+7)/16) ... use the
    standard complex method via norms instead — deterministic and simple."""
    a, b = x
    if b == 0:
        if pow(a, (P - 1) // 2, P) in (0, 1):
            return (pow(a, (P + 1) // 4, P), 0)
        # sqrt(a) = sqrt(-a) * u since u^2 = -1
        return (0, pow(-a % P, (P + 1) // 4, P))
    n = (a * a + b * b) % P
    if pow(n, (P - 1) // 2, P) != 1:
        return None
    alpha = pow(n, (P + 1) // 4, P)  # sqrt of the norm
    for sgn in (1, -1):
        delta = (a + sgn * alpha) * pow(2, P - 2, P) % P
        if pow(delta, (P - 1) // 2, P) in (0, 1):
            x0 = pow(delta, (P + 1) // 4, P)
            if x0 == 0:
                continue
            x1 = b * pow(2 * x0, P - 2, P) % P
            cand = (x0, x1)
            if _f2_sq(cand) == (a % P, b % P):
                return cand
    return None


# ---------------------------------------------------------------------------
# Fp12 as a pair-of-Fp6, Fp6 as triple-of-Fp2.  Represented as nested
# tuples; xi = 1 + u is the Fp6 non-residue, v (Fp12) with v^2 = w in Fp6.
# ---------------------------------------------------------------------------

XI = (1, 1)  # 1 + u


def _f6_add(x, y):
    return tuple(_f2_add(a, b) for a, b in zip(x, y))


def _f6_sub(x, y):
    return tuple(_f2_sub(a, b) for a, b in zip(x, y))


def _f6_neg(x):
    return tuple(_f2_neg(a) for a in x)


def _f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = _f2_mul(a0, b0)
    t1 = _f2_mul(a1, b1)
    t2 = _f2_mul(a2, b2)
    c0 = _f2_add(t0, _f2_mul(XI, _f2_sub(_f2_mul(_f2_add(a1, a2), _f2_add(b1, b2)), _f2_add(t1, t2))))
    c1 = _f2_add(_f2_sub(_f2_mul(_f2_add(a0, a1), _f2_add(b0, b1)), _f2_add(t0, t1)), _f2_mul(XI, t2))
    c2 = _f2_add(_f2_sub(_f2_mul(_f2_add(a0, a2), _f2_add(b0, b2)), _f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _f6_mul_by_xi(x):
    # multiply by w (the cubic generator): (a0,a1,a2) * w = (xi*a2, a0, a1)
    return (_f2_mul(XI, x[2]), x[0], x[1])


def _f6_inv(x):
    a0, a1, a2 = x
    t0 = _f2_sq(a0)
    t1 = _f2_sq(a1)
    t2 = _f2_sq(a2)
    t3 = _f2_mul(a0, a1)
    t4 = _f2_mul(a0, a2)
    t5 = _f2_mul(a1, a2)
    c0 = _f2_sub(t0, _f2_mul(XI, t5))
    c1 = _f2_sub(_f2_mul(XI, t2), t3)
    c2 = _f2_sub(t1, t4)
    t6 = _f2_add(_f2_mul(a0, c0), _f2_mul(XI, _f2_add(_f2_mul(a2, c1), _f2_mul(a1, c2))))
    t6i = _f2_inv(t6)
    return (_f2_mul(c0, t6i), _f2_mul(c1, t6i), _f2_mul(c2, t6i))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def _f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = _f6_mul(a0, b0)
    t1 = _f6_mul(a1, b1)
    c0 = _f6_add(t0, _f6_mul_by_xi(t1))
    c1 = _f6_sub(_f6_mul(_f6_add(a0, a1), _f6_add(b0, b1)), _f6_add(t0, t1))
    return (c0, c1)


def _f12_sq(x):
    return _f12_mul(x, x)


def _f12_inv(x):
    a0, a1 = x
    t = _f6_inv(_f6_sub(_f6_mul(a0, a0), _f6_mul_by_xi(_f6_mul(a1, a1))))
    return (_f6_mul(a0, t), _f6_neg(_f6_mul(a1, t)))


def _f12_conj(x):
    return (x[0], _f6_neg(x[1]))


def _f12_pow(x, e: int):
    out = F12_ONE
    base = x
    while e:
        if e & 1:
            out = _f12_mul(out, base)
        base = _f12_sq(base)
        e >>= 1
    return out


F12_ONE = (F6_ONE, F6_ZERO)

# Frobenius coefficients for Fp2: (a + bu)^p = a - bu.  For Fp6/Fp12 we
# apply frobenius by mapping through the tower with precomputed gammas.
_FROB_GAMMA1 = [
    _f2_pow(XI, (P - 1) * k // 6) for k in range(6)
]  # xi^((p-1)k/6), k = 0..5


def _f12_frobenius(x):
    """x^p for x in Fp12 (one application)."""
    (a0, a1, a2), (b0, b1, b2) = x
    a0 = _f2_conj(a0)
    a1 = _f2_mul(_f2_conj(a1), _FROB_GAMMA1[2])
    a2 = _f2_mul(_f2_conj(a2), _FROB_GAMMA1[4])
    b0 = _f2_mul(_f2_conj(b0), _FROB_GAMMA1[1])
    b1 = _f2_mul(_f2_conj(b1), _FROB_GAMMA1[3])
    b2 = _f2_mul(_f2_conj(b2), _FROB_GAMMA1[5])
    return ((a0, a1, a2), (b0, b1, b2))


# ---------------------------------------------------------------------------
# G1 (E: y^2 = x^3 + 4 over Fp) and G2 (E': y^2 = x^3 + 4(1+u) over Fp2),
# Jacobian coordinates (X, Y, Z): x = X/Z^2, y = Y/Z^3.
# ---------------------------------------------------------------------------

class _Curve:
    """Generic short-Weierstrass Jacobian arithmetic over a field given by
    add/sub/mul/sq/inv/eq-zero callables — one implementation drives both
    G1 (Fp) and G2 (Fp2)."""

    def __init__(self, add, sub, neg, mul, sq, inv, zero, one, b):
        self.add, self.sub, self.neg = add, sub, neg
        self.mul, self.sq, self.inv = mul, sq, inv
        self.zero, self.one, self.b = zero, one, b

    def infinity(self):
        return (self.one, self.one, self.zero)

    def is_infinity(self, pt) -> bool:
        return pt[2] == self.zero

    def double(self, pt):
        X, Y, Z = pt
        if Z == self.zero:
            return pt
        A = self.sq(X)
        B = self.sq(Y)
        C = self.sq(B)
        t = self.sub(self.sq(self.add(X, B)), self.add(A, C))
        D = self.add(t, t)
        E = self.add(self.add(A, A), A)
        F = self.sq(E)
        X3 = self.sub(F, self.add(D, D))
        c8 = self.add(self.add(self.add(C, C), self.add(C, C)), self.add(self.add(C, C), self.add(C, C)))
        Y3 = self.sub(self.mul(E, self.sub(D, X3)), c8)
        Z3 = self.mul(self.add(Y, Y), Z)
        return (X3, Y3, Z3)

    def add_pts(self, p1, p2):
        if p1[2] == self.zero:
            return p2
        if p2[2] == self.zero:
            return p1
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = self.sq(Z1)
        Z2Z2 = self.sq(Z2)
        U1 = self.mul(X1, Z2Z2)
        U2 = self.mul(X2, Z1Z1)
        S1 = self.mul(self.mul(Y1, Z2), Z2Z2)
        S2 = self.mul(self.mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 == S2:
                return self.double(p1)
            return self.infinity()
        H = self.sub(U2, U1)
        I = self.sq(self.add(H, H))
        J = self.mul(H, I)
        rr = self.add(self.sub(S2, S1), self.sub(S2, S1))
        V = self.mul(U1, I)
        X3 = self.sub(self.sub(self.sq(rr), J), self.add(V, V))
        S1J = self.mul(S1, J)
        Y3 = self.sub(self.mul(rr, self.sub(V, X3)), self.add(S1J, S1J))
        Z3 = self.mul(self.sub(self.sq(self.add(Z1, Z2)), self.add(Z1Z1, Z2Z2)), H)
        return (X3, Y3, Z3)

    def neg_pt(self, pt):
        return (pt[0], self.neg(pt[1]), pt[2])

    def mul_scalar(self, pt, k: int):
        if k < 0:
            return self.mul_scalar(self.neg_pt(pt), -k)
        out = self.infinity()
        add = pt
        while k:
            if k & 1:
                out = self.add_pts(out, add)
            add = self.double(add)
            k >>= 1
        return out

    def affine(self, pt):
        if pt[2] == self.zero:
            return None
        zi = self.inv(pt[2])
        zi2 = self.sq(zi)
        return (self.mul(pt[0], zi2), self.mul(pt[1], self.mul(zi2, zi)))

    def on_curve(self, pt) -> bool:
        if pt[2] == self.zero:
            return True
        aff = self.affine(pt)
        return self.sq(aff[1]) == self.add(self.mul(self.sq(aff[0]), aff[0]), self.b)


def _fp_ops():
    return _Curve(
        add=lambda a, b: (a + b) % P,
        sub=lambda a, b: (a - b) % P,
        neg=lambda a: -a % P,
        mul=lambda a, b: a * b % P,
        sq=lambda a: a * a % P,
        inv=lambda a: pow(a, P - 2, P),
        zero=0,
        one=1,
        b=4,
    )


def _fp2_ops():
    return _Curve(
        add=_f2_add,
        sub=_f2_sub,
        neg=_f2_neg,
        mul=_f2_mul,
        sq=_f2_sq,
        inv=_f2_inv,
        zero=F2_ZERO,
        one=F2_ONE,
        b=_f2_scalar(XI, 4),  # 4(1+u)
    )


E1 = _fp_ops()
E2 = _fp2_ops()
G1_GEN = (G1_X, G1_Y, 1)
G2_GEN = (G2_X, G2_Y, F2_ONE)


def _g1_subgroup(pt) -> bool:
    return E1.is_infinity(E1.mul_scalar(pt, R))


def _g2_subgroup(pt) -> bool:
    return E2.is_infinity(E2.mul_scalar(pt, R))


# ---------------------------------------------------------------------------
# Pairing: optimal ate.  e(P in G1, Q in G2) via Miller loop over -x.
# ---------------------------------------------------------------------------

def _g2_affine(r):
    zi = _f2_inv(r[2])
    zi2 = _f2_sq(zi)
    return (_f2_mul(r[0], zi2), _f2_mul(r[1], _f2_mul(zi2, zi)))


def _fp12_from_coeffs(c0_f2, c2_f2, c3_f2):
    """Element c0 + c2*w^2 + c3*w^3 of Fp12 in the (Fp6, Fp6) tower where
    w^2 has Fp6 coordinate index 1 of the even part and w^3 index 1 of the
    odd part... concretely: Fp12 = Fp6[v]/(v^2 - w6gen); basis
    {1, w, w^2, w^3, w^4, w^5} maps to even part (1, w^2, w^4) and odd
    part (w, w^3, w^5)."""
    even = (c0_f2, c2_f2, F2_ZERO)
    odd = (F2_ZERO, c3_f2, F2_ZERO)
    return (even, odd)


def _line_eval_generic(r_old, r_new, p_aff, tangent: bool, q_aff=None):
    """Evaluate the line through r_old (tangent) or through r_old and
    q_aff (chord) at the G1 point p_aff, in Fp12.

    The line through two G2 points (x1,y1),(x2,y2) (affine over Fp2) is
      l(x, y) = (y - y1) - m (x - x1),  m = slope (in Fp2).
    With the untwist x = x' * w^2, y = y' * w^3 for G1 coordinates
    embedded... (standard M-twist embedding: G1 point (px, py) maps into
    Fp12 as (px, py); G2 points map via multiplication by powers of w).
    Evaluated: l = py*w^3... — we use:
      l(P) = (y1*? ...)
    Concretely with the G2-on-twist convention:
      l(P) = py * w^3 - y1 - m * (px * w^2 - x1)
           = (m*x1 - y1) + (-m*px) * w^2 + (py) * w^3
    all coefficients in Fp2 (px, py lift to (px, 0), (py, 0)).
    """
    x1, y1 = _g2_affine(r_old)
    if tangent:
        # m = 3*x1^2 / (2*y1)
        num = _f2_scalar(_f2_sq(x1), 3)
        den = _f2_scalar(y1, 2)
    else:
        x2, y2 = q_aff
        if x1 == x2 and y1 == y2:
            return _line_eval_generic(r_old, r_new, p_aff, tangent=True)
        num = _f2_sub(y2, y1)
        den = _f2_sub(x2, x1)
        if den == F2_ZERO:
            # vertical line: l(P) = px - x1 (w^2 component)
            px, _py = p_aff
            c0 = _f2_neg(x1)
            return _fp12_from_coeffs(c0, ((px % P), 0), F2_ZERO)
    m = _f2_mul(num, _f2_inv(den))
    px, py = p_aff
    c0 = _f2_sub(_f2_mul(m, x1), y1)
    c2 = _f2_neg(_f2_scalar(m, px % P))
    c3 = ((py % P), 0)
    return _fp12_from_coeffs(c0, c2, c3)


def _miller_loop(p_aff, q_jac):
    """f_{-x, Q}(P) without final exponentiation (the -x handled by
    conjugation at the end, standard for BLS12 with negative x)."""
    f = F12_ONE
    r = q_jac
    q_affine = _g2_affine(q_jac)
    bits = bin(X_ABS)[3:]  # skip MSB
    for bit in bits:
        line = _line_eval_generic(r, None, p_aff, tangent=True)
        r = E2.double(r)
        f = _f12_mul(_f12_sq(f), line)
        if bit == "1":
            line = _line_eval_generic(r, None, p_aff, tangent=False, q_aff=q_affine)
            r = E2.add_pts(r, (q_affine[0], q_affine[1], F2_ONE))
            f = _f12_mul(f, line)
    # x is negative for BLS12-381: f <- conj(f)
    return _f12_conj(f)


def _final_exponentiation(f):
    """f^((p^12-1)/r): easy part then hard part (naive exponent — slow but
    transparently correct)."""
    # easy part: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f = _f12_mul(_f12_conj(f), _f12_inv(f))
    f = _f12_mul(_f12_frobenius(_f12_frobenius(f)), f)
    # hard part: exponent (p^4 - p^2 + 1)/r, naive square-and-multiply.
    e = (P**4 - P**2 + 1) // R
    return _f12_pow(f, e)


def pairing(p1_jac, q2_jac) -> tuple:
    """e(P, Q) for P in G1 (Jacobian ints), Q in G2 (Jacobian Fp2)."""
    if E1.is_infinity(p1_jac) or E2.is_infinity(q2_jac):
        return F12_ONE
    p_aff = E1.affine(p1_jac)
    return _final_exponentiation(_miller_loop(p_aff, q2_jac))


def _pairing_product_is_one(pairs) -> bool:
    """prod e(Pi, Qi) == 1, with one shared final exponentiation."""
    f = F12_ONE
    any_term = False
    for p1, q2 in pairs:
        if E1.is_infinity(p1) or E2.is_infinity(q2):
            continue
        any_term = True
        f = _f12_mul(f, _miller_loop(E1.affine(p1), q2))
    if not any_term:
        return True
    return _final_exponentiation(f) == F12_ONE


# ---------------------------------------------------------------------------
# Serialization (ZCash flag convention, as blst Serialize/Compress).
# ---------------------------------------------------------------------------

def g1_serialize(pt) -> bytes:
    """Uncompressed 96-byte G1 (the reference's PubKey.Bytes)."""
    if E1.is_infinity(pt):
        out = bytearray(96)
        out[0] = 0x40
        return bytes(out)
    x, y = E1.affine(pt)
    out = x.to_bytes(48, "big") + y.to_bytes(48, "big")
    return out


def g1_negate_serialized(pub: bytes) -> bytes:
    """-P over the 96-byte uncompressed encoding (flip y; pure bytes, no
    curve arithmetic — used to feed negated terms to the native pairing
    product)."""
    if pub[0] & 0x40:  # infinity
        return pub
    y = int.from_bytes(pub[48:], "big")
    return pub[:48] + ((P - y) % P).to_bytes(48, "big")


def g1_deserialize(b: bytes):
    """Uncompressed or compressed G1 with ZCash flags; returns Jacobian or
    None.  On-curve is checked; subgroup is NOT (callers decide)."""
    if len(b) == 96 and not (b[0] & 0x80):
        flags = b[0]
        if flags & 0x40:
            if any(b) and b != b"\x40" + bytes(95):
                return None
            return E1.infinity()
        x = int.from_bytes(b[:48], "big")
        y = int.from_bytes(b[48:], "big")
        if x >= P or y >= P:
            return None
        pt = (x, y, 1)
        return pt if E1.on_curve(pt) else None
    if len(b) == 48 and (b[0] & 0x80):
        flags = b[0]
        if flags & 0x40:
            if (flags & 0x3F) or any(b[1:]):
                return None
            return E1.infinity()
        x = int.from_bytes(bytes([flags & 0x1F]) + b[1:], "big")
        if x >= P:
            return None
        y2 = (pow(x, 3, P) + 4) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            return None
        y_is_larger = y > (P - 1) // 2
        want_larger = bool(flags & 0x20)
        if y_is_larger != want_larger:
            y = P - y
        return (x, y, 1)
    return None


def g2_compress(pt) -> bytes:
    """Compressed 96-byte G2 (the reference's signature encoding)."""
    if E2.is_infinity(pt):
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    (x0, x1), (y0, y1) = _g2_affine(pt)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80
    # sign: lexicographically larger y (compare (y1, y0) big-endian pair)
    if (y1, y0) > ((P - y1) % P, (P - y0) % P):
        out[0] |= 0x20
    return bytes(out)


def g2_uncompress(b: bytes):
    """Compressed G2 -> Jacobian (or None).  On-curve checked, subgroup
    NOT (SigValidate does that separately, infinity allowed)."""
    if len(b) != 96 or not (b[0] & 0x80):
        return None
    flags = b[0]
    if flags & 0x40:
        if (flags & 0x3F) or any(b[1:]):
            return None
        return E2.infinity()
    x1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        return None
    x = (x0, x1)
    y2 = _f2_add(_f2_mul(_f2_sq(x), x), E2.b)
    y = _f2_sqrt(y2)
    if y is None:
        return None
    neg = _f2_neg(y)
    y_larger = (y[1], y[0]) > (neg[1], neg[0])
    if y_larger != bool(flags & 0x20):
        y = neg
    return (x, y, F2_ONE)


# ---------------------------------------------------------------------------
# Hash-to-curve G2 (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_).
# ---------------------------------------------------------------------------

def _expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    ell = -(-length // 32)
    assert ell <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(64)
    l_i_b = length.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bvals = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bytes(x ^ y for x, y in zip(b0, bvals[-1]))
        bvals.append(hashlib.sha256(prev + bytes([i]) + dst_prime).digest())
    return b"".join(bvals)[:length]


def _hash_to_field_fp2(msg: bytes, count: int, dst: bytes):
    L = 64
    uniform = _expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append((coords[0], coords[1]))
    return out


# SSWU constants for E2': y^2 = x^3 + A'x + B', Z = -(2 + u)
_SSWU_A = (0, 240)
_SSWU_B = (1012, 1012)
_SSWU_Z = (-2 % P, -1 % P)

# 3-isogeny map E2' -> E2 coefficients (RFC 9380 appendix E.3).
_ISO_XNUM = [
    ((0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6, 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6)),
    ((0, 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A)),
    ((0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E, 0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D)),
    ((0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0)),
]
_ISO_XDEN = [
    ((0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63)),
    ((0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F)),
    ((1, 0)),
]
_ISO_YNUM = [
    ((0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706, 0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706)),
    ((0, 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE)),
    ((0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C, 0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F)),
    ((0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0)),
]
_ISO_YDEN = [
    ((P - 0x1B0, P - 0x1B0)),  # k_(4,0) = (p - 0x1b0) * (1 + u)
    ((0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3)),
    ((0x12, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99)),
    ((1, 0)),
]


def _sswu_map(u):
    """Simplified SWU for E2' (RFC 9380 section 6.6.2)."""
    A, B, Z = _SSWU_A, _SSWU_B, _SSWU_Z
    u2 = _f2_sq(u)
    tv1 = _f2_mul(Z, u2)  # Z*u^2
    tv2 = _f2_add(_f2_sq(tv1), tv1)
    x1num = _f2_mul(B, _f2_add(tv2, F2_ONE))
    x1den = _f2_mul(_f2_neg(A), tv2)
    if x1den == F2_ZERO:
        x1den = _f2_mul(Z, A)
    x1 = _f2_mul(x1num, _f2_inv(x1den))
    gx1 = _f2_add(_f2_add(_f2_mul(_f2_sq(x1), x1), _f2_mul(A, x1)), B)
    if _f2_is_square(gx1):
        x, y = x1, _f2_sqrt(gx1)
    else:
        # g(Z*u^2*x1) = (Z*u^2)^3 * g(x1); Z non-square => exactly one of
        # g(x1), g(x2) is square
        x = _f2_mul(tv1, x1)
        y = _f2_sqrt(_f2_mul(_f2_mul(_f2_sq(tv1), tv1), gx1))
    assert y is not None
    if _f2_sgn0(u) != _f2_sgn0(y):
        y = _f2_neg(y)
    return (x, y)


def _iso_map(x, y):
    """3-isogeny E2' -> E2 via Horner evaluation of the rational maps."""

    def horner(coeffs, xv):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = _f2_add(_f2_mul(acc, xv), c)
        return acc

    xnum = horner(_ISO_XNUM, x)
    xden = horner(_ISO_XDEN, x)
    ynum = horner(_ISO_YNUM, x)
    yden = horner(_ISO_YDEN, x)
    xo = _f2_mul(xnum, _f2_inv(xden))
    yo = _f2_mul(y, _f2_mul(ynum, _f2_inv(yden)))
    return (xo, yo)


def hash_to_g2(msg: bytes, dst: bytes = DST):
    """hash_to_curve for G2 (random oracle variant), returns Jacobian: the
    oracle of the host library's ``bls_hash_to_g2``."""
    u0, u1 = _hash_to_field_fp2(msg, 2, dst)
    q0 = _iso_map(*_sswu_map(u0))
    q1 = _iso_map(*_sswu_map(u1))
    s = E2.add_pts((q0[0], q0[1], F2_ONE), (q1[0], q1[1], F2_ONE))
    return E2.mul_scalar(s, H_EFF_G2)


def _nat():
    """The host library (``native.bls()``): loads or raises."""
    from cometbft_tpu_torch import native

    return native.bls()


# ---------------------------------------------------------------------------
# KeyGen / sign / verify / aggregate (the reference's API surface).
# ---------------------------------------------------------------------------

def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """BLS-signature-draft KeyGen (what blst.KeyGen implements): HKDF with
    the fixed salt, re-hashing the salt until sk != 0."""
    if len(ikm) < 32:
        raise ValueError("ikm must be >= 32 bytes")
    salt = KEYGEN_SALT
    L = 48
    while True:
        salt = hashlib.sha256(salt).digest()
        prk = hmac.new(salt, ikm + b"\x00", hashlib.sha256).digest()
        okm = b""
        t = b""
        info = key_info + L.to_bytes(2, "big")
        i = 1
        while len(okm) < L:
            t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            okm += t
            i += 1
        sk = int.from_bytes(okm[:L], "big") % R
        if sk != 0:
            return sk


def gen_privkey_from_secret(secret: bytes) -> int:
    """Reference GenPrivKeyFromSecret (key_bls12381.go:66-74): sha256 the
    secret to 32 bytes unless it already is 32."""
    if len(secret) != 32:
        secret = hashlib.sha256(secret).digest()
    return keygen(secret)


def gen_privkey() -> int:
    return keygen(os.urandom(32))


def sk_to_bytes(sk: int) -> bytes:
    return sk.to_bytes(32, "big")


def sk_from_bytes(b: bytes) -> Optional[int]:
    if len(b) != 32:
        return None
    v = int.from_bytes(b, "big")
    if v == 0 or v >= R:
        return None
    return v


def pubkey(sk: int) -> bytes:
    """96-byte uncompressed G1 (reference PubKey.Bytes)."""
    out = ctypes.create_string_buffer(96)
    if _nat().bls_pubkey_from_sk(sk.to_bytes(32, "big"), out) != 0:
        raise RuntimeError("bls_pubkey_from_sk failed")
    return out.raw


def sign(sk: int, msg: bytes) -> bytes:
    """96-byte compressed G2: sk * H(msg)."""
    out = ctypes.create_string_buffer(96)
    if _nat().bls_sign(sk.to_bytes(32, "big"), msg, len(msg), out) != 0:
        raise RuntimeError("bls_sign failed")
    return out.raw


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Reference VerifySignature semantics (key_bls12381.go:174-188)."""
    if len(sig) != SIGNATURE_SIZE:
        return False
    return _nat().bls_verify(pub, len(pub), msg, len(msg), sig) == 1


def aggregate_signatures(sigs: Sequence[bytes]) -> Optional[bytes]:
    """Sum of G2 signatures (basic scheme aggregation); None when one does
    not parse."""
    if any(len(s) != SIGNATURE_SIZE for s in sigs):
        return None
    out = ctypes.create_string_buffer(96)
    if _nat().bls_aggregate_sigs(b"".join(sigs), len(sigs), out) != 0:
        return None
    return out.raw


# ---------------------------------------------------------------------------
# The same API in pure Python: the oracle the tests hold the library to.
# ---------------------------------------------------------------------------

def pubkey_py(sk: int) -> bytes:
    return g1_serialize(E1.mul_scalar(G1_GEN, sk))


def sign_py(sk: int, msg: bytes) -> bytes:
    return g2_compress(E2.mul_scalar(hash_to_g2(msg), sk))


def verify_py(pub: bytes, msg: bytes, sig: bytes) -> bool:
    pk = g1_deserialize(pub)
    if pk is None or E1.is_infinity(pk) or not _g1_subgroup(pk):
        return False
    s = g2_uncompress(sig)
    if s is None:
        return False
    # SigValidate(false): subgroup check, infinity allowed
    if not _g2_subgroup(s):
        return False
    h = hash_to_g2(msg)
    # e(pk, H(msg)) == e(G1, sig)  <=>  e(-pk, H) * e(G1, sig) == 1
    return _pairing_product_is_one([(E1.neg_pt(pk), h), (G1_GEN, s)])
