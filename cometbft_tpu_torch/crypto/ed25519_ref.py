"""Pure-Python Ed25519 with ZIP-215 verification semantics.

This is the *correctness oracle* for the port's batch verifier (the CUDA
kernel and its plain PyTorch version), and the implementation used for
signing (validators sign one vote at a time — the
hot path is verification, not signing).

Semantics mirror what the reference gets from curve25519-voi with ZIP-215
options (reference: crypto/ed25519/ed25519.go:170-222):

  * Point decompression accepts non-canonical y encodings (y >= p) and
    small/mixed-order points.  The only rejection is a non-square x^2
    candidate.
  * The scalar ``s`` of a signature must be canonical (s < L).
  * The verification equation is cofactored:  [8][s]B == [8]R + [8][h]A.

Everything here is plain Python big-int arithmetic — slow but transparent,
used for tests, key generation, vote signing and as a differential oracle for
the batched verifier in ``cometbft_tpu_torch.ops``.  Stdlib only: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import threading as _threading
from collections import OrderedDict
from functools import lru_cache as _lru_cache
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Field / curve constants (Curve25519 / edwards25519, RFC 8032 section 5.1)
# ---------------------------------------------------------------------------

P = 2**255 - 19
# Curve constant d = -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
# Group order of the prime-order subgroup.
L = 2**252 + 27742317777372353535851937790883648493
# sqrt(-1) mod p (= 2^((p-1)/4)).
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended homogeneous (X, Y, Z, T), T=XY/Z

IDENTITY: Point = (0, 1, 1, 0)


def _fe_sqrt_ratio(u: int, v: int) -> Tuple[bool, int]:
    """Return (ok, x) with x = sqrt(u/v) when u/v is square mod p.

    Uses the (p+3)/8 exponent trick: x = u*v^3 * (u*v^7)^((p-5)/8); if
    v*x^2 == -u the root is x*sqrt(-1); otherwise u/v was not a square.
    """
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    x = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    vx2 = v * x % P * x % P
    if vx2 == u % P:
        return True, x
    if vx2 == (-u) % P:
        return True, x * SQRT_M1 % P
    return False, 0


# ---------------------------------------------------------------------------
# Point arithmetic (extended twisted Edwards coordinates, RFC 8032 5.1.4)
# ---------------------------------------------------------------------------

def pt_add(p1: Point, p2: Point) -> Point:
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * D2 % P * T2 % P
    Dv = Z1 * 2 % P * Z2 % P
    E = (B - A) % P
    F = (Dv - C) % P
    G = (Dv + C) % P
    H = (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p1: Point) -> Point:
    X1, Y1, Z1, _ = p1
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 % P * Z1 % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p1: Point) -> Point:
    X, Y, Z, T = p1
    return ((-X) % P, Y, Z, (-T) % P)


def pt_mul(k: int, p1: Point) -> Point:
    acc = IDENTITY
    while k > 0:
        if k & 1:
            acc = pt_add(acc, p1)
        p1 = pt_double(p1)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Comb-table scalar multiplication
#
# A comb table for point P holds, for every 4-bit window i of the scalar,
# the multiples [j * 16^i * P for j in 1..15].  A scalar-mul is then just
# one table lookup + point addition per non-zero nibble (<= 64 additions,
# no doublings), ~8x cheaper than the double-and-add ladder.  Tables are
# built once per point: at import for the base point, LRU-cached per
# public key for verification — validators verify the same handful of
# keys thousands of times, which is the hot path this exists for.
# ---------------------------------------------------------------------------

_COMB_WINDOWS = 64  # 64 x 4-bit nibbles covers any scalar < 2^256


def _build_comb(p1: Point) -> tuple:
    rows = []
    base = p1
    for _ in range(_COMB_WINDOWS):
        row = [None, base]
        for j in range(2, 16):
            row.append(pt_add(row[j - 1], base))
        rows.append(tuple(row))
        for _ in range(4):
            base = pt_double(base)
    return tuple(rows)


def _comb_mul(comb: tuple, k: int) -> Point:
    acc = IDENTITY
    i = 0
    while k > 0:
        nib = k & 15
        if nib:
            acc = pt_add(acc, comb[i][nib])
        k >>= 4
        i += 1
    return acc


def pt_equal(p1: Point, p2: Point) -> bool:
    """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def pt_is_identity(p1: Point) -> bool:
    X, Y, Z, _ = p1
    return X % P == 0 and (Y - Z) % P == 0


# Base point B: y = 4/5 mod p, x recovered with even sign.
_by = 4 * pow(5, P - 2, P) % P
_ok, _bx = _fe_sqrt_ratio((_by * _by - 1) % P, (D * _by * _by + 1) % P)
assert _ok
if _bx & 1:  # RFC 8032: base point has x with sign bit 0
    _bx = P - _bx
BASE: Point = (_bx, _by, 1, _bx * _by % P)

_BASE_COMB = _build_comb(BASE)


def pt_mul_base(k: int) -> Point:
    """k*B through the precomputed base-point comb (sign / verify hot path)."""
    return _comb_mul(_BASE_COMB, k)


# ---------------------------------------------------------------------------
# Encoding / decoding
# ---------------------------------------------------------------------------

def pt_compress(p1: Point) -> bytes:
    X, Y, Z, _ = p1
    zi = pow(Z, P - 2, P)
    x = X * zi % P
    y = Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def pt_decompress_zip215(b: bytes) -> Optional[Point]:
    """ZIP-215 decompression: non-canonical y (>= p) and small-order points
    are accepted; the only failure mode is a non-square x^2 candidate."""
    if len(b) != 32:
        return None
    enc = int.from_bytes(b, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)  # NOT reduced-checked: y >= p is accepted
    y %= P
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    ok, x = _fe_sqrt_ratio(u, v)
    if not ok:
        return None
    if x & 1:
        x = P - x  # normalize to the even ("nonnegative") root
    if sign:
        x = (P - x) % P  # x == 0 stays 0: non-canonical sign bit accepted
    return (x, y, 1, x * y % P)


def sc_reduce(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


# ---------------------------------------------------------------------------
# Keys / sign / verify
# ---------------------------------------------------------------------------

def _expand_seed(seed: bytes) -> Tuple[int, bytes]:
    if len(seed) != 32:
        raise ValueError(f"ed25519 seed must be 32 bytes, got {len(seed)}")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def pubkey_from_seed(seed: bytes) -> bytes:
    a, _ = _expand_seed(seed)
    return pt_compress(pt_mul_base(a))


def generate_seed() -> bytes:
    return os.urandom(32)


def expand(seed: bytes) -> Tuple[int, bytes, bytes]:
    """(a, prefix, compressed pub) of a seed: the signing key in the form
    ``sign_expanded`` takes, one comb-mul."""
    a, prefix = _expand_seed(seed)
    return a, prefix, pt_compress(pt_mul_base(a))


# cached so a validator signing thousands of votes derives its pubkey once
_expanded_with_pub = _lru_cache(maxsize=64)(expand)


def sign_expanded(expanded: Tuple[int, bytes, bytes], msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signing with a key from ``expand``."""
    a, prefix, pub = expanded
    r = sc_reduce(hashlib.sha512(prefix + msg).digest())
    R = pt_compress(pt_mul_base(r))
    k = sc_reduce(hashlib.sha512(R + pub + msg).digest())
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signing."""
    return sign_expanded(_expanded_with_pub(seed), msg)


# Comb tables per compressed public key, built on SECOND sight: a comb
# build costs ~3 ladder muls, so a one-shot key (fuzzed garbage, an
# ephemeral peer) sticks to the plain ladder while any repeated key — a
# validator verifying thousands of votes — gets the ~8x comb.  Keyed on
# the encoding, not the point: ZIP-215 accepts non-canonical encodings,
# and two encodings of one point simply build equal tables.  Failed
# decompressions are never cached, so garbage cannot evict real keys.
_PUB_COMB_CACHE: "OrderedDict[bytes, tuple]" = OrderedDict()
_PUB_COMB_MAX = 256
_PUB_SEEN: "OrderedDict[bytes, int]" = OrderedDict()
_PUB_SEEN_MAX = 1024
# verify_zip215 runs concurrently on reactor/consensus/p2p threads; LRU
# bookkeeping (get + move_to_end vs evicting insert) must be atomic or a
# hit can race an eviction into a KeyError out of signature verification
_COMB_LOCK = _threading.Lock()


def _comb_caches_clear() -> None:
    with _COMB_LOCK:
        _PUB_COMB_CACHE.clear()
        _PUB_SEEN.clear()


def _pub_comb(pub: bytes) -> Optional[tuple]:
    """Comb table for a compressed public key, or None (first sight or
    decompress failure) — the caller falls back to the ladder."""
    with _COMB_LOCK:
        comb = _PUB_COMB_CACHE.get(pub)
        if comb is not None:
            _PUB_COMB_CACHE.move_to_end(pub)
            return comb
        seen = _PUB_SEEN.get(pub, 0) + 1
        if seen < 2:
            _PUB_SEEN[pub] = seen
            _PUB_SEEN.move_to_end(pub)
            if len(_PUB_SEEN) > _PUB_SEEN_MAX:
                _PUB_SEEN.popitem(last=False)
            return None
    A = pt_decompress_zip215(pub)
    if A is None:
        return None
    comb = _build_comb(A)  # outside the lock: ~1100 point ops
    with _COMB_LOCK:
        _PUB_SEEN.pop(pub, None)
        _PUB_COMB_CACHE[pub] = comb
        if len(_PUB_COMB_CACHE) > _PUB_COMB_MAX:
            _PUB_COMB_CACHE.popitem(last=False)
    return comb


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactored single verification with ZIP-215 semantics."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    comb_a = _pub_comb(pub)
    if comb_a is None:
        A = pt_decompress_zip215(pub)
        if A is None:
            return False
    R = pt_decompress_zip215(sig[:32])
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # s must be canonical
        return False
    h = sc_reduce(hashlib.sha512(sig[:32] + pub + msg).digest())
    hA = _comb_mul(comb_a, h) if comb_a is not None else pt_mul(h, A)
    # Q = s*B - h*A - R ; accept iff [8]Q == identity.
    Q = pt_add(pt_add(pt_mul_base(s), pt_neg(hA)), pt_neg(R))
    for _ in range(3):
        Q = pt_double(Q)
    return pt_is_identity(Q)


def batch_inputs_valid(pub: bytes, sig: bytes) -> bool:
    """Cheap structural checks shared by batch paths."""
    return len(pub) == 32 and len(sig) == 64
