"""secp256k1 ECDSA keys in pure Python (reference: crypto/secp256k1/secp256k1.go).

The port's copy of ``cometbft_tpu/crypto/secp256k1.py`` without its
``cryptography`` branch: the port depends on no host crypto library, so
keys, addresses, signatures and verdicts are the same on every machine.

  * Bitcoin-style addressing: RIPEMD160(SHA256(33-byte compressed pubkey)),
    with a pure-Python RIPEMD-160 where ``hashlib`` has none (it depends on
    the OpenSSL build);
  * signatures are 64-byte R||S, RFC 6979 deterministic (SHA-256) with
    low-S normalization (the reference's btcec serialization), byte-equal
    to the JAX module's ``_sign_pure``;
  * verification rejects s > n/2 (low-S only), r or s outside (0, n) and
    keys that do not decompress — the rules of the JAX module.

A private key is its secret's bytes read as a big-endian scalar, as
``from_secret`` there.  Fixed-base multiples k*G go through a table of
the 32 radix-256 digits' multiples of G (affine, built once per process),
so key generation and signing cost 32 mixed additions each; a
10,240-validator set is keyed and signed in seconds.

This module is the host oracle of the port's batched ECDSA verify
(``ops/secp_verify.py`` and the CUDA kernel ``csrc/secp256k1_verify.cu``).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac_mod
import os as _os
import struct as _struct
import threading as _threading
from dataclasses import dataclass

SECP256K1_KEY_TYPE = "secp256k1"

# field prime, group order and generator (SEC 2, section 2.4.1)
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


# -- points: affine (x, y) tuples, None for the identity -----------------------


def pt_compress(p) -> bytes:
    x, y = p
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def pt_decompress(pub33: bytes):
    """SEC1 compressed point -> affine (x, y), or None."""
    if len(pub33) != 33 or pub33[0] not in (2, 3):
        return None
    x = int.from_bytes(pub33[1:], "big")
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)  # p = 3 (mod 4)
    if y * y % P != y2:
        return None
    if (y & 1) != (pub33[0] & 1):
        y = P - y
    return (x, y)


# -- Jacobian arithmetic and the fixed-base table ------------------------------


def _jac_double(x1, y1, z1):
    if y1 == 0 or z1 == 0:
        return (0, 1, 0)
    s = 4 * x1 * y1 * y1 % P
    m = 3 * x1 * x1 % P  # a = 0
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * pow(y1, 4, P)) % P
    return (x3, y3, 2 * y1 * z1 % P)


def _jac_add_affine(j, a):
    """Jacobian j + affine a (a is never the identity)."""
    x1, y1, z1 = j
    if z1 == 0:
        return (a[0], a[1], 1)
    zz = z1 * z1 % P
    u2 = a[0] * zz % P
    s2 = a[1] * zz * z1 % P
    h = (u2 - x1) % P
    r = (s2 - y1) % P
    if h == 0:
        return _jac_double(x1, y1, z1) if r == 0 else (0, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - y1 * hhh) % P
    return (x3, y3, z1 * h % P)


def _jac_add(j1, j2):
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    if z1 == 0:
        return j2
    if z2 == 0:
        return j1
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    h, r = (u2 - u1) % P, (s2 - s1) % P
    if h == 0:
        return _jac_double(x1, y1, z1) if r == 0 else (0, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    return (x3, y3, z1 * z2 * h % P)


def _to_affine(j):
    x, y, z = j
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


_TABLE: list = []
_TABLE_LOCK = _threading.Lock()


def _g_table() -> list:
    """``table[i][d - 1]`` = d * 256^i * G, affine, i = 0..31, d = 1..255."""
    if not _TABLE:
        with _TABLE_LOCK:
            if not _TABLE:
                rows, base = [], G
                for _ in range(32):
                    row, acc = [], (base[0], base[1], 1)
                    jac = [acc]
                    for _ in range(254):
                        acc = _jac_add_affine(acc, base)
                        jac.append(acc)
                    # one shared inversion per row (Montgomery's trick)
                    zs = [j[2] for j in jac]
                    prefix, run = [], 1
                    for z in zs:
                        prefix.append(run)
                        run = run * z % P
                    inv = pow(run, -1, P)
                    invs = [0] * len(zs)
                    for k in range(len(zs) - 1, -1, -1):
                        invs[k] = inv * prefix[k] % P
                        inv = inv * zs[k] % P
                    for (x, y, _), zi in zip(jac, invs):
                        zi2 = zi * zi % P
                        row.append((x * zi2 % P, y * zi2 * zi % P))
                    rows.append(row)
                    base = _to_affine(_jac_add_affine(jac[-1], base))  # 256 * base
                _TABLE.extend(rows)
    return _TABLE


def g_mul(k: int):
    """k*G (affine, None for the identity) through the fixed-base table."""
    k %= N
    table = _g_table()
    acc = (0, 1, 0)
    for i in range(32):
        d = (k >> (8 * i)) & 0xFF
        if d:
            acc = _jac_add_affine(acc, table[i][d - 1])
    return _to_affine(acc)


def double_mul(u1: int, u2: int, q):
    """u1*G + u2*q (affine or None): the table for G, Jacobian
    double-and-add for q."""
    acc = (0, 1, 0)
    for bit in range(u2.bit_length() - 1, -1, -1):
        acc = _jac_double(*acc)
        if (u2 >> bit) & 1:
            acc = _jac_add_affine(acc, q)
    gj = g_mul(u1)
    if gj is not None:
        acc = _jac_add(acc, (gj[0], gj[1], 1))
    return _to_affine(acc)


# -- RFC 6979 and RIPEMD-160 --------------------------------------------------


def _rfc6979_k(secret: bytes, digest: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256) over the secret's bytes as
    given, as the JAX module computes it."""
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = _hmac_mod.new(k, v + b"\x00" + secret + digest, hashlib.sha256).digest()
    v = _hmac_mod.new(k, v, hashlib.sha256).digest()
    k = _hmac_mod.new(k, v + b"\x01" + secret + digest, hashlib.sha256).digest()
    v = _hmac_mod.new(k, v, hashlib.sha256).digest()
    while True:
        v = _hmac_mod.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = _hmac_mod.new(k, v + b"\x00", hashlib.sha256).digest()
        v = _hmac_mod.new(k, v, hashlib.sha256).digest()


_RMD_R1 = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
_RMD_R2 = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
_RMD_S1 = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
_RMD_S2 = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
_RMD_K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_RMD_K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_M32 = 0xFFFFFFFF


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z & _M32)
    if j < 48:
        return (x | (~y & _M32)) ^ z
    if j < 64:
        return (x & z) | (y & ~z & _M32)
    return x ^ (y | (~z & _M32))


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def ripemd160_pure(data: bytes) -> bytes:
    """RIPEMD-160 (Dobbertin, Bosselaers, Preneel 1996) in pure Python."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = data + b"\x80" + bytes((55 - len(data)) % 64)
    msg += _struct.pack("<Q", (8 * len(data)) & 0xFFFFFFFFFFFFFFFF)
    for off in range(0, len(msg), 64):
        x = _struct.unpack("<16I", msg[off:off + 64])
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            r = j >> 4
            t = (al + _rmd_f(j, bl, cl, dl) + x[_RMD_R1[j]] + _RMD_K1[r]) & _M32
            t = (_rol(t, _RMD_S1[j]) + el) & _M32
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t
            t = (ar + _rmd_f(79 - j, br, cr, dr) + x[_RMD_R2[j]] + _RMD_K2[r]) & _M32
            t = (_rol(t, _RMD_S2[j]) + er) & _M32
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t
        t = (h[1] + cl + dr) & _M32
        h[1] = (h[2] + dl + er) & _M32
        h[2] = (h[3] + el + ar) & _M32
        h[3] = (h[4] + al + br) & _M32
        h[4] = (h[0] + bl + cr) & _M32
        h[0] = t
    return _struct.pack("<5I", *h)


def ripemd160(data: bytes) -> bytes:
    """RIPEMD-160 from ``hashlib`` where its OpenSSL build has it, else
    ``ripemd160_pure``."""
    try:
        rip = hashlib.new("ripemd160")
    except ValueError:
        return ripemd160_pure(data)
    rip.update(data)
    return rip.digest()


def address(pub33: bytes) -> bytes:
    return ripemd160(hashlib.sha256(pub33).digest())


# -- keys -----------------------------------------------------------------------


@dataclass(frozen=True)
class Secp256k1PubKey:
    data: bytes  # 33-byte compressed SEC1 point

    type_ = SECP256K1_KEY_TYPE

    def __post_init__(self):
        if len(self.data) != 33:
            raise ValueError("secp256k1 pubkey must be 33 bytes (compressed)")

    def address(self) -> bytes:
        addr = self.__dict__.get("_addr")
        if addr is None:
            addr = address(self.data)
            self.__dict__["_addr"] = addr
        return addr

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != 64:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if r == 0 or s == 0 or s > N // 2:  # reject non-low-S (reference)
            return False
        if r >= N:
            return False
        q = pt_decompress(self.data)
        if q is None:
            return False
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        w = pow(s, -1, N)
        rp = double_mul(e * w % N, r * w % N, q)
        return rp is not None and rp[0] % N == r

    def bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class Secp256k1PrivKey:
    secret: bytes  # read as a big-endian scalar

    type_ = SECP256K1_KEY_TYPE

    @staticmethod
    def generate() -> "Secp256k1PrivKey":
        while True:
            raw = _os.urandom(32)
            if 0 < int.from_bytes(raw, "big") < N:
                return Secp256k1PrivKey(raw)

    @staticmethod
    def from_secret(secret: bytes) -> "Secp256k1PrivKey":
        return Secp256k1PrivKey(secret)

    def pub_key(self) -> Secp256k1PubKey:
        point = g_mul(int.from_bytes(self.secret, "big"))
        return Secp256k1PubKey(pt_compress(point))

    def sign(self, msg: bytes) -> bytes:
        """RFC 6979 ECDSA over SHA-256(msg), low-S."""
        d = int.from_bytes(self.secret, "big")
        digest = hashlib.sha256(msg).digest()
        e = int.from_bytes(digest, "big")
        k = _rfc6979_k(self.secret, digest)
        while True:
            r = g_mul(k)[0] % N
            s = pow(k, -1, N) * (e + r * d) % N
            if r != 0 and s != 0:
                break
            k = (k + 1) % N or 1  # astronomically unlikely; stay total
        if s > N // 2:
            s = N - s  # low-S normalization
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def bytes(self) -> bytes:
        return self.secret
