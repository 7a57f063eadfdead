"""Pure-Python X25519 (RFC 7748) and ChaCha20-Poly1305 (RFC 8439).

The port's own copy of the JAX package's ``crypto/aead_ref.py``.  It is
the oracle of both transport kernels (``csrc/chacha20_poly1305.cu``,
``csrc/x25519_ladder.cu``) and of their plain PyTorch versions, and the
serial path of ``p2p/secret_connection``: singles and batches under the
plane's minimum are sealed and opened here.  The port does not use the
``cryptography`` package (the card's machine lacks it), and these are the
same bytes.

Both primitives are deliberately dependency-free big-int/word code, so the
differential tests can pin them against any other implementation.
"""

from __future__ import annotations

import os
import struct

# ----------------------------------------------------------------------
# X25519 (RFC 7748 §5)
# ----------------------------------------------------------------------

_P = 2**255 - 19
_A24 = 121665


def _decode_u(u: bytes) -> int:
    # mask the MSB per RFC 7748 §5 u-coordinate decoding
    return int.from_bytes(u[:31] + bytes([u[31] & 0x7F]), "little")


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    """Montgomery ladder scalar multiplication; constant-structure (the
    swap is arithmetic, not a branch), though pure Python makes no real
    timing guarantees."""
    k = _decode_scalar(scalar)
    u = _decode_u(u_bytes) % _P
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * (z3 * z3) % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


_BASE_U = (9).to_bytes(32, "little")


class X25519PrivateKeyRef:
    """API shim matching the slice of ``cryptography``'s X25519PrivateKey
    the SecretConnection uses."""

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 private key must be 32 bytes")
        self._raw = raw

    @classmethod
    def generate(cls) -> "X25519PrivateKeyRef":
        return cls(os.urandom(32))

    def public_key(self) -> "X25519PublicKeyRef":
        return X25519PublicKeyRef(x25519(self._raw, _BASE_U))

    def exchange(self, peer: "X25519PublicKeyRef") -> bytes:
        shared = x25519(self._raw, peer.public_bytes_raw())
        if shared == b"\x00" * 32:
            raise ValueError("X25519 exchange produced a low-order result")
        return shared


class X25519PublicKeyRef:
    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        self._raw = raw

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKeyRef":
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


# ----------------------------------------------------------------------
# ChaCha20 (RFC 8439 §2.3)
# ----------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] ^= st[a]
    st[d] = ((st[d] << 16) | (st[d] >> 16)) & _MASK32
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] ^= st[c]
    st[b] = ((st[b] << 12) | (st[b] >> 20)) & _MASK32
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] ^= st[a]
    st[d] = ((st[d] << 8) | (st[d] >> 24)) & _MASK32
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] ^= st[c]
    st[b] = ((st[b] << 7) | (st[b] >> 25)) & _MASK32


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    st = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        counter & _MASK32,
        *struct.unpack("<3I", nonce),
    ]
    w = st[:]
    for _ in range(10):
        _quarter(w, 0, 4, 8, 12)
        _quarter(w, 1, 5, 9, 13)
        _quarter(w, 2, 6, 10, 14)
        _quarter(w, 3, 7, 11, 15)
        _quarter(w, 0, 5, 10, 15)
        _quarter(w, 1, 6, 11, 12)
        _quarter(w, 2, 7, 8, 13)
        _quarter(w, 3, 4, 9, 14)
    return struct.pack("<16I", *((a + b) & _MASK32 for a, b in zip(w, st)))


def _chacha20_xor_scalar(
    key: bytes, counter: int, nonce: bytes, data: bytes
) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out[i : i + len(chunk)] = bytes(
            x ^ y for x, y in zip(chunk, block)
        )
    return bytes(out)


try:
    import numpy as _np
except ImportError:
    _np = None


def _np_rotl(x, n):
    return (x << _np.uint32(n)) | (x >> _np.uint32(32 - n))


def _np_quarter(st, a, b, c, d):
    st[a] += st[b]
    st[d] ^= st[a]
    st[d] = _np_rotl(st[d], 16)
    st[c] += st[d]
    st[b] ^= st[c]
    st[b] = _np_rotl(st[b], 12)
    st[a] += st[b]
    st[d] ^= st[a]
    st[d] = _np_rotl(st[d], 8)
    st[c] += st[d]
    st[b] ^= st[c]
    st[b] = _np_rotl(st[b], 7)


def _chacha20_xor_np(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    """All of the message's 64-byte blocks in one vectorized pass —
    byte-identical to the scalar path (the differential test pins it)."""
    nblocks = (len(data) + 63) // 64
    st = _np.empty((16, nblocks), dtype=_np.uint32)
    st[0:4] = _np.array(
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], _np.uint32
    )[:, None]
    st[4:12] = _np.frombuffer(key, "<u4")[:, None]
    st[12] = (counter + _np.arange(nblocks, dtype=_np.uint64)).astype(
        _np.uint32
    )
    st[13:16] = _np.frombuffer(nonce, "<u4")[:, None]
    w = st.copy()
    for _ in range(10):
        _np_quarter(w, 0, 4, 8, 12)
        _np_quarter(w, 1, 5, 9, 13)
        _np_quarter(w, 2, 6, 10, 14)
        _np_quarter(w, 3, 7, 11, 15)
        _np_quarter(w, 0, 5, 10, 15)
        _np_quarter(w, 1, 6, 11, 12)
        _np_quarter(w, 2, 7, 8, 13)
        _np_quarter(w, 3, 4, 9, 14)
    w += st
    keystream = w.T.astype("<u4").tobytes()[: len(data)]
    return (
        _np.frombuffer(data, _np.uint8)
        ^ _np.frombuffer(keystream, _np.uint8)
    ).tobytes()


# -- lane-packed bigint ChaCha20 ---------------------------------------
#
# One Python bigint per state word, holding every block's 32-bit lane in
# its own 64-bit slot (value in the low 32 bits, slack above).  CPython
# bigint +/^/<< run in C over all lanes at once, so the 80 quarter-rounds
# cost ~32 bigint ops each regardless of message size — an order of
# magnitude faster than per-op numpy dispatch on small frames.  Carries
# from + stay inside the 64-bit slot (32-bit values + carry < 2^33);
# shift cross-lane contamination lands in the slack and is masked off.

_LANE_CACHE: dict = {}


def _lane_consts(nblocks: int):
    cached = _LANE_CACHE.get(nblocks)
    if cached is None:
        spread = sum(1 << (64 * i) for i in range(nblocks))
        mask = 0xFFFFFFFF * spread
        cached = (spread, mask)
        if len(_LANE_CACHE) < 64:
            _LANE_CACHE[nblocks] = cached
    return cached


def _lane_rotl(x: int, n: int, mask: int) -> int:
    return ((x << n) & mask) | ((x >> (32 - n)) & mask)


def _chacha20_xor_packed(
    key: bytes, counter: int, nonce: bytes, data: bytes
) -> bytes:
    nblocks = (len(data) + 63) // 64
    spread, mask = _lane_consts(nblocks)
    init = [
        c * spread
        for c in (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
        + struct.unpack("<8I", key)
    ]
    init.append(
        sum(((counter + i) & _MASK32) << (64 * i) for i in range(nblocks))
    )
    init += [c * spread for c in struct.unpack("<3I", nonce)]
    w = list(init)
    for _ in range(10):
        for a, b, c, d in (
            (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
        ):
            wa, wb, wc, wd = w[a], w[b], w[c], w[d]
            wa = (wa + wb) & mask
            wd = _lane_rotl(wd ^ wa, 16, mask)
            wc = (wc + wd) & mask
            wb = _lane_rotl(wb ^ wc, 12, mask)
            wa = (wa + wb) & mask
            wd = _lane_rotl(wd ^ wa, 8, mask)
            wc = (wc + wd) & mask
            wb = _lane_rotl(wb ^ wc, 7, mask)
            w[a], w[b], w[c], w[d] = wa, wb, wc, wd
    # serialize: per-word lane extraction (u64 slots -> low u32), then
    # interleave back to block order
    out = _np.empty((nblocks, 16), dtype="<u4")
    size = 8 * nblocks
    for j in range(16):
        word = (w[j] + init[j]) & mask
        out[:, j] = _np.frombuffer(
            word.to_bytes(size, "little"), dtype="<u8"
        ).astype(_np.uint32)
    keystream = out.tobytes()[: len(data)]
    return (
        _np.frombuffer(data, _np.uint8)
        ^ _np.frombuffer(keystream, _np.uint8)
    ).tobytes()


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    if _np is not None and data:
        return _chacha20_xor_packed(key, counter, nonce, data)
    return _chacha20_xor_scalar(key, counter, nonce, data)


# ----------------------------------------------------------------------
# Poly1305 (RFC 8439 §2.5) and the AEAD construction (§2.8)
# ----------------------------------------------------------------------

_P1305 = (1 << 130) - 5


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little")
    r &= 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block + b"\x01", "little")
        acc = (acc + n) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"" if rem == 0 else b"\x00" * (16 - rem)


class InvalidTagRef(Exception):
    """Raised when AEAD authentication fails (``InvalidTag`` analog)."""


class ChaCha20Poly1305Ref:
    """RFC 8439 AEAD with the same encrypt/decrypt API slice as
    ``cryptography``'s ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = key

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = _chacha20_block(self._key, 0, nonce)[:32]
        mac_data = (
            aad + _pad16(aad) + ct + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        aad = aad or b""
        ct = _chacha20_xor(self._key, 1, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        aad = aad or b""
        if len(data) < 16:
            raise InvalidTagRef("ciphertext shorter than the tag")
        ct, tag = data[:-16], data[-16:]
        want = self._tag(nonce, ct, aad)
        # hmac.compare_digest without importing hmac: fixed 16-byte tags
        diff = 0
        for x, y in zip(tag, want):
            diff |= x ^ y
        if diff:
            raise InvalidTagRef("AEAD tag mismatch")
        return _chacha20_xor(self._key, 1, nonce, ct)
