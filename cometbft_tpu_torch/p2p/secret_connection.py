"""Authenticated-encryption transport wrapper: the SecretConnection.

Counterpart of the JAX package's ``p2p/secret_connection.py`` (reference:
p2p/conn/secret_connection.go:101 MakeSecretConnection, :354
deriveSecrets), with the same construction and wire bytes:

1. exchange 32-byte ephemeral X25519 public keys in the clear;
2. ECDH -> HKDF-SHA256 (64-byte output) -> two ChaCha20-Poly1305 keys,
   ordered by who has the lexically smaller ephemeral key, plus a 32-byte
   challenge binding both ephemerals;
3. exchange AEAD-sealed AuthSig{ed25519 pubkey, sig(challenge)} frames and
   verify them: a station-to-station handshake binding the channel to the
   long-lived node identity.

Every frame is a 4-byte big-endian length of the sealed payload, then the
ciphertext; nonces are 12-byte little-endian counters, one per direction;
plaintext frames are at most 1,024 bytes (reference: dataMaxSize,
secret_connection.go:47).

The data plane: a send flush (``write_frames``) and every complete frame
already in the receive buffer (``read_frame``'s opportunistic batch) are
one pass through ``p2p/transportplane`` (the AEAD kernel on a card), and
the ephemeral key and the ECDH go through ``p2p/handshake_pool`` (the
ladder kernel) when its device pass is live.  Singles and batches under
the plane's minimum take the serial path, the port's ``aead_ref`` (the
port does not use the ``cryptography`` package; the bytes are equal).
``device`` (None: the card, where the gate is open) goes down to both
planes.  ``COMETBFT_TPU_AEAD=0`` and ``COMETBFT_TPU_HANDSHAKE=0`` restore
the serial path outright.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import socket as _socket
import struct
from collections import deque
from typing import Optional, Sequence

from cometbft_tpu_torch.crypto.aead_ref import (
    ChaCha20Poly1305Ref,
    InvalidTagRef,
    X25519PrivateKeyRef,
    X25519PublicKeyRef,
)
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.p2p import handshake_pool, transportplane

DATA_MAX_SIZE = 1024
_HKDF_INFO = b"COMETBFT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class SecretConnectionError(Exception):
    pass


def _hkdf_sha256(secret: bytes, info: bytes, length: int) -> bytes:
    """HKDF (RFC 5869) with SHA-256, empty salt."""
    prk = _hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def derive_secrets(shared: bytes, local_eph: bytes,
                   remote_eph: bytes) -> tuple[bytes, bytes, bytes]:
    """-> (send_key, recv_key, challenge) for this side (reference:
    secret_connection.go:354 deriveSecrets)."""
    lo, hi = sorted((local_eph, remote_eph))
    material = _hkdf_sha256(shared + lo + hi, _HKDF_INFO, 96)
    key_lo, key_hi, challenge = material[:32], material[32:64], material[64:96]
    if local_eph == lo:
        return key_lo, key_hi, challenge
    return key_hi, key_lo, challenge


class _HalfDuplex:
    """One direction of AEAD frames with a counter nonce.  Batches go
    through the transport plane (one pass over the batch at consecutive
    nonces); singles and batches under its minimum take the serial
    per-frame path."""

    def __init__(self, key: bytes, device=None):
        self._key = key
        self.device = device
        self.aead = ChaCha20Poly1305Ref(key)
        self.nonce = 0

    def seal(self, plaintext: bytes) -> bytes:
        n = transportplane.nonce_bytes(self.nonce)
        self.nonce += 1
        return self.aead.encrypt(n, plaintext, None)

    def open(self, ciphertext: bytes) -> bytes:
        n = transportplane.nonce_bytes(self.nonce)
        self.nonce += 1
        try:
            return self.aead.decrypt(n, ciphertext, None)
        except InvalidTagRef as e:
            raise SecretConnectionError("AEAD authentication failed") from e

    def seal_batch(self, plaintexts: "Sequence[bytes]") -> "list[bytes]":
        if transportplane.batch_active(len(plaintexts)):
            start = self.nonce
            self.nonce += len(plaintexts)
            return transportplane.seal_frames(self._key, start, plaintexts,
                                              self.device)
        transportplane.record_serial_frames(len(plaintexts))
        return [self.seal(p) for p in plaintexts]

    def open_batch(self, ciphertexts: "Sequence[bytes]"
                   ) -> "tuple[list[bytes], Optional[SecretConnectionError]]":
        """Verify and decrypt a batch: the authenticated plaintext prefix,
        and the error the serial loop would have raised at the first bad
        frame (None when all verified)."""
        if transportplane.batch_active(len(ciphertexts)):
            start = self.nonce
            self.nonce += len(ciphertexts)
            pts, bad = transportplane.open_frames(self._key, start, ciphertexts,
                                                  self.device)
            err = (None if bad is None
                   else SecretConnectionError("AEAD authentication failed"))
            return pts, err
        transportplane.record_serial_frames(len(ciphertexts))
        out: "list[bytes]" = []
        for c in ciphertexts:
            try:
                out.append(self.open(c))
            except SecretConnectionError as e:
                return out, e
        return out, None


class SecretConnection:
    """Encrypted, authenticated stream over a raw socket-like object.

    ``sock`` needs sendall()/recv().  After the constructor returns, the
    remote's long-lived Ed25519 key is in ``remote_pub_key``.  ``device``
    (None: the card, where the gate is open) is where the handshake's
    ladder and the frames' AEAD run.
    """

    def __init__(self, sock, priv_key: Ed25519PrivKey, device=None):
        self._sock = sock
        self._recv_buf = b""
        # batched receive: plaintexts authenticated ahead of delivery, and
        # the error that ends the stream at the frame where the serial path
        # would have raised it
        self._plain: "deque[bytes]" = deque()
        self._recv_err: Optional[Exception] = None

        # the ephemeral key pair: through the handshake pool, the two
        # ladders of every concurrent dial coalesce into batched passes
        use_pool = handshake_pool.active(device)
        if use_pool:
            eph_raw = os.urandom(32)
            eph_pub = handshake_pool.public_key(eph_raw, device)
        else:
            eph_priv = X25519PrivateKeyRef.generate()
            eph_pub = eph_priv.public_key().public_bytes_raw()

        # 1. exchange ephemerals (plaintext)
        self._send_raw(eph_pub)
        remote_eph = self._recv_exact(32)
        if remote_eph == eph_pub:
            raise SecretConnectionError("remote echoed our ephemeral key")

        # 2. ECDH and the key schedule
        if use_pool:
            shared = handshake_pool.exchange(eph_raw, remote_eph, device)
            if shared == b"\x00" * 32:
                raise ValueError("X25519 exchange produced a low-order result")
        else:
            shared = eph_priv.exchange(
                X25519PublicKeyRef.from_public_bytes(remote_eph))
        send_key, recv_key, challenge = derive_secrets(shared, eph_pub, remote_eph)
        self._send = _HalfDuplex(send_key, device)
        self._recv = _HalfDuplex(recv_key, device)

        # 3. authenticate: swap AEAD-sealed {pubkey, sig(challenge)}
        sig = priv_key.sign(challenge)
        auth = pe.t_bytes(1, priv_key.pub_key().bytes()) + pe.t_bytes(2, sig)
        self.write_frame(auth)
        remote_auth = self.read_frame()
        f = pe.fields_dict(remote_auth)
        remote_pub = bytes(f.get(1, [b""])[-1])
        remote_sig = bytes(f.get(2, [b""])[-1])
        if len(remote_pub) != 32:
            raise SecretConnectionError("bad auth pubkey length")
        pub = Ed25519PubKey(remote_pub)
        if not pub.verify_signature(challenge, remote_sig):
            raise SecretConnectionError("challenge signature verification failed")
        self.remote_pub_key = pub

    # -- framed IO ---------------------------------------------------------

    _MAX_SEALED = DATA_MAX_SIZE + 16 + 64  # data + AEAD tag + slack

    def write_frame(self, data: bytes) -> None:
        self.write_frames([data])

    def write_frames(self, datas: "Sequence[bytes]") -> None:
        """Seal a batch of frames (one pass when the plane is active) and
        write them as ONE sendall: the same wire bytes as per-frame writes,
        in fewer syscalls."""
        if not datas:
            return
        sealed = self._send.seal_batch(list(datas))
        self._send_raw(b"".join(struct.pack(">I", len(s)) + s for s in sealed))

    def read_frame(self) -> bytes:
        if self._plain:
            return self._plain.popleft()
        if self._recv_err is not None:
            raise self._recv_err
        hdr = self._recv_exact(4)
        (n,) = struct.unpack(">I", hdr)
        if n > self._MAX_SEALED:
            raise SecretConnectionError(f"oversized frame {n}")
        frames = [self._recv_exact(n)]
        # opportunistic batch: every COMPLETE frame already in the receive
        # buffer verifies in the same pass (a peer's send flush arrives as
        # one burst and decrypts as one launch)
        buf = self._recv_buf
        pos = 0
        while len(buf) - pos >= 4:
            (m,) = struct.unpack_from(">I", buf, pos)
            if m > self._MAX_SEALED:
                # the frames before it first; the error surfaces at this
                # frame's position, as on the serial path
                self._recv_err = SecretConnectionError(f"oversized frame {m}")
                break
            if len(buf) - pos < 4 + m:
                break
            frames.append(buf[pos + 4 : pos + 4 + m])
            pos += 4 + m
        self._recv_buf = buf[pos:]
        pts, err = self._recv.open_batch(frames)
        if err is not None:
            self._recv_err = err
        self._plain.extend(pts)
        if not self._plain:
            # the batch's first frame failed: raise now; the error stays
            # sticky, since past an authentication failure the nonce
            # stream is dead
            raise self._recv_err
        return self._plain.popleft()

    def write_msg(self, data: bytes) -> None:
        """Length-prefixed message over several frames, in one coalesced
        write."""
        frames = [struct.pack(">I", len(data))]
        for i in range(0, len(data), DATA_MAX_SIZE):
            frames.append(data[i : i + DATA_MAX_SIZE])
        self.write_frames(frames)

    def read_msg(self, max_size: int = 1 << 20) -> bytes:
        hdr = self.read_frame()
        if len(hdr) != 4:
            raise SecretConnectionError("bad message header")
        (n,) = struct.unpack(">I", hdr)
        if n > max_size:
            raise SecretConnectionError(f"message too large: {n}")
        out = b""
        while len(out) < n:
            out += self.read_frame()
        if len(out) != n:
            raise SecretConnectionError("message length mismatch")
        return out

    # -- raw socket helpers ------------------------------------------------

    def _send_raw(self, data: bytes) -> None:
        self._sock.sendall(data)

    def _recv_exact(self, n: int) -> bytes:
        buf = self._recv_buf
        while len(buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise SecretConnectionError("connection closed")
            buf += chunk
        self._recv_buf = buf[n:]
        return buf[:n]

    def settimeout(self, timeout) -> None:
        """Passthrough to the underlying socket (where supported)."""
        if hasattr(self._sock, "settimeout"):
            self._sock.settimeout(timeout)

    def close(self) -> None:
        # shutdown() first: close() alone does not send FIN while another
        # thread is blocked in recv() on the same fd
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
