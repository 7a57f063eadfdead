"""Key interfaces, the Ed25519 and BLS12-381 implementations and the
key-type registry.

Mirrors the reference seam (crypto/crypto.go:22-52): ``PubKey`` /
``PrivKey`` with 20-byte addresses (SHA-256-truncated for Ed25519 and
BLS12-381, RIPEMD160(SHA256) for secp256k1, ``crypto.secp256k1``).

Single verification runs the port's own code: the pure-Python oracles
(``crypto.ed25519_ref``, ZIP-215; ``crypto.secp256k1``, low-S ECDSA) and,
for BLS12-381, the port's host library behind ``crypto.bls12381`` (the
pairing in C++, built from the repository's sources): the port depends on
no installed crypto library, so it behaves the same on every machine it
runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import bls12381 as _bls
from cometbft_tpu_torch.crypto import ed25519_ref, tmhash
from cometbft_tpu_torch.crypto.secp256k1 import SECP256K1_KEY_TYPE, Secp256k1PubKey

ED25519_KEY_TYPE = "ed25519"
BLS12381_KEY_TYPE = "bls12_381"


@dataclass(frozen=True)
class Ed25519PubKey:
    data: bytes  # 32-byte compressed point

    type_ = ED25519_KEY_TYPE

    def __post_init__(self):
        if len(self.data) != 32:
            raise ValueError("ed25519 pubkey must be 32 bytes")

    def address(self) -> bytes:
        # memoized: address() sits on hot paths (validator lookups, proposer
        # rotation) — bypass the frozen-dataclass setattr via __dict__.
        addr = self.__dict__.get("_addr")
        if addr is None:
            addr = tmhash.sum_truncated(self.data)
            self.__dict__["_addr"] = addr
        return addr

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != 64:
            return False
        return ed25519_ref.verify_zip215(self.data, msg, sig)

    def bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class Ed25519PrivKey:
    seed: bytes  # 32-byte seed

    type_ = ED25519_KEY_TYPE

    @staticmethod
    def generate() -> "Ed25519PrivKey":
        return Ed25519PrivKey(ed25519_ref.generate_seed())

    @staticmethod
    def from_seed(seed: bytes) -> "Ed25519PrivKey":
        return Ed25519PrivKey(seed)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(ed25519_ref.pubkey_from_seed(self.seed))

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self.seed, msg)

    def bytes(self) -> bytes:
        return self.seed


@dataclass(frozen=True)
class Bls12381PubKey:
    """96-byte uncompressed-G1 public key (min-pubkey-size convention).

    Reference: crypto/bls12381/key_bls12381.go:150-216 (blst-backed) and
    const.go PubKeySize = 96; verification in the port's host library
    (``crypto.bls12381.verify``)."""

    data: bytes

    type_ = BLS12381_KEY_TYPE

    def __post_init__(self):
        if len(self.data) != _bls.PUB_KEY_SIZE:
            raise ValueError("bls12_381 pubkey must be 96 bytes")

    def address(self) -> bytes:
        addr = self.__dict__.get("_addr")
        if addr is None:
            addr = tmhash.sum_truncated(self.data)
            self.__dict__["_addr"] = addr
        return addr

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return _bls.verify(self.data, msg, sig)

    def bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class Bls12381PrivKey:
    """32-byte BLS secret scalar (big-endian), reference PrivKey.Bytes."""

    data: bytes

    type_ = BLS12381_KEY_TYPE

    @staticmethod
    def generate() -> "Bls12381PrivKey":
        return Bls12381PrivKey(_bls.sk_to_bytes(_bls.gen_privkey()))

    @staticmethod
    def from_secret(secret: bytes) -> "Bls12381PrivKey":
        """Reference GenPrivKeyFromSecret (key_bls12381.go:66-74)."""
        return Bls12381PrivKey(
            _bls.sk_to_bytes(_bls.gen_privkey_from_secret(secret))
        )

    def _sk(self) -> int:
        sk = _bls.sk_from_bytes(self.data)
        if sk is None:
            raise ValueError("invalid bls12_381 private key bytes")
        return sk

    def pub_key(self) -> Bls12381PubKey:
        return Bls12381PubKey(_bls.pubkey(self._sk()))

    def sign(self, msg: bytes) -> bytes:
        return _bls.sign(self._sk(), msg)

    def bytes(self) -> bytes:
        return self.data


def pub_key_from_type(key_type: str, data: bytes):
    """The public key of ``key_type`` over its encoded bytes (the JAX
    package's registry)."""
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PubKey(data)
    if key_type == SECP256K1_KEY_TYPE:
        return Secp256k1PubKey(data)
    if key_type == BLS12381_KEY_TYPE:
        return Bls12381PubKey(data)
    raise ValueError(f"unsupported key type: {key_type}")


def supported_key_types() -> list[str]:
    """The key types the port has: Ed25519, secp256k1 and BLS12-381."""
    return [ED25519_KEY_TYPE, SECP256K1_KEY_TYPE, BLS12381_KEY_TYPE]
