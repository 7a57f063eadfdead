"""Key interfaces, the Ed25519 implementation and the key-type registry.

Mirrors the reference seam (crypto/crypto.go:22-52): ``PubKey`` /
``PrivKey`` with 20-byte addresses (SHA-256-truncated for Ed25519,
RIPEMD160(SHA256) for secp256k1, ``crypto.secp256k1``).

Single verification runs the port's own pure-Python oracles
(``crypto.ed25519_ref``, ZIP-215; ``crypto.secp256k1``, low-S ECDSA): the
port depends on no host crypto library, so it behaves the same on every
machine it runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import ed25519_ref, tmhash
from cometbft_tpu_torch.crypto.secp256k1 import SECP256K1_KEY_TYPE, Secp256k1PubKey

ED25519_KEY_TYPE = "ed25519"


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
    def from_seed(seed: bytes) -> "Ed25519PrivKey":
        return Ed25519PrivKey(seed)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(ed25519_ref.pubkey_from_seed(self.seed))

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self.seed, msg)

    def bytes(self) -> bytes:
        return self.seed


def pub_key_from_type(key_type: str, data: bytes):
    """The public key of ``key_type`` over its encoded bytes (the JAX
    package's registry without BLS, which the port does not have yet)."""
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PubKey(data)
    if key_type == SECP256K1_KEY_TYPE:
        return Secp256k1PubKey(data)
    raise ValueError(f"unsupported key type: {key_type}")


def supported_key_types() -> list[str]:
    """The key types the port has: Ed25519 and secp256k1."""
    return [ED25519_KEY_TYPE, SECP256K1_KEY_TYPE]
