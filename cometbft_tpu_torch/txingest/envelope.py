"""Signed-transaction envelope codec (docs/tx-ingest.md).

A fixed-layout, prefix-tagged wrapper any app payload can ride in:

    magic(4) | key_type(1) | nonce(8, BE) | pubkey(32|33) | sig(64) | payload

``key_type`` 0x01 is ed25519 (32-byte pubkey — rides the TPU verify
seam), 0x02 is secp256k1 (33-byte compressed pubkey — host/device ECDSA
path).  The signature covers a domain-separated preimage (``sign_bytes``)
binding key type, sender pubkey, nonce and payload, so an envelope can't
be replayed under a different key or nonce without re-signing.

The canonical CheckTx rejection responses live here too: the
``SigVerifyingApp`` middleware (app side) and the ingest coalescer's
mempool pre-verification (node side) both reject through
``reject_bad_envelope`` / ``reject_bad_signature``, which is what makes
batched admission byte-identical to the per-tx path — same codes, same
codespace, same log strings, whichever layer catches the forgery first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from cometbft_tpu_torch.abci import types as at

# First byte deliberately non-ASCII: no key=value style app payload — nor
# any UTF-8 text — starts with 0xD7, so plain txs can never be mistaken
# for an envelope.
MAGIC = b"\xd7TX1"

KEY_ED25519 = 0x01
KEY_SECP256K1 = 0x02

_PUB_LEN = {KEY_ED25519: 32, KEY_SECP256K1: 33}
_KEY_NAMES = {KEY_ED25519: "ed25519", KEY_SECP256K1: "secp256k1"}
SIG_LEN = 64
_NONCE_LEN = 8
_HEADER_LEN = len(MAGIC) + 1 + _NONCE_LEN

_DOMAIN = b"cometbft-tpu/tx/v1"

CODESPACE = "txingest"
CODE_BAD_ENVELOPE = 101
CODE_BAD_SIGNATURE = 102
CODE_STALE_NONCE = 103


class EnvelopeError(Exception):
    """Malformed envelope bytes (magic present, structure invalid)."""


@dataclass(frozen=True)
class Envelope:
    key_type: int
    pubkey: bytes
    nonce: int
    payload: bytes
    signature: bytes

    def sign_bytes(self) -> bytes:
        return sign_bytes(self.key_type, self.pubkey, self.nonce, self.payload)

    def pub_key(self):
        """The typed key object (``crypto.keys``) for this sender."""
        from cometbft_tpu_torch.crypto import keys as ck

        if self.key_type == KEY_ED25519:
            return ck.Ed25519PubKey(self.pubkey)
        from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PubKey

        return Secp256k1PubKey(self.pubkey)


def sign_bytes(key_type: int, pubkey: bytes, nonce: int, payload: bytes) -> bytes:
    return b"".join(
        (
            _DOMAIN,
            bytes([key_type]),
            nonce.to_bytes(_NONCE_LEN, "big"),
            pubkey,
            payload,
        )
    )


def is_envelope(tx: bytes) -> bool:
    return tx.startswith(MAGIC)


def encode(env: Envelope) -> bytes:
    if env.key_type not in _PUB_LEN:
        raise EnvelopeError(f"unknown key type {env.key_type:#x}")
    if len(env.pubkey) != _PUB_LEN[env.key_type]:
        raise EnvelopeError(
            f"{_KEY_NAMES[env.key_type]} pubkey must be "
            f"{_PUB_LEN[env.key_type]} bytes"
        )
    if len(env.signature) != SIG_LEN:
        raise EnvelopeError(f"signature must be {SIG_LEN} bytes")
    if not 0 <= env.nonce < 1 << (8 * _NONCE_LEN):
        raise EnvelopeError("nonce out of range")
    return b"".join(
        (
            MAGIC,
            bytes([env.key_type]),
            env.nonce.to_bytes(_NONCE_LEN, "big"),
            env.pubkey,
            env.signature,
            env.payload,
        )
    )


def decode(tx: bytes) -> Envelope:
    """Parse envelope bytes; raises ``EnvelopeError`` on any structural
    problem.  Callers gate on ``is_envelope`` first — a tx without the
    magic prefix is a plain app tx, not a malformed envelope."""
    if not is_envelope(tx):
        raise EnvelopeError("missing envelope magic")
    if len(tx) < _HEADER_LEN + 1:
        raise EnvelopeError("truncated envelope header")
    key_type = tx[len(MAGIC)]
    pub_len = _PUB_LEN.get(key_type)
    if pub_len is None:
        raise EnvelopeError(f"unknown key type {key_type:#x}")
    nonce = int.from_bytes(tx[len(MAGIC) + 1 : _HEADER_LEN], "big")
    body = tx[_HEADER_LEN:]
    if len(body) < pub_len + SIG_LEN:
        raise EnvelopeError("truncated envelope body")
    return Envelope(
        key_type=key_type,
        pubkey=body[:pub_len],
        nonce=nonce,
        payload=body[pub_len + SIG_LEN :],
        signature=body[pub_len : pub_len + SIG_LEN],
    )


def sign_tx(priv_key, payload: bytes, nonce: int = 0) -> bytes:
    """Build signed envelope bytes for ``payload`` under ``priv_key``
    (``Ed25519PrivKey`` or ``Secp256k1PrivKey``)."""
    from cometbft_tpu_torch.crypto import keys as ck

    key_type = (
        KEY_ED25519
        if getattr(priv_key, "type_", None) == ck.ED25519_KEY_TYPE
        else KEY_SECP256K1
    )
    pub = priv_key.pub_key().bytes()
    sig = priv_key.sign(sign_bytes(key_type, pub, nonce, payload))
    return encode(
        Envelope(
            key_type=key_type,
            pubkey=pub,
            nonce=nonce,
            payload=payload,
            signature=sig,
        )
    )


# -- canonical rejections ----------------------------------------------------


def reject_bad_envelope(reason: str) -> at.CheckTxResponse:
    return at.CheckTxResponse(
        code=CODE_BAD_ENVELOPE,
        log=f"malformed tx envelope: {reason}",
        codespace=CODESPACE,
    )


def reject_bad_signature() -> at.CheckTxResponse:
    return at.CheckTxResponse(
        code=CODE_BAD_SIGNATURE,
        log="invalid tx envelope signature",
        codespace=CODESPACE,
    )


def reject_stale_nonce(nonce: int, last_seen: int) -> at.CheckTxResponse:
    return at.CheckTxResponse(
        code=CODE_STALE_NONCE,
        log=f"stale envelope nonce {nonce} (last seen {last_seen})",
        codespace=CODESPACE,
    )


# -- batched verification ----------------------------------------------------


def verify_envelopes(envs: Sequence[Optional[Envelope]]) -> "list[bool]":
    """Batch-verify envelope signatures on the crypto seam: ed25519
    entries ride the verifysched BULK class (shed entries degrade to a
    per-item synchronous host verify — shedding costs the batching win,
    never a verdict), secp256k1 entries verify on their own host/device
    path, and every verdict goes through the signature cache so the
    apply-time re-check (middleware, process-proposal) is near-free.
    ``None`` entries (non-envelope or malformed txs the caller already
    classified) come back ``False`` placeholders."""
    idx = [i for i, e in enumerate(envs) if e is not None]
    out = [False] * len(envs)
    if not idx:
        return out
    from cometbft_tpu_torch import verifysched

    with verifysched.priority_class(verifysched.PRIO_MEMPOOL):
        bits = verifysched.verify_many_cached(
            [envs[i].pub_key() for i in idx],
            [envs[i].sign_bytes() for i in idx],
            [envs[i].signature for i in idx],
            priority=verifysched.PRIO_MEMPOOL,
        )
    for i, b in zip(idx, bits):
        out[i] = bool(b)
    return out
