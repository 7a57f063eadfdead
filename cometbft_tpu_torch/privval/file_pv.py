"""File-based private validator with double-sign protection
(reference: privval/file.go).

Two files: the key file (seed + pubkey + address) and the last-sign-state
file.  The sign state is persisted *before* a signature is released, so a
crashed validator can never sign conflicting votes for the same (H, R, step)
after restart — the core double-sign protection.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.libs import diskguard as _dg
from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.vote import Proposal, Vote

_STEP_PROPOSE = 1
_STEP_PREVOTE = 2
_STEP_PRECOMMIT = 3

_VOTE_STEP = {PREVOTE_TYPE: _STEP_PREVOTE, PRECOMMIT_TYPE: _STEP_PRECOMMIT}


def _strip_timestamp(sign_bytes: bytes) -> tuple[bytes, bytes]:
    """Split canonical sign bytes into (without-timestamp, timestamp-field).

    Canonical votes/proposals carry the timestamp as an embedded message
    field; a restarted node regenerates the same vote with a fresh timestamp,
    which must be treated as a re-sign of the same vote (reference:
    privval/file.go checkVotesOnlyDifferByTimestamp).
    """
    from cometbft_tpu_torch.libs import protoenc as pe

    try:
        _, pos = pe.decode_uvarint(sign_bytes, 0)  # length prefix
        body = sign_bytes[pos:]
        rest = bytearray()
        ts = b""
        # timestamp is field 5 in CanonicalVote, field 6 in CanonicalProposal
        # (type PROPOSAL_TYPE=32 is field 1 of both messages).
        fields = list(pe.iter_fields(body))
        msg_type = fields[0][2] if fields and fields[0][0] == 1 else 0
        ts_field = 6 if msg_type == 32 else 5
        for field, wire, value in fields:
            if field == ts_field and wire == pe.BYTES:
                ts = bytes(value)
                continue
            if wire == pe.VARINT:
                rest += pe.tag(field, wire) + pe.uvarint(value)
            elif wire == pe.BYTES:
                rest += pe.tag(field, wire) + pe.uvarint(len(value)) + value
            elif wire == pe.FIXED64:
                rest += pe.tag(field, wire) + value.to_bytes(8, "little")
            else:
                rest += pe.tag(field, wire) + value.to_bytes(4, "little")
        return bytes(rest), ts
    except (ValueError, IndexError):
        return sign_bytes, b""


class DoubleSignError(Exception):
    pass


class PrivValStateError(_dg.StorageFatal):
    """The last-sign-state file exists but cannot be trusted (torn,
    truncated, or garbage).  This is FAIL-STOP by construction: silently
    falling back to a fresh last-sign state would let a restarted
    validator re-sign a conflicting vote for an (H, R, step) it already
    signed — a double-sign waiting to happen.  The operator must restore
    or explicitly delete the state file."""

    def __init__(self, path: str, err: "BaseException | str"):
        super().__init__("privval", "load", err)
        self.path = path


def _atomic_write(path: str, data: bytes) -> None:
    """Durable sign-state/key write through the diskguard seam (surface
    ``privval``, fail-stop): the write, flush, fsync and rename each halt
    the validator on failure — a signature must never be released on
    unpersisted sign state."""
    _dg.atomic_write("privval", path, data, do_fsync=True)


@dataclass
class _LastSignState:
    height: int = 0
    round_: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if (h,r,s) equals the last signed (possible regign),
        raises on regression (reference: privval/file.go CheckHRS)."""
        if self.height > height:
            raise DoubleSignError(f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round_ > round_:
                raise DoubleSignError("round regression")
            if self.round_ == round_:
                if self.step > step:
                    raise DoubleSignError("step regression")
                if self.step == step:
                    return True
        return False


class FilePV:
    """Reference: privval/file.go FilePV."""

    def __init__(self, priv_key: Ed25519PrivKey, key_path: str, state_path: str):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        self._state = _LastSignState()

    # -- construction / persistence --------------------------------------

    @staticmethod
    def generate(key_path: str, state_path: str) -> "FilePV":
        pv = FilePV(Ed25519PrivKey.generate(), key_path, state_path)
        pv.save()
        return pv

    @staticmethod
    def load(key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            doc = json.load(f)
        priv = Ed25519PrivKey.from_seed(base64.b64decode(doc["priv_key"]["value"]))
        pv = FilePV(priv, key_path, state_path)
        if os.path.exists(state_path):
            # fail-stop on a corrupt or torn state file: a typed error,
            # never a silent fresh-state fallback (see PrivValStateError)
            try:
                with open(state_path) as f:
                    st = json.load(f)
                pv._state = _LastSignState(
                    height=int(st["height"]),
                    round_=int(st["round"]),
                    step=int(st["step"]),
                    signature=base64.b64decode(st.get("signature", "")),
                    sign_bytes=bytes.fromhex(st.get("signbytes", "")),
                )
            except (
                ValueError,
                KeyError,
                TypeError,
                binascii.Error,
            ) as e:
                raise PrivValStateError(state_path, e) from e
        return pv

    @staticmethod
    def load_or_generate(key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            return FilePV.load(key_path, state_path)
        return FilePV.generate(key_path, state_path)

    def save(self) -> None:
        pub = self.priv_key.pub_key()
        key_doc = {
            "address": pub.address().hex().upper(),
            "pub_key": {"type": pub.type_, "value": base64.b64encode(pub.data).decode()},
            "priv_key": {
                "type": self.priv_key.type_,
                "value": base64.b64encode(self.priv_key.seed).decode(),
            },
        }
        _atomic_write(self.key_path, json.dumps(key_doc, indent=2).encode())
        self._save_state()

    def _save_state(self) -> None:
        st = {
            "height": str(self._state.height),
            "round": self._state.round_,
            "step": self._state.step,
            "signature": base64.b64encode(self._state.signature).decode(),
            "signbytes": self._state.sign_bytes.hex(),
        }
        _atomic_write(self.state_path, json.dumps(st, indent=2).encode())

    # -- PrivValidator interface ------------------------------------------

    def pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False):
        """Sign a vote with double-sign protection (reference:
        privval/file.go signVote)."""
        step = _VOTE_STEP[vote.type_]
        same = self._state.check_hrs(vote.height, vote.round_, step)
        sb = vote.sign_bytes(chain_id)

        def sign_ext() -> None:
            # The extension signature is deterministic over the canonical
            # extension sign bytes and carries no double-sign risk of its
            # own, so it is (re)signed on EVERY path — including the
            # idempotent re-sign after a restart, where skipping it would
            # emit a precommit whose extension peers reject (reference
            # privval signs extensions unconditionally).
            if sign_extension and vote.type_ == PRECOMMIT_TYPE and not vote.is_nil():
                vote.extension_signature = self.priv_key.sign(
                    vote.extension_sign_bytes(chain_id)
                )

        if same:
            # Idempotent re-sign: identical sign bytes -> return saved sig;
            # timestamp-only difference -> same vote regenerated after a
            # restart: return the saved signature (and timestamp).
            if sb == self._state.sign_bytes:
                vote.signature = self._state.signature
                sign_ext()
                return
            new_body, _ = _strip_timestamp(sb)
            old_body, old_ts = _strip_timestamp(self._state.sign_bytes)
            if new_body == old_body:
                from cometbft_tpu_torch.types import codec

                if old_ts:
                    vote.timestamp = codec.decode_timestamp(old_ts)
                vote.signature = self._state.signature
                sign_ext()
                return
            raise DoubleSignError(
                f"conflicting vote data at height {vote.height} round {vote.round_}"
            )
        sig = self.priv_key.sign(sb)
        self._state = _LastSignState(
            height=vote.height,
            round_=vote.round_,
            step=step,
            signature=sig,
            sign_bytes=sb,
        )
        self._save_state()  # persist BEFORE releasing the signature
        vote.signature = sig
        sign_ext()

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        same = self._state.check_hrs(
            proposal.height, proposal.round_, _STEP_PROPOSE
        )
        sb = proposal.sign_bytes(chain_id)
        if same:
            if sb == self._state.sign_bytes:
                proposal.signature = self._state.signature
                return
            new_body, _ = _strip_timestamp(sb)
            old_body, old_ts = _strip_timestamp(self._state.sign_bytes)
            if new_body == old_body:
                from cometbft_tpu_torch.types import codec

                if old_ts:
                    proposal.timestamp = codec.decode_timestamp(old_ts)
                proposal.signature = self._state.signature
                return
            raise DoubleSignError("conflicting proposal data")
        sig = self.priv_key.sign(sb)
        self._state = _LastSignState(
            height=proposal.height,
            round_=proposal.round_,
            step=_STEP_PROPOSE,
            signature=sig,
            sign_bytes=sb,
        )
        self._save_state()
        proposal.signature = sig
