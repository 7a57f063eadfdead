"""Merkle proof-operator chains: multi-tree proof composition for ABCI
queries.

Reference: crypto/merkle/proof_op.go (ProofOperator/ProofOperators/
ProofRuntime), proof_value.go (the "simple:v" value op), and
proof_key_path.go (the /App/IBC/x:0102 key-path encoding).  An ABCI app
proves a key under its own store tree, whose root is itself a leaf of a
higher tree; the runtime walks the chain, consuming one key-path segment
per keyed operator, and checks the final root.

Wire format: ProofOp/ProofOps/ValueOp exactly as
proto/cometbft/crypto/v1/proof.proto, via libs/protoenc.

The port's copy of the JAX package's ``crypto/proof_op.py``, on the port's
own ``crypto/merkle``, ``crypto/tmhash`` and ``libs/protoenc``: the same
``ProofOps`` bytes, verdicts and error class.  It keeps the JAX file's two
fixes: a chain whose operators produce no root is refused
(``ProofOperators.verify``), and an absence proof runs with an empty
argument list (``verify_absence``).
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.libs import protoenc as pe

PROOF_OP_VALUE = "simple:v"

KEY_ENCODING_URL = 0
KEY_ENCODING_HEX = 1


class ProofError(ValueError):
    """Invalid proof, key path, or operator chain."""


# ---------------------------------------------------------------------------
# Key paths (proof_key_path.go): "/App/x:010203" — URL or hex segments.
# ---------------------------------------------------------------------------


class KeyPath:
    def __init__(self) -> None:
        self._parts: list[str] = []

    def append_key(self, key: bytes, enc: int = KEY_ENCODING_URL) -> "KeyPath":
        if enc == KEY_ENCODING_URL:
            self._parts.append(urllib.parse.quote(key.decode("utf-8"), safe=""))
        elif enc == KEY_ENCODING_HEX:
            self._parts.append("x:" + key.hex())
        else:
            raise ProofError(f"unknown key encoding {enc}")
        return self

    def __str__(self) -> str:
        return "/" + "/".join(self._parts)


def key_path_to_keys(path: str) -> list[bytes]:
    """Decode "/seg/seg/x:hex" into raw keys (proof_key_path.go:89-113)."""
    if not path or not path.startswith("/"):
        raise ProofError(f"key path {path!r} must start with '/'")
    out = []
    for part in path[1:].split("/"):
        if part.startswith("x:"):
            hexpart = part[2:]
            try:
                out.append(bytes.fromhex(hexpart))
            except ValueError as e:
                raise ProofError(f"bad hex segment {part!r}: {e}") from e
        else:
            out.append(urllib.parse.unquote(part).encode("utf-8"))
    return out


# ---------------------------------------------------------------------------
# Wire types (proto/cometbft/crypto/v1/proof.proto)
# ---------------------------------------------------------------------------


@dataclass
class ProofOp:
    type: str
    key: bytes
    data: bytes

    def encode(self) -> bytes:
        return (
            pe.t_string(1, self.type) + pe.t_bytes(2, self.key)
            + pe.t_bytes(3, self.data)
        )

    @staticmethod
    def decode(raw: bytes) -> "ProofOp":
        f = pe.fields_dict(raw)
        return ProofOp(
            type=(f.get(1, [b""])[0]).decode("utf-8"),
            key=f.get(2, [b""])[0],
            data=f.get(3, [b""])[0],
        )


@dataclass
class ProofOps:
    ops: list = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(pe.t_message(1, op.encode(), always=True) for op in self.ops)

    @staticmethod
    def decode(raw: bytes) -> "ProofOps":
        f = pe.fields_dict(raw)
        return ProofOps(ops=[ProofOp.decode(x) for x in f.get(1, [])])


def _encode_proof(p: merkle.Proof) -> bytes:
    out = pe.t_varint(1, p.total) + pe.t_varint(2, p.index)
    out += pe.t_bytes(3, p.leaf_hash)
    for a in p.aunts:
        out += pe.t_bytes(4, a)
    return out


def _decode_proof(raw: bytes) -> merkle.Proof:
    f = pe.fields_dict(raw)
    return merkle.Proof(
        total=pe.to_int64(f.get(1, [0])[0]),
        index=pe.to_int64(f.get(2, [0])[0]),
        leaf_hash=f.get(3, [b""])[0],
        aunts=list(f.get(4, [])),
    )


# ---------------------------------------------------------------------------
# ValueOp (proof_value.go): proves value under key in a SimpleMap tree.
# ---------------------------------------------------------------------------


def _encode_byte_slice(b: bytes) -> bytes:
    return pe.uvarint(len(b)) + b


@dataclass
class ValueOp:
    key: bytes
    proof: merkle.Proof

    def get_key(self) -> bytes:
        return self.key

    def run(self, args: Sequence[bytes]) -> list[bytes]:
        """value -> SimpleMap root (proof_value.go:88-115): the leaf is
        leafHash(len-prefixed key || len-prefixed sha256(value))."""
        if len(args) != 1:
            raise ProofError(f"value op expects 1 arg, got {len(args)}")
        vhash = tmhash.sum256(args[0])
        kv = _encode_byte_slice(self.key) + _encode_byte_slice(vhash)
        kvhash = merkle._leaf_hash(kv)
        if kvhash != self.proof.leaf_hash:
            raise ProofError(
                f"leaf {kvhash.hex()} != proof leaf {self.proof.leaf_hash.hex()}"
            )
        root = merkle._compute_root(
            self.proof.leaf_hash, self.proof.index, self.proof.total,
            list(self.proof.aunts),
        )
        if root is None:
            raise ProofError("proof does not compute a root")
        return [root]

    def proof_op(self) -> ProofOp:
        data = pe.t_bytes(1, self.key) + pe.t_message(
            2, _encode_proof(self.proof), always=True
        )
        return ProofOp(type=PROOF_OP_VALUE, key=self.key, data=data)


def value_op_decoder(pop: ProofOp) -> ValueOp:
    if pop.type != PROOF_OP_VALUE:
        raise ProofError(f"unexpected op type {pop.type!r}")
    f = pe.fields_dict(pop.data)
    proof_raw = f.get(2, [b""])[0]
    return ValueOp(key=pop.key, proof=_decode_proof(proof_raw))


# ---------------------------------------------------------------------------
# ProofOperators / ProofRuntime (proof_op.go:36-118, 151-157)
# ---------------------------------------------------------------------------


class ProofOperators(list):
    """Chain of operators applied in order; keyed operators consume
    key-path segments from the END of the path (innermost tree first)."""

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: str, args: Sequence[bytes]) -> None:
        if len(self) == 0:
            raise ProofError("no proof operators")
        keys = key_path_to_keys(keypath)
        for i, op in enumerate(self):
            key = op.get_key()
            if key:
                if not keys:
                    raise ProofError(
                        f"key path exhausted but op #{i} wants {key!r}"
                    )
                if keys[-1] != key:
                    raise ProofError(
                        f"key mismatch on op #{i}: path has {keys[-1]!r}, "
                        f"op has {key!r}"
                    )
                keys.pop()
            args = op.run(args)
        if not args:
            raise ProofError("proof operators produced no root")
        if args[0] != root:
            raise ProofError(f"computed root {args[0].hex()}, want {root.hex()}")
        if keys:
            raise ProofError("merkle: keypath not consumed")


class ProofRuntime:
    def __init__(self) -> None:
        self._decoders: dict[str, Callable[[ProofOp], object]] = {}

    def register_op_decoder(self, typ: str, dec) -> None:
        if typ in self._decoders:
            raise ProofError(f"already registered for type {typ!r}")
        self._decoders[typ] = dec

    def decode(self, pop: ProofOp):
        dec = self._decoders.get(pop.type)
        if dec is None:
            raise ProofError(f"unrecognized proof type {pop.type!r}")
        return dec(pop)

    def decode_proof(self, proof: ProofOps) -> ProofOperators:
        return ProofOperators(self.decode(pop) for pop in proof.ops)

    def verify_value(
        self, proof: ProofOps, root: bytes, keypath: str, value: bytes
    ) -> None:
        self.decode_proof(proof).verify(root, keypath, [value])

    def verify_absence(
        self, proof: ProofOps, root: bytes, keypath: str
    ) -> None:
        """Verify a proof of non-existence (empty args; proof_op.go:137).

        The arg list must be EMPTY, not ``[b""]``: an existence proof of an
        empty stored value verifies against ``[b""]``, which would let it
        masquerade as an absence proof (inverted safety semantics)."""
        self.decode_proof(proof).verify(root, keypath, [])


def default_proof_runtime() -> ProofRuntime:
    """Knows value proofs only, like the reference (proof_op.go:151-157)."""
    prt = ProofRuntime()
    prt.register_op_decoder(PROOF_OP_VALUE, value_op_decoder)
    return prt


# ---------------------------------------------------------------------------
# SimpleMap-style helper: build a keyed tree + per-key ValueOps, the shape
# ABCI apps return from Query(prove=true) (reference merkle.SimpleProofsFromMap)
# ---------------------------------------------------------------------------


def proofs_from_map(kvs: dict) -> tuple[bytes, dict]:
    """root hash + {key: ValueOp} for a map of key -> value, with leaves
    len-prefixed(key)||len-prefixed(sha256(value)) in sorted-key order."""
    items = sorted(kvs.items())
    leaves = [
        _encode_byte_slice(k) + _encode_byte_slice(tmhash.sum256(v))
        for k, v in items
    ]
    root, proofs = merkle.proofs_from_byte_slices(leaves)
    return root, {
        k: ValueOp(key=k, proof=pf) for (k, _), pf in zip(items, proofs)
    }
