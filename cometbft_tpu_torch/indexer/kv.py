"""KV event indexers (reference: state/txindex/kv/kv.go and
state/indexer/block/kv/kv.go).

Compound keys make range queries a prefix scan:
  tx primary   ``txh/<hash>``                          -> TxResult record
  tx event     ``txe/<tag>/<value>/<height>/<index>``  -> tx hash
  block event  ``bhe/<tag>/<value>/<height>``          -> b""

Search evaluates a query's conditions as index scans and intersects the
candidate sets (the reference's approach for its compound keyspace).

The port's copy of the JAX package's ``indexer/kv.py``: the same rows,
byte for byte, and the same results, order and pages for every query.
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass, field
from itertools import islice
from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs.pubsub import Query

_TX_PRIMARY = b"txh/"
_TX_EVENT = b"txe/"
_BLOCK_EVENT = b"bhe/"

TX_HASH_TAG = "tx.hash"
TX_HEIGHT_TAG = "tx.height"
BLOCK_HEIGHT_TAG = "block.height"


def migrate_legacy_index(chain_db, index_db, chunk: int = 4096) -> int:
    """Move KV index entries out of the shared chain db into the
    dedicated index db (the surfaces split when the indexer became
    degradable while chain.db stayed fail-stop: docs/storage-robustness.md).
    Pre-split nodes left ``txh/``/``txe/``/``bhe/`` keys in chain.db;
    without this, tx_search/block_search silently lose every pre-split
    height.  Idempotent and crash-resumable: each boot moves whatever
    legacy keys remain (three cheap range probes once drained).  Returns
    the number of rows moved."""
    moved = 0
    for prefix in (_TX_PRIMARY, _TX_EVENT, _BLOCK_EVENT):
        # upper bound: prefix with its last byte incremented — key bodies
        # may contain 0xff (raw tx hashes), so ``prefix + b"\xff"`` would
        # clip the tail of the range
        end = prefix[:-1] + bytes([prefix[-1] + 1])
        # paged stream (snapshot=False) keeps boot memory bounded however
        # large the legacy index; deleting a consumed chunk never
        # disturbs the scan — it only removes keys the cursor is past
        it = chain_db.iterate(prefix, end, snapshot=False)
        while True:
            part = list(islice(it, chunk))
            if not part:
                break
            # copy INTO the index db before deleting from chain.db so a
            # crash between the two leaves duplicates (harmless: same
            # bytes), never lost index entries.  The delete runs under
            # the DEGRADABLE indexer policy even though the file is the
            # fail-stop chain db: the rows are index data, and a failed
            # cleanup must count a drop and resume next boot — not latch
            # the storage-fatal flag on a node that then keeps running
            index_db.write_batch(part, [])
            chain_db.write_batch(
                [], [k for k, _ in part], surface="indexer"
            )
            moved += len(part)
    return moved


@dataclass
class TxResult:
    """Reference: abci/types.TxResult + rpc ResultTx shape."""

    height: int
    index: int
    tx: bytes
    result: at.ExecTxResult

    @property
    def hash(self) -> bytes:
        return tmhash.sum256(self.tx)

    def to_json(self) -> dict:
        return {
            "hash": self.hash.hex().upper(),
            "height": str(self.height),
            "index": self.index,
            "tx_result": {
                "code": self.result.code,
                "data": base64.b64encode(self.result.data).decode(),
                "log": self.result.log,
                "gas_wanted": str(self.result.gas_wanted),
                "gas_used": str(self.result.gas_used),
                "events": [
                    {
                        "type": e.type_,
                        "attributes": [
                            {
                                "key": a.key,
                                "value": a.value,
                                "index": a.index,
                            }
                            for a in e.attributes
                        ],
                    }
                    for e in self.result.events
                ],
                "codespace": self.result.codespace,
            },
            "tx": base64.b64encode(self.tx).decode(),
        }

    def encode(self) -> bytes:
        import json

        ev = [
            {
                "type": e.type_,
                "attributes": [
                    {"key": a.key, "value": a.value, "index": a.index}
                    for a in e.attributes
                ],
            }
            for e in self.result.events
        ]
        doc = {
            "height": self.height,
            "index": self.index,
            "tx": base64.b64encode(self.tx).decode(),
            "result": {
                "code": self.result.code,
                "data": base64.b64encode(self.result.data).decode(),
                "log": self.result.log,
                "gas_wanted": self.result.gas_wanted,
                "gas_used": self.result.gas_used,
                "events": ev,
                "codespace": self.result.codespace,
            },
        }
        return json.dumps(doc, sort_keys=True).encode()

    @staticmethod
    def decode(raw: bytes) -> "TxResult":
        import json

        doc = json.loads(raw.decode())
        r = doc["result"]
        return TxResult(
            height=doc["height"],
            index=doc["index"],
            tx=base64.b64decode(doc["tx"]),
            result=at.ExecTxResult(
                code=r["code"],
                data=base64.b64decode(r["data"]),
                log=r["log"],
                gas_wanted=r["gas_wanted"],
                gas_used=r["gas_used"],
                events=[
                    at.Event(
                        type_=e["type"],
                        attributes=[
                            at.EventAttribute(
                                a["key"], a["value"], a["index"]
                            )
                            for a in e["attributes"]
                        ],
                    )
                    for e in r["events"]
                ],
                codespace=r["codespace"],
            ),
        )


def _event_key(prefix: bytes, tag: str, value: str, height: int, index: int = -1) -> bytes:
    key = (
        prefix
        + tag.encode()
        + b"/"
        + value.encode()
        + b"/"
        + struct.pack(">q", height)
    )
    if index >= 0:
        key += struct.pack(">I", index)
    return key


def _indexed_tags(events) -> list[tuple[str, str]]:
    """(tag, value) pairs for attributes flagged index=True
    (reference: kv.go indexEvents honors the Index flag)."""
    out = []
    for ev in events or []:
        for attr in ev.attributes:
            if attr.index and attr.key:
                out.append((f"{ev.type_}.{attr.key}", attr.value))
    return out


class KVTxIndexer:
    """Reference: state/txindex/kv/kv.go TxIndex."""

    def __init__(self, db):
        self._db = db

    def index(self, height: int, index: int, tx: bytes, result: at.ExecTxResult):
        rec = TxResult(height=height, index=index, tx=tx, result=result)
        h = rec.hash
        sets = [(_TX_PRIMARY + h, rec.encode())]
        # implicit tags
        sets.append(
            (_event_key(_TX_EVENT, TX_HEIGHT_TAG, str(height), height, index), h)
        )
        for tag, value in _indexed_tags(result.events):
            sets.append((_event_key(_TX_EVENT, tag, value, height, index), h))
        self._db.write_batch(sets, [])

    def prune(self, retain_height: int) -> int:
        """Drop all tx index entries below ``retain_height`` (background
        pruner; reference: state/txindex pruning via state/pruner.go).
        Returns the number of transactions un-indexed."""
        event_deletes: list[bytes] = []
        primary_candidates: set[bytes] = set()
        for key, val in self._db.iterate(_TX_EVENT, _TX_EVENT + b"\xff"):
            # key tail: 8-byte big-endian height + 4-byte index
            if len(key) < 12:
                continue
            height = struct.unpack(">q", key[-12:-4])[0]
            if height < retain_height:
                event_deletes.append(key)
                if val:
                    primary_candidates.add(val)
        # Only drop a primary record if its (latest) indexed height is
        # itself below the retain height — the same tx bytes may have been
        # re-committed at a higher height, overwriting the record.
        primary_deletes = []
        for h in sorted(primary_candidates):
            rec = self.get(h)
            if rec is not None and rec.height < retain_height:
                primary_deletes.append(_TX_PRIMARY + h)
        if event_deletes or primary_deletes:
            self._db.write_batch([], event_deletes + primary_deletes)
        return len(primary_deletes)

    def get(self, hash_: bytes) -> Optional[TxResult]:
        raw = self._db.get(_TX_PRIMARY + hash_)
        return TxResult.decode(raw) if raw else None

    def search(self, query: Query) -> list[TxResult]:
        """Intersect per-condition candidate hash sets (reference:
        kv.go Search)."""
        result_set: Optional[set[bytes]] = None
        for cond in query.conditions:
            if cond.tag == TX_HASH_TAG and cond.op == "=":
                h = bytes.fromhex(str(cond.operand))
                cands = {h} if self._db.get(_TX_PRIMARY + h) else set()
            else:
                cands = self._scan_condition(cond)
            result_set = cands if result_set is None else (result_set & cands)
            if not result_set:
                return []
        out = []
        for h in result_set or set():
            rec = self.get(h)
            if rec is not None:
                out.append(rec)
        out.sort(key=lambda r: (r.height, r.index))
        return out

    def _scan_condition(self, cond) -> set[bytes]:
        prefix = _TX_EVENT + cond.tag.encode() + b"/"
        out: set[bytes] = set()
        for key, val in self._db.iterate(prefix, prefix + b"\xff"):
            # key layout: prefix + value + "/" + height(8) + index(4)
            body = key[len(prefix) : -12]
            value = body[:-1].decode(errors="replace")  # strip trailing "/"
            if _match_value(cond, value):
                out.add(bytes(val))
        return out


class KVBlockIndexer:
    """Reference: state/indexer/block/kv/kv.go BlockerIndexer."""

    def __init__(self, db):
        self._db = db

    def index(self, height: int, events) -> None:
        sets = [
            (
                _event_key(_BLOCK_EVENT, BLOCK_HEIGHT_TAG, str(height), height),
                b"",
            )
        ]
        for tag, value in _indexed_tags(events):
            sets.append((_event_key(_BLOCK_EVENT, tag, value, height), b""))
        self._db.write_batch(sets, [])

    def prune(self, retain_height: int) -> int:
        """Drop all block index entries below ``retain_height``."""
        deletes: list[bytes] = []
        for key, _val in self._db.iterate(_BLOCK_EVENT, _BLOCK_EVENT + b"\xff"):
            if len(key) < 8:
                continue
            height = struct.unpack(">q", key[-8:])[0]
            if height < retain_height:
                deletes.append(key)
        if deletes:
            self._db.write_batch([], deletes)
        return len(deletes)

    def search(self, query: Query) -> list[int]:
        result_set: Optional[set[int]] = None
        for cond in query.conditions:
            cands = self._scan_condition(cond)
            result_set = cands if result_set is None else (result_set & cands)
            if not result_set:
                return []
        return sorted(result_set or set())

    def _scan_condition(self, cond) -> set[int]:
        prefix = _BLOCK_EVENT + cond.tag.encode() + b"/"
        out: set[int] = set()
        for key, _val in self._db.iterate(prefix, prefix + b"\xff"):
            body = key[len(prefix) :]
            value = body[:-9].decode(errors="replace")  # strip "/"+height(8)
            height = struct.unpack(">q", body[-8:])[0]
            if _match_value(cond, value):
                out.add(height)
        return out


def _match_value(cond, value: str) -> bool:
    if cond.op == "EXISTS":
        return True
    if cond.op == "=":
        if isinstance(cond.operand, (int, float)):
            try:
                return float(value) == float(cond.operand)
            except ValueError:
                return False
        return value == str(cond.operand)
    if cond.op == "CONTAINS":
        return str(cond.operand) in value
    try:
        fv, fo = float(value), float(cond.operand)
    except (TypeError, ValueError):
        return False
    return (
        (cond.op == "<" and fv < fo)
        or (cond.op == "<=" and fv <= fo)
        or (cond.op == ">" and fv > fo)
        or (cond.op == ">=" and fv >= fo)
    )
