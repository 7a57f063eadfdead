"""In-process kvstore application — the universal test fixture.

Reference: abci/example/kvstore/kvstore.go.  Behavior reproduced:
  * txs are ``key=value`` byte strings; CheckTx rejects anything else;
  * validator updates via ``val:<base64-pubkey>!<power>`` txs;
  * app hash commits to the full state deterministically;
  * Query paths ``/store`` (by key) and ``/val`` (validator power);
  * full-state snapshots served in fixed-size chunks for state sync.

State is a plain dict committed by hashing a canonical serialization —
deterministic across nodes, which is all consensus requires of it.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.abci.application import BaseApplication

VALIDATOR_PREFIX = b"val:"
SNAPSHOT_CHUNK_SIZE = 65536
SNAPSHOT_INTERVAL = 5  # snapshot every K heights (reference: snapshot_interval)
SNAPSHOT_KEEP = 10
APP_VERSION = 1


class KVStoreApplication(BaseApplication):
    def __init__(self, retain_blocks: int = 0):
        self.state: dict[str, str] = {}
        self.validators: dict[str, int] = {}  # b64 pubkey -> power
        self.height = 0
        self.app_hash = self._compute_hash()
        self.retain_blocks = retain_blocks
        self.staged_updates: list[at.ValidatorUpdate] = []
        # Committed snapshots: height -> serialized state
        self._snapshots: dict[int, bytes] = {}
        self._restore_buf: Optional[dict] = None

    # -- state management ---------------------------------------------------

    def _serialize(self) -> bytes:
        return json.dumps(
            {
                "height": self.height,
                "state": self.state,
                "validators": self.validators,
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode()

    def _deserialize(self, data: bytes) -> None:
        doc = json.loads(data.decode())
        self.height = doc["height"]
        self.state = doc["state"]
        self.validators = doc["validators"]
        self.app_hash = self._compute_hash()

    def _compute_hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(struct.pack(">q", getattr(self, "height", 0)))
        for k in sorted(getattr(self, "state", {})):
            h.update(k.encode() + b"\x00" + self.state[k].encode() + b"\x00")
        return h.digest()

    # -- info/query ---------------------------------------------------------

    def info(self, req):
        return at.InfoResponse(
            data=json.dumps({"size": len(self.state)}),
            version="kvstore-tpu",
            app_version=APP_VERSION,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req):
        if req.path == "/val":
            key = req.data.decode(errors="replace")
            power = self.validators.get(key, 0)
            return at.QueryResponse(
                code=at.CODE_TYPE_OK,
                key=req.data,
                value=str(power).encode(),
                height=self.height,
            )
        key = req.data.decode(errors="replace")
        value = self.state.get(key)
        return at.QueryResponse(
            code=at.CODE_TYPE_OK,
            log="exists" if value is not None else "does not exist",
            key=req.data,
            value=value.encode() if value is not None else b"",
            height=self.height,
        )

    # -- mempool ------------------------------------------------------------

    @staticmethod
    def _parse_tx(tx: bytes):
        """Returns ('kv', key, value) | ('val', pubkey_b64, power) | None."""
        if tx.startswith(VALIDATOR_PREFIX):
            body = tx[len(VALIDATOR_PREFIX):]
            parts = body.split(b"!")
            if len(parts) != 2:
                return None
            try:
                pub = parts[0].decode()
                base64.b64decode(pub, validate=True)
                power = int(parts[1])
            except Exception:
                return None
            if power < 0:
                return None
            return ("val", pub, power)
        parts = tx.split(b"=")
        if len(parts) != 2 or not parts[0]:
            return None
        try:
            return ("kv", parts[0].decode(), parts[1].decode())
        except UnicodeDecodeError:
            return None

    def check_tx(self, req):
        if self._parse_tx(req.tx) is None:
            return at.CheckTxResponse(
                code=1, log="invalid tx format (want key=value)"
            )
        return at.CheckTxResponse(code=at.CODE_TYPE_OK, gas_wanted=1)

    # -- consensus ----------------------------------------------------------

    def init_chain(self, req):
        for vu in req.validators:
            self._apply_validator_update(vu)
        if req.app_state_bytes:
            doc = json.loads(req.app_state_bytes.decode())
            self.state.update({str(k): str(v) for k, v in doc.items()})
        self.height = req.initial_height - 1
        self.app_hash = self._compute_hash()
        return at.InitChainResponse(app_hash=self.app_hash)

    def _apply_validator_update(self, vu: at.ValidatorUpdate) -> None:
        key = base64.b64encode(vu.pub_key_bytes).decode()
        if vu.power == 0:
            self.validators.pop(key, None)
        else:
            self.validators[key] = vu.power

    def process_proposal(self, req):
        for tx in req.txs:
            if self._parse_tx(tx) is None:
                return at.ProcessProposalResponse(
                    status=at.PROPOSAL_STATUS_REJECT
                )
        return at.ProcessProposalResponse(status=at.PROPOSAL_STATUS_ACCEPT)

    def finalize_block(self, req):
        tx_results = []
        self.staged_updates = []
        events = []
        for tx in req.txs:
            parsed = self._parse_tx(tx)
            if parsed is None:
                tx_results.append(at.ExecTxResult(code=1, log="invalid tx"))
                continue
            if parsed[0] == "val":
                _, pub, power = parsed
                vu = at.ValidatorUpdate(
                    pub_key_type="ed25519",
                    pub_key_bytes=base64.b64decode(pub),
                    power=power,
                )
                self.staged_updates.append(vu)
                self._apply_validator_update(vu)
                tx_results.append(at.ExecTxResult(code=at.CODE_TYPE_OK))
                continue
            _, key, value = parsed
            self.state[key] = value
            tx_results.append(
                at.ExecTxResult(
                    code=at.CODE_TYPE_OK,
                    gas_used=1,
                    events=[
                        at.Event(
                            type_="app",
                            attributes=[
                                at.EventAttribute("key", key, True),
                                at.EventAttribute("creator", "kvstore", True),
                            ],
                        )
                    ],
                )
            )
        self.height = req.height
        self.app_hash = self._compute_hash()
        return at.FinalizeBlockResponse(
            events=events,
            tx_results=tx_results,
            validator_updates=list(self.staged_updates),
            app_hash=self.app_hash,
        )

    def commit(self, req):
        if self.height % SNAPSHOT_INTERVAL == 0:
            self._snapshots[self.height] = self._serialize()
            for h in sorted(self._snapshots)[:-SNAPSHOT_KEEP]:
                del self._snapshots[h]
        retain = 0
        if self.retain_blocks and self.height > self.retain_blocks:
            retain = self.height - self.retain_blocks
        return at.CommitResponse(retain_height=retain)

    # -- state sync ---------------------------------------------------------

    def list_snapshots(self, req):
        out = []
        for h, data in sorted(self._snapshots.items()):
            nchunks = max(1, -(-len(data) // SNAPSHOT_CHUNK_SIZE))
            out.append(
                at.Snapshot(
                    height=h,
                    format=1,
                    chunks=nchunks,
                    hash=hashlib.sha256(data).digest(),
                )
            )
        return at.ListSnapshotsResponse(snapshots=out)

    def offer_snapshot(self, req):
        if req.snapshot.format != 1:
            return at.OfferSnapshotResponse(
                result=at.OFFER_SNAPSHOT_REJECT_FORMAT
            )
        self._restore_buf = {
            "height": req.snapshot.height,
            "chunks": req.snapshot.chunks,
            "hash": req.snapshot.hash,
            "data": {},
        }
        return at.OfferSnapshotResponse(result=at.OFFER_SNAPSHOT_ACCEPT)

    def load_snapshot_chunk(self, req):
        data = self._snapshots.get(req.height)
        if data is None or req.format != 1:
            return at.LoadSnapshotChunkResponse()
        start = req.chunk * SNAPSHOT_CHUNK_SIZE
        return at.LoadSnapshotChunkResponse(
            chunk=data[start : start + SNAPSHOT_CHUNK_SIZE]
        )

    def apply_snapshot_chunk(self, req):
        if self._restore_buf is None:
            return at.ApplySnapshotChunkResponse(
                result=at.APPLY_SNAPSHOT_CHUNK_ABORT
            )
        self._restore_buf["data"][req.index] = req.chunk
        if len(self._restore_buf["data"]) == self._restore_buf["chunks"]:
            blob = b"".join(
                self._restore_buf["data"][i]
                for i in range(self._restore_buf["chunks"])
            )
            if hashlib.sha256(blob).digest() != self._restore_buf["hash"]:
                self._restore_buf = None
                return at.ApplySnapshotChunkResponse(
                    result=at.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT
                )
            self._deserialize(blob)
            self._snapshots[self.height] = blob
            self._restore_buf = None
        return at.ApplySnapshotChunkResponse(
            result=at.APPLY_SNAPSHOT_CHUNK_ACCEPT
        )
