"""PostgreSQL event sink with the reference's exact table layout.

Reference: state/indexer/sink/psql/psql.go + schema.sql — four tables
(blocks, tx_results, events, attributes) and three views
(event_attributes, block_events, tx_events), identical column names and
uniqueness constraints, so external analytics tooling written against the
reference's schema works unchanged.  Insert semantics match: ON CONFLICT
DO NOTHING block dedup, the implicit ``block.height`` / ``tx.hash`` /
``tx.height`` meta-events, only ``index=True`` attributes recorded, and
the stored ``tx_result`` column is the real protobuf wire encoding of
``cometbft.abci.v1.TxResult``.

Beyond the reference (whose sink returns "not supported" for searches and
expects companions to query the DB directly), this sink also *serves*
``tx_search`` / ``block_search`` from the SQL views, so a node configured
with ``indexer = "psql"`` keeps those RPCs working.

Backend drivers, by the connection string: ``sqlite://<path>`` and
``:memory:`` open ``sqlite3`` (the same schema modulo dialect,
BIGSERIAL/TIMESTAMPTZ/BYTEA -> sqlite equivalents; the SQL the sink issues
is identical); any other string opens PostgreSQL through ``psycopg2``, and
where that module is missing its ``ImportError`` is raised: no string
falls back to sqlite.

The port's copy of the JAX package's ``indexer/psql.py``: the same tables,
views and rows (row ids drawn from the module's ``random``), the
``tx_result`` column encoded through the port's ``rpc/pb_convert``.
"""

from __future__ import annotations

import random
import threading
from datetime import datetime, timezone
from typing import Optional, Sequence

from cometbft_tpu_torch.indexer.kv import TxResult, _indexed_tags  # noqa: F401

BLOCK_HEIGHT_KEY = "block.height"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"

_SCHEMA_PG = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      BIGSERIAL PRIMARY KEY,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid BIGSERIAL PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  index INTEGER NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  tx_hash VARCHAR NOT NULL,
  tx_result BYTEA NOT NULL,
  UNIQUE (block_id, index)
);
CREATE TABLE IF NOT EXISTS events (
  rowid BIGSERIAL PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type VARCHAR NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
   event_id      BIGINT NOT NULL REFERENCES events(rowid),
   key           VARCHAR NOT NULL,
   composite_key VARCHAR NOT NULL,
   value         VARCHAR NULL,
   UNIQUE (event_id, key)
);
"""

# sqlite dialect: BIGSERIAL -> INTEGER (alias of rowid), "index" must be
# quoted, BYTEA -> BLOB, TIMESTAMPTZ -> TEXT.  Views are created
# identically in both dialects.
_SCHEMA_SQLITE = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at TEXT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid INTEGER PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  "index" INTEGER NOT NULL,
  created_at TEXT NOT NULL,
  tx_hash VARCHAR NOT NULL,
  tx_result BLOB NOT NULL,
  UNIQUE (block_id, "index")
);
CREATE TABLE IF NOT EXISTS events (
  rowid INTEGER PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type VARCHAR NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
   event_id      BIGINT NOT NULL REFERENCES events(rowid),
   key           VARCHAR NOT NULL,
   composite_key VARCHAR NOT NULL,
   value         VARCHAR NULL,
   UNIQUE (event_id, key)
);
"""

_VIEWS = """
CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);
CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key, composite_key, value
  FROM blocks JOIN event_attributes ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;
CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value, tx_results.created_at, tx_results.rowid AS tx_rowid
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


def _random_bigserial() -> int:
    return random.getrandbits(62) + 1


class PsqlEventSink:
    """Reference: psql.go EventSink (plus served searches, see module doc)."""

    def __init__(self, conn_str: str, chain_id: str):
        self.chain_id = chain_id
        self._lock = threading.Lock()
        if conn_str.startswith("sqlite://") or conn_str == ":memory:":
            import sqlite3

            path = conn_str.replace("sqlite://", "") or ":memory:"
            self._conn = sqlite3.connect(path, check_same_thread=False)
            self._dialect = "sqlite"
            self._conn.executescript(_SCHEMA_SQLITE + _VIEWS)
        else:
            import psycopg2  # production path; not bundled in test images

            self._conn = psycopg2.connect(conn_str)
            self._dialect = "pg"
            with self._conn, self._conn.cursor() as cur:
                cur.execute(_SCHEMA_PG)
                # postgres has no CREATE VIEW IF NOT EXISTS; use OR REPLACE
                cur.execute(
                    _VIEWS.replace(
                        "CREATE VIEW IF NOT EXISTS", "CREATE OR REPLACE VIEW"
                    )
                )

    # -- SQL helpers --------------------------------------------------------

    def _q(self, sql: str) -> str:
        """Dialect fixups: parameter marker and the reserved ``index``."""
        if self._dialect == "pg":
            return sql.replace("?", "%s")
        return sql

    def _exec(self, sql: str, params: Sequence = ()):  # -> cursor
        cur = self._conn.cursor()
        cur.execute(self._q(sql), tuple(params))
        return cur

    def _commit(self) -> None:
        self._conn.commit()

    # -- indexing (reference: IndexBlockEvents / IndexTxEvents) -------------

    def index_block_events(self, height: int, events) -> None:
        ts = datetime.now(timezone.utc).isoformat()
        with self._lock:
            try:
                cur = self._exec(
                    'SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?',
                    (height, self.chain_id),
                )
                if cur.fetchone() is not None:
                    return  # already indexed; quietly succeed (reference :204)
                block_id = _random_bigserial()
                self._exec(
                    "INSERT INTO blocks (rowid, height, chain_id, created_at)"
                    " VALUES (?, ?, ?, ?)",
                    (block_id, height, self.chain_id, ts),
                )
                self._insert_events(
                    block_id,
                    None,
                    self._with_meta_events(
                        [(BLOCK_HEIGHT_KEY, str(height))], events
                    ),
                )
                self._commit()
            except Exception:
                self._conn.rollback()
                raise

    def index_tx_events(self, txrs: Sequence[TxResult]) -> None:
        ts = datetime.now(timezone.utc).isoformat()
        with self._lock:
            try:
                self._index_tx_events_locked(txrs, ts)
            except Exception:
                # never leave partial inserts in the open transaction for
                # a later unrelated commit to pick up
                self._conn.rollback()
                raise

    def _index_tx_events_locked(self, txrs: Sequence[TxResult], ts) -> None:
        for txr in txrs:
            cur = self._exec(
                "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?",
                (txr.height, self.chain_id),
            )
            row = cur.fetchone()
            if row is None:
                raise LookupError(
                    f"block {txr.height} not indexed before its txs"
                )
            block_id = row[0]
            cur = self._exec(
                'SELECT 1 FROM tx_results WHERE block_id = ? AND "index" = ?',
                (block_id, txr.index),
            )
            if cur.fetchone() is not None:
                continue  # already indexed
            tx_hash = txr.hash.hex().upper()
            tx_id = _random_bigserial()
            self._exec(
                "INSERT INTO tx_results "
                '(rowid, block_id, "index", created_at, tx_hash, tx_result)'
                " VALUES (?, ?, ?, ?, ?, ?)",
                (
                    tx_id,
                    block_id,
                    txr.index,
                    ts,
                    tx_hash,
                    self._wire_tx_result(txr),
                ),
            )
            self._insert_events(
                block_id,
                tx_id,
                self._with_meta_events(
                    [
                        (TX_HASH_KEY, tx_hash),
                        (TX_HEIGHT_KEY, str(txr.height)),
                    ],
                    txr.result.events,
                ),
            )
        self._commit()

    @staticmethod
    def _wire_tx_result(txr: TxResult) -> bytes:
        """Protobuf wire encoding of cometbft.abci.v1.TxResult (the
        reference stores exactly this in the tx_result column)."""
        from cometbft_tpu_torch.proto_gen.cometbft.abci.v1 import (
            types_pb2 as abci_pb,
        )
        from cometbft_tpu_torch.rpc.pb_convert import exec_tx_result_pb

        msg = abci_pb.TxResult(
            height=txr.height, index=txr.index, tx=txr.tx
        )
        msg.result.CopyFrom(exec_tx_result_pb(txr.result))
        return msg.SerializeToString()

    @staticmethod
    def _with_meta_events(meta: list[tuple[str, str]], events):
        """Prepend the implicit meta-events (reference: makeIndexedEvent)."""
        from cometbft_tpu_torch.abci import types as at

        out = []
        for composite, value in meta:
            typ, _, key = composite.partition(".")
            out.append(
                at.Event(
                    type_=typ,
                    attributes=[
                        at.EventAttribute(key=key, value=value, index=True)
                    ],
                )
            )
        return out + list(events or [])

    def _insert_events(self, block_id: int, tx_id, events) -> None:
        for ev in events:
            if not ev.type_:
                continue  # reference skips empty-type events
            event_id = _random_bigserial()
            self._exec(
                "INSERT INTO events (rowid, block_id, tx_id, type)"
                " VALUES (?, ?, ?, ?)",
                (event_id, block_id, tx_id, ev.type_),
            )
            for attr in ev.attributes:
                if not attr.index:
                    continue  # only indexable attributes (reference :165)
                self._exec(
                    "INSERT INTO attributes "
                    "(event_id, key, composite_key, value) VALUES (?, ?, ?, ?)",
                    (
                        event_id,
                        attr.key,
                        f"{ev.type_}.{attr.key}",
                        attr.value,
                    ),
                )

    # -- serving searches (beyond the reference's sink) ---------------------

    def has_block(self, height: int) -> bool:
        with self._lock:
            cur = self._exec(
                "SELECT 1 FROM blocks WHERE height = ? AND chain_id = ?",
                (height, self.chain_id),
            )
            return cur.fetchone() is not None

    def get_tx_by_hash(self, hash_: bytes) -> Optional[TxResult]:
        with self._lock:
            cur = self._exec(
                "SELECT tx_result FROM tx_results WHERE tx_hash = ?",
                (hash_.hex().upper(),),
            )
            row = cur.fetchone()
        return self._decode_tx_result(row[0]) if row else None

    @staticmethod
    def _decode_tx_result(raw: bytes) -> TxResult:
        from cometbft_tpu_torch.abci import types as at
        from cometbft_tpu_torch.proto_gen.cometbft.abci.v1 import (
            types_pb2 as abci_pb,
        )

        msg = abci_pb.TxResult.FromString(bytes(raw))
        events = [
            at.Event(
                type_=e.type,
                attributes=[
                    at.EventAttribute(key=a.key, value=a.value, index=a.index)
                    for a in e.attributes
                ],
            )
            for e in msg.result.events
        ]
        return TxResult(
            height=msg.height,
            index=msg.index,
            tx=msg.tx,
            result=at.ExecTxResult(
                code=msg.result.code,
                data=msg.result.data,
                log=msg.result.log,
                info=msg.result.info,
                gas_wanted=msg.result.gas_wanted,
                gas_used=msg.result.gas_used,
                events=events,
                codespace=msg.result.codespace,
            ),
        )

    def _condition_sql(self, cond, view: str, id_col: str):
        """One query condition -> (sql, params) yielding matching ids."""
        base = f"SELECT DISTINCT {id_col} FROM {view} WHERE composite_key = ?"
        params: list = [cond.tag]
        op = cond.op
        operand = cond.operand
        if op == "EXISTS":
            return base, params
        if op == "CONTAINS":
            # literal-substring semantics (kv indexer parity): escape LIKE
            # wildcards in the operand
            esc = (
                str(operand)
                .replace("\\", "\\\\")
                .replace("%", "\\%")
                .replace("_", "\\_")
            )
            return (
                base + " AND value LIKE ? ESCAPE '\\'",
                params + [f"%{esc}%"],
            )
        if isinstance(operand, (int, float)):
            cast = (
                "CAST(value AS NUMERIC)"
                if self._dialect == "pg"
                else "CAST(value AS REAL)"
            )
            return base + f" AND {cast} {op} ?", params + [operand]
        if op == "=":
            return base + " AND value = ?", params + [str(operand)]
        return base + f" AND value {op} ?", params + [str(operand)]

    def search_block_events(self, query) -> list[int]:
        """block_search served from the sink's SQL views; returns heights."""
        result: Optional[set[int]] = None
        with self._lock:
            for cond in query.conditions:
                sql, params = self._condition_sql(cond, "block_events", "height")
                rows = {r[0] for r in self._exec(sql, params).fetchall()}
                result = rows if result is None else (result & rows)
                if not result:
                    return []
        return sorted(result or set())

    def search_tx_events(self, query) -> list[TxResult]:
        """tx_search served from the sink's SQL views."""
        result: Optional[set[int]] = None
        with self._lock:
            for cond in query.conditions:
                sql, params = self._condition_sql(cond, "tx_events", "tx_rowid")
                rows = {r[0] for r in self._exec(sql, params).fetchall()}
                result = rows if result is None else (result & rows)
                if not result:
                    return []
            out = []
            for rowid in sorted(result or set()):
                cur = self._exec(
                    "SELECT tx_result FROM tx_results WHERE rowid = ?",
                    (rowid,),
                )
                row = cur.fetchone()
                if row:
                    out.append(self._decode_tx_result(row[0]))
        return out

    # -- adapters: the IndexerService drives kv-style index() calls ---------

    def stop(self) -> None:
        self._conn.close()


class PsqlTxIndexerAdapter:
    """kv-indexer-shaped facade over the sink (IndexerService + rpc)."""

    def __init__(self, sink: PsqlEventSink):
        self.sink = sink

    def index(self, height, index, tx, result) -> None:
        self.sink.index_tx_events(
            [TxResult(height=height, index=index, tx=tx, result=result)]
        )

    def index_batch(self, batch) -> None:
        """One sink call (one block SELECT + one commit) for a whole
        drain of tx events — the shape IndexTxEvents is built for."""
        self.sink.index_tx_events(
            [
                TxResult(height=d.height, index=d.index, tx=d.tx,
                         result=d.result)
                for d in batch
            ]
        )

    def get(self, hash_: bytes):
        return self.sink.get_tx_by_hash(hash_)

    def search(self, query):
        return self.sink.search_tx_events(query)

    def prune(self, retain_height: int) -> int:
        # Reference leaves psql pruning to the operator/companion (the
        # sink is append-only analytics storage).
        return 0


class PsqlBlockIndexerAdapter:
    """kv-block-indexer-shaped facade over the sink."""

    def __init__(self, sink: PsqlEventSink):
        self.sink = sink

    def index(self, height, events) -> None:
        self.sink.index_block_events(height, events)

    def search(self, query):
        return self.sink.search_block_events(query)

    def prune(self, retain_height: int) -> int:
        return 0
