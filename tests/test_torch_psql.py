"""The port's ``indexer/psql.py`` held to the JAX package's.

- The same block and tx events, drawn from one ``random.Random`` seed
  (indexed and unindexed attributes, an empty event type, numbers, LIKE
  wildcards, a duplicate block and a duplicate tx), go into a JAX sink and
  a port sink on ``sqlite3``: every table and view dumps to equal rows
  (the module ``random`` seeded alike before each sink, ``created_at``
  from one fixed clock), the stored ``tx_result`` bytes are equal, and the
  same ``block_search`` and ``tx_search`` queries give equal answers.
- A connection string that is not ``sqlite://`` or ``:memory:`` imports
  ``psycopg2`` in both; where it is missing, both raise ``ImportError``
  (here it is made missing, so the case runs alike on every machine).
- A port node with ``tx_index.indexer = "psql"`` on a sqlite file commits
  txs; then ``cmd reindex-event`` of each package on a copy of its stopped
  home rebuilds an empty sink file, and the two files dump equal.

Tolerance: exact rows, bytes and answers.  Every wait is bounded.
"""

import dataclasses
import datetime as dt
import os
import random
import shutil
import sqlite3
import sys
import time

import pytest

from cometbft_tpu.abci import types as jat
from cometbft_tpu.cmd.main import main as jcli
from cometbft_tpu.indexer import kv as jkv
from cometbft_tpu.indexer import psql as jpsql
from cometbft_tpu.libs.pubsub import Query as JQuery
from cometbft_tpu_torch.abci import types as tat
from cometbft_tpu_torch.cmd.main import main as tcli
from cometbft_tpu_torch.config import config as cfgmod
from cometbft_tpu_torch.indexer import kv as tkv
from cometbft_tpu_torch.indexer import psql as tpsql
from cometbft_tpu_torch.libs.pubsub import Query as TQuery

SEED = 20261026
CHAIN = "psql-diff-chain"
TABLES = ["blocks", "tx_results", "events", "attributes", "event_attributes",
          "block_events", "tx_events"]
QUERIES = [
    "block.height=2", "block.height>1", "block.height<=3", "xfer.amount>5",
    "xfer.amount=10", "xfer.to='alice'", "xfer.memo CONTAINS '5%'",
    "xfer.memo CONTAINS '_'", "xfer.amount EXISTS", "t.hidden=1", "tx.height=3",
    "tx.height>=2 AND xfer.to='bob'", "xfer.amount<30 AND xfer.amount>=0",
]


class _FixedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return dt.datetime(2026, 10, 19, 12, 0, 0, tzinfo=tz)


@pytest.fixture(autouse=True)
def _clock(monkeypatch):
    for mod in (jpsql, tpsql):
        monkeypatch.setattr(mod, "datetime", _FixedClock)


def _events(at, rng: random.Random, n: int) -> list:
    out = []
    for _ in range(n):
        attrs = [
            at.EventAttribute(key="amount", value=str(rng.randrange(40)), index=True),
            at.EventAttribute(key="to", value=rng.choice(["alice", "bob", "carol"]),
                              index=True),
            at.EventAttribute(key="memo", value=rng.choice(["5%_off", "plain", "a_b"]),
                              index=rng.random() < 0.8),
        ]
        out.append(at.Event(type_="xfer", attributes=attrs))
    out.append(at.Event(type_="t", attributes=[at.EventAttribute("hidden", "1", False)]))
    out.append(at.Event(type_="", attributes=[at.EventAttribute("skipped", "1", True)]))
    return out


def _feed(pkg_at, kv, sink, seed: int) -> None:
    """Five heights of block events, then each height's txs; one duplicate
    block and one duplicate tx; the same draws for either package."""
    rng = random.Random(seed)
    random.seed(seed)
    for h in range(1, 6):
        sink.index_block_events(h, _events(pkg_at, rng, 2))
        txrs = []
        for i in range(rng.randrange(1, 4)):
            res = pkg_at.ExecTxResult(code=rng.choice([0, 0, 3]), data=rng.randbytes(3),
                                      log="log%d" % i, gas_wanted=rng.randrange(100),
                                      gas_used=rng.randrange(100),
                                      events=_events(pkg_at, rng, 1), codespace="cs")
            txrs.append(kv.TxResult(height=h, index=i, tx=b"tx-%d-%d" % (h, i), result=res))
        sink.index_tx_events(txrs)
        if h == 3:
            sink.index_block_events(h, _events(pkg_at, rng, 1))
            sink.index_tx_events(txrs[:1])


def _dump(conn) -> dict:
    return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(), key=repr)
            for t in TABLES}


def _tx_answer(txr) -> tuple:
    return txr.height, txr.index, txr.tx, dataclasses.asdict(txr.result)


def test_sinks_dump_and_search_equal_jax():
    js, ts = jpsql.PsqlEventSink(":memory:", CHAIN), tpsql.PsqlEventSink("sqlite://", CHAIN)
    try:
        _feed(jat, jkv, js, SEED)
        _feed(tat, tkv, ts, SEED)
        jd, td = _dump(js._conn), _dump(ts._conn)
        assert td == jd
        assert len(td["blocks"]) == 5 and len(td["tx_results"]) >= 5
        assert all(v for v in td.values())
        for q in QUERIES:
            assert ts.search_block_events(TQuery.parse(q)) == js.search_block_events(
                JQuery.parse(q)), q
            got = [_tx_answer(r) for r in ts.search_tx_events(TQuery.parse(q))]
            assert got == [_tx_answer(r) for r in js.search_tx_events(JQuery.parse(q))], q
        for (_, _, _, _, tx_hash, _) in td["tx_results"]:
            h = bytes.fromhex(tx_hash)
            assert _tx_answer(ts.get_tx_by_hash(h)) == _tx_answer(js.get_tx_by_hash(h))
        # the adapters the node and the RPC drive
        ta, ja = tpsql.PsqlTxIndexerAdapter(ts), jpsql.PsqlTxIndexerAdapter(js)
        assert [_tx_answer(r) for r in ta.search(TQuery.parse("tx.height>0"))] == [
            _tx_answer(r) for r in ja.search(JQuery.parse("tx.height>0"))]
        assert ta.prune(3) == ja.prune(3) == 0
        tb, jb = tpsql.PsqlBlockIndexerAdapter(ts), jpsql.PsqlBlockIndexerAdapter(js)
        assert tb.search(TQuery.parse("block.height>=1")) == jb.search(
            JQuery.parse("block.height>=1")) == [1, 2, 3, 4, 5]
    finally:
        js.stop()
        ts.stop()


def test_a_tx_before_its_block_is_refused_alike():
    out = []
    for pkg, at, kv, conn in ((jpsql, jat, jkv, ":memory:"), (tpsql, tat, tkv, "sqlite://")):
        sink = pkg.PsqlEventSink(conn, CHAIN)
        try:
            with pytest.raises(LookupError) as e:
                sink.index_tx_events([kv.TxResult(height=9, index=0, tx=b"x",
                                                  result=at.ExecTxResult())])
            out.append((str(e.value), _dump(sink._conn)))
        finally:
            sink.stop()
    assert out[0] == out[1]


def test_other_connection_strings_need_psycopg2(monkeypatch):
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    errs = []
    for pkg in (jpsql, tpsql):
        with pytest.raises(ImportError) as e:
            pkg.PsqlEventSink("postgresql://user@127.0.0.1:1/db", CHAIN)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_reindex_event_equals_jax(tmp_path, monkeypatch):
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.rpc.core import Environment

    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    home = str(tmp_path / "node")
    assert tcli(["--home", home, "init", "--chain-id", CHAIN]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    cfg.base.db_backend = "sqlite"
    cfg.rpc.laddr = cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_commit_ms = 30
    cfg.tx_index.indexer = "psql"
    cfg.tx_index.psql_conn = "sqlite://" + str(tmp_path / "live.db")
    cfgmod.write_config(cfg)
    node = Node(cfg, device="cpu")
    node.start()
    try:
        env = Environment(node)
        for k in range(4):
            assert env.broadcast_tx_sync(b"reidx%d=v%d" % (k, k))["code"] == 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len(node.tx_indexer.search(TQuery.parse("tx.height>0"))) == 4:
                break
            time.sleep(0.05)
        live = node.tx_indexer.search(TQuery.parse("tx.height>0"))
        assert sorted(r.tx for r in live) == [b"reidx%d=v%d" % (k, k) for k in range(4)]
    finally:
        node.stop()
    dumps = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        copy = str(tmp_path / name)
        shutil.copytree(home, copy)
        c = cfgmod.load_config(copy)
        c.base.home = copy
        c.tx_index.psql_conn = "sqlite://" + os.path.join(copy, "rebuilt.db")
        cfgmod.write_config(c)
        random.seed(SEED)
        assert cli(["--home", copy, "reindex-event"]) == 0
        conn = sqlite3.connect(os.path.join(copy, "rebuilt.db"))
        try:
            dumps.append(_dump(conn))
        finally:
            conn.close()
    assert dumps[1] == dumps[0]
    hashes = {r[4] for r in dumps[1]["tx_results"]}
    assert hashes == {r.hash.hex().upper() for r in live}
