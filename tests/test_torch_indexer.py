"""The port's tx and block indexers, indexer service and pruner against the
JAX package's.

The same FinalizeBlock events go through ``indexer/kv.py`` in both packages:
the index rows must be equal byte for byte, and every query (``=``, ``<``,
``>``, ``<=``, ``>=``, ``CONTAINS``, ``EXISTS``, ``AND``, ``tx.hash``) must
give the same results in the same order.  The indexer service indexes a
seeded chain (``tests/torch_chain.py``) off each package's event bus to the
same rows, ``migrate_legacy_index`` drains the same rows out of a chain db,
and ``state/pruner.Pruner`` leaves the same keys for the same retain
heights.  Nothing here verifies a signature on the port's side but the
chain's own LastCommits, which run the plain version on ``device="cpu"``.
"""

from __future__ import annotations

import importlib
import threading
import time

import numpy as np
import pytest

import torch_chain

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu_backend(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _rows(db) -> list:
    return list(db.iterate(b"", None))


def _results(pkg: str, seed: int = 7, heights: int = 6, per: int = 5):
    """Seeded (height, index, tx, ExecTxResult) and per-height block events
    in ``pkg``'s types: numeric, string and unindexed attributes."""
    at = _m(pkg, "abci.types")
    rng = np.random.default_rng(seed)
    txs, blocks = [], []
    for h in range(1, heights + 1):
        for i in range(per):
            n = int(rng.integers(0, 100))
            name = ["alice", "bob", "carol", "dave"][int(rng.integers(0, 4))]
            ev = [
                at.Event(type_="transfer", attributes=[
                    at.EventAttribute("amount", str(n), True),
                    at.EventAttribute("sender", name, True),
                    at.EventAttribute("memo", f"m{n}", False),
                ]),
                at.Event(type_="app", attributes=[
                    at.EventAttribute("key", f"k{h}-{i}", True),
                ]),
            ]
            if i % 2:
                ev.append(at.Event(type_="odd", attributes=[
                    at.EventAttribute("flag", "yes", True)]))
            txs.append((h, i, b"tx-%d-%d-%d" % (h, i, n),
                        at.ExecTxResult(code=0, gas_used=n, events=ev)))
        blocks.append((h, [at.Event(type_="begin", attributes=[
            at.EventAttribute("proposer", f"p{h % 3}", True),
            at.EventAttribute("fee", str(10 * h), True)])]))
    return txs, blocks


def _indexed(pkg: str):
    kv = _m(pkg, "indexer.kv")
    db = _m(pkg, "store.kv").MemKV()
    txi, bli = kv.KVTxIndexer(db), kv.KVBlockIndexer(db)
    txs, blocks = _results(pkg)
    for h, i, tx, res in txs:
        txi.index(h, i, tx, res)
    for h, ev in blocks:
        bli.index(h, ev)
    return db, txi, bli, txs


def test_index_rows_equal_the_jax_package_byte_for_byte():
    jax_db, *_ = _indexed("cometbft_tpu")
    port_db, *_ = _indexed("cometbft_tpu_torch")
    rows = _rows(port_db)
    assert rows == _rows(jax_db)
    assert len(rows) > 100


TX_QUERIES = [
    "tx.height=3",
    "tx.height<3",
    "tx.height>4",
    "tx.height<=2",
    "tx.height>=5",
    "transfer.amount>50",
    "transfer.amount<20",
    "transfer.sender='bob'",
    "transfer.sender CONTAINS 'a'",
    "odd.flag EXISTS",
    "transfer.sender='alice' AND transfer.amount>30",
    "tx.height>=2 AND tx.height<=4 AND odd.flag EXISTS",
    "app.key='k2-3'",
    "transfer.memo EXISTS",  # unindexed: no rows
    "transfer.sender='nobody'",
]


@pytest.mark.parametrize("query", TX_QUERIES)
def test_tx_search_equals_the_jax_package(query):
    out = []
    for pkg in PKGS:
        _, txi, _, _ = _indexed(pkg)
        q = _m(pkg, "libs.pubsub").Query.parse(query)
        out.append([r.to_json() for r in txi.search(q)])
    assert out[0] == out[1]


def test_tx_search_by_hash_and_get():
    out = []
    for pkg in PKGS:
        _, txi, _, txs = _indexed(pkg)
        h = _m(pkg, "crypto.tmhash").sum256(txs[7][2])
        q = _m(pkg, "libs.pubsub").Query.parse(f"tx.hash='{h.hex().upper()}'")
        out.append(([r.to_json() for r in txi.search(q)], txi.get(h).encode(),
                    txi.get(b"\x00" * 32)))
    assert out[0] == out[1]
    assert len(out[1][0]) == 1 and out[1][2] is None


@pytest.mark.parametrize("query", [
    "block.height=2", "block.height>3", "block.height<=2", "begin.proposer='p1'",
    "begin.fee>25", "begin.proposer CONTAINS 'p'", "begin.fee EXISTS",
    "begin.proposer='p0' AND block.height>1",
])
def test_block_search_equals_the_jax_package(query):
    out = []
    for pkg in PKGS:
        _, _, bli, _ = _indexed(pkg)
        out.append(bli.search(_m(pkg, "libs.pubsub").Query.parse(query)))
    assert out[0] == out[1]


def test_migrate_legacy_index_moves_the_same_rows():
    out = []
    for pkg in PKGS:
        kv = _m(pkg, "store.kv")
        legacy, _, _, _ = _indexed(pkg)
        legacy.set(b"SC:other", b"chain data")  # not an index row: stays
        index_db = kv.MemKV()
        moved = _m(pkg, "indexer.kv").migrate_legacy_index(legacy, index_db)
        out.append((moved, _rows(legacy), _rows(index_db)))
    assert out[0] == out[1]
    assert out[1][0] > 0 and out[1][1] == [(b"SC:other", b"chain data")]


def _chain_with_service(pkg: str, heights: int = 4):
    """A seeded chain whose event bus feeds ``IndexerService``; returns the
    index db once every height's rows are in."""
    m = torch_chain.modules(pkg)
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    c = torch_chain.Chain(pkg, executor_kw=kw, pool_kw=kw)
    kv = _m(pkg, "indexer.kv")
    db = m.kv.MemKV()
    txi, bli = kv.KVTxIndexer(db), kv.KVBlockIndexer(db)
    svc = _m(pkg, "indexer.service").IndexerService(txi, bli, c.bus)
    svc.start()
    try:
        per = 5
        for h in range(1, heights + 1):
            c.apply(c.make_block(h, torch_chain.txs_at(h, per, c.seed)))
        deadline = time.monotonic() + 30
        q = _m(pkg, "libs.pubsub").Query.parse("tx.height>0")
        while len(txi.search(q)) < heights * per or len(
                bli.search(_m(pkg, "libs.pubsub").Query.parse("block.height>0"))) < heights:
            assert time.monotonic() < deadline, "the indexer service did not catch up"
            time.sleep(0.02)
    finally:
        svc.stop()
    return db, c


def test_indexer_service_indexes_a_chain_to_the_same_rows():
    jax_db, _ = _chain_with_service("cometbft_tpu")
    port_db, _ = _chain_with_service("cometbft_tpu_torch")
    assert _rows(port_db) == _rows(jax_db)


@pytest.mark.parametrize("retain", [
    dict(app_retain=3),
    dict(app_retain=5, companion_retain=3, companion_results_retain=4),
    dict(companion_results_retain=3, tx_index_retain=3, block_index_retain=2),
    dict(app_retain=4, tx_index_retain=5, block_index_retain=5),
])
def test_pruner_leaves_the_same_keys(retain):
    """Both packages' stores after ``drive`` hold equal bytes; the same
    retain heights must delete the same keys from them and the indexes."""
    out = []
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
        m = torch_chain.modules(pkg)
        c, _ = torch_chain.drive(pkg, heights=6, executor_kw=kw, pool_kw=kw)
        kv = _m(pkg, "indexer.kv")
        idx = m.kv.MemKV()
        txi, bli = kv.KVTxIndexer(idx), kv.KVBlockIndexer(idx)
        for h in range(1, 7):
            res = _m(pkg, "state.execution").fbr_from_json(
                c.state_store.load_finalize_block_response(h))
            blk = c.block_store.load_block(h)
            bli.index(h, res.events)
            for i, tx in enumerate(blk.data.txs):
                txi.index(h, i, tx, res.tx_results[i])
        heights = _m(pkg, "state.execution")._PrunerHeights(**retain)
        p = _m(pkg, "state.pruner").Pruner(heights, c.block_store, c.state_store,
                                            tx_indexer=txi, block_indexer=bli,
                                            interval_s=9999)
        counts = p.prune_once()
        again = p.prune_once()
        out.append((counts, again, [k for k, _ in _rows(c.db)], _rows(idx),
                    c.block_store.base()))
    assert out[0] == out[1]
    assert any(out[1][0].values())


class _HeldTxIndexer:
    """A tx indexer whose first ``index`` waits until the test lets it go:
    the service's consumer is then held while a block's events fill its
    queue, whatever the machine's load."""

    def __init__(self, inner):
        self.inner = inner
        self.entered, self.release = threading.Event(), threading.Event()

    def index(self, *args):
        self.entered.set()
        self.release.wait(30.0)
        return self.inner.index(*args)

    def search(self, q, *args, **kwargs):
        return self.inner.search(q, *args, **kwargs)


def _service_after_a_big_block(pkg: str, n: int, wait_s: float) -> int:
    at = _m(pkg, "abci.types")
    ev = _m(pkg, "types.events")
    kv = _m(pkg, "indexer.kv")
    bus = ev.EventBus()
    db = _m(pkg, "store.kv").MemKV()
    txi, bli = _HeldTxIndexer(kv.KVTxIndexer(db)), kv.KVBlockIndexer(db)
    svc = _m(pkg, "indexer.service").IndexerService(txi, bli, bus)
    svc.start()
    q = _m(pkg, "libs.pubsub").Query.parse("tx.height=1")

    def publish(i: int) -> None:  # one block's Tx events, as _fire_events publishes them
        bus.publish_tx(ev.EventDataTx(height=1, index=i, tx=b"big-%05d" % i,
                                      result=at.ExecTxResult()))

    try:
        publish(0)
        assert txi.entered.wait(10.0), "the service never took the first tx"
        for i in range(1, n):
            publish(i)
        bus.publish_new_block_events(ev.EventDataNewBlockEvents(height=1, num_txs=n))
        txi.release.set()
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline and len(txi.search(q)) < n:
            time.sleep(0.05)
        return len(txi.search(q))
    finally:
        txi.release.set()
        svc.stop()


def test_indexer_service_keeps_every_tx_of_a_block_over_its_queue():
    """Departure (ROADMAP §3): the JAX service's tx queue holds 1,000
    events and the bus cancels it when full, so a block of more txs ends
    its indexing; the port's queues are unbounded, as the reference's
    indexer subscribes unbuffered."""
    n = 2_500
    assert _service_after_a_big_block("cometbft_tpu_torch", n, 30.0) == n
    assert _service_after_a_big_block("cometbft_tpu", n, 1.0) < n
