"""The port's key-value stores, block store, state store and disk guard
against the JAX package's.

* ``store/kv``: one seeded sequence of sets, deletes, overwrites and
  batches through both packages' ``MemKV`` and ``SqliteKV`` (and a
  ``UnionKV`` over them) gives equal iteration: whole, by range, paged;
  ``open_kv`` routes and refuses alike.
* ``BlockStore``/``StateStore``: the same four-height chain
  (``tests/torch_chain.drive``) applied by both packages over ``MemKV``
  leaves byte-equal raw key/value pairs (block metas, parts, commits,
  seen commits, state, validator sets, params, FinalizeBlock responses,
  evidence markers); the port's stores read them back (blocks hashing
  to their ids, metas, commits, validators, params, the response), and
  pruning and ``delete_latest_block`` delete the same keys.  The port
  reopens a ``SqliteKV`` chain store and loads the same state.
* ``libs/diskguard``: under one fault plan (EIO on a fail-stop surface,
  transient EIO then success and EIO past the retry budget on a
  degradable one, ENOSPC, a torn ``atomic_write``, latency) both
  packages raise the same errors (``StorageFatal`` with its surface, op
  and errno), retry the same number of times and count the same
  ``storage_stats``.

All tolerances are exact.  Signatures are checked on the CPU
(``COMETBFT_TPU_CRYPTO_BACKEND=cpu``, the host reference in both).
"""

import errno
import os

import numpy as np
import pytest

import torch_chain as tc

JAX = tc.modules("cometbft_tpu")
PORT = tc.modules("cometbft_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for m in (JAX, PORT):
        m.storage_stats.reset()
        m.diskguard.clear_fault_plan()
        m.diskguard.set_sleeper(lambda s: None)
    yield
    for m in (JAX, PORT):
        m.diskguard.clear_fault_plan()
        m.diskguard.set_sleeper(None)
        m.storage_stats.reset()


# -- key-value stores --------------------------------------------------------


def _ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, int(rng.integers(0, 6)), dtype=np.uint8))
            for _ in range(60)]
    out = []
    for _ in range(n):
        r = rng.random()
        k = keys[int(rng.integers(len(keys)))]
        if r < 0.55:
            out.append(("set", k, rng.bytes(int(rng.integers(0, 20)))))
        elif r < 0.8:
            out.append(("delete", k, None))
        else:
            sets = [(keys[int(i)], rng.bytes(3)) for i in rng.integers(0, len(keys), 4)]
            dels = [keys[int(i)] for i in rng.integers(0, len(keys), 2)]
            out.append(("batch", sets, dels))
    return out


def _run(db, ops):
    for op, a, b in ops:
        if op == "set":
            db.set(a, b)
        elif op == "delete":
            db.delete(a)
        else:
            db.write_batch(a, b)


def _scans(db):
    return [list(db.iterate()), list(db.iterate(b"\x40", b"\xc0")),
            list(db.iterate(b"\x80")), list(db.iterate(b"", b"\x10", snapshot=False)),
            [db.get(bytes([i])) for i in range(0, 256, 17)], db.get(b"")]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
def test_kv_iteration_equals_jax(tmp_path, seed, backend):
    ops = _ops(seed)
    got = []
    for name, m in (("jax", JAX), ("port", PORT)):
        path = str(tmp_path / f"{name}.db")
        db = m.kv.open_kv(backend, path, surface="state")
        _run(db, ops)
        if backend == "sqlite":
            db.compact()
            db.flush()
        got.append(_scans(db))
        db.close()
    assert got[0] == got[1] and got[1][0]


def test_sqlite_paged_scan_and_reopen(tmp_path, monkeypatch):
    """A scan longer than a page, paged; the file reopened reads the same."""
    monkeypatch.setattr(PORT.kv.SqliteKV, "_ITER_PAGE", 7)
    path = str(tmp_path / "port.db")
    db = PORT.kv.SqliteKV(path, surface="state")
    mem = JAX.kv.MemKV()
    for op in _ops(9, 200):
        _run(db, [op])
        _run(mem, [op])
    want = list(mem.iterate())
    assert list(db.iterate(snapshot=False)) == want == list(db.iterate())
    db.close()
    db = PORT.kv.SqliteKV(path, surface="state", probe=True)
    assert list(db.iterate()) == want
    db.close()


def test_union_kv_equals_jax():
    got = []
    for m in (JAX, PORT):
        prim, fb = m.kv.MemKV(), m.kv.MemKV()
        _run(fb, _ops(4, 120))
        u = m.kv.UnionKV(prim, fb, fallback_surface="indexer")
        _run(u, _ops(5, 120))
        got.append((_scans(u), list(prim.iterate()), list(fb.iterate())))
    assert got[0] == got[1]


def test_open_kv_refuses_alike():
    for args in (("sqlite", None), ("leveldb", "x")):
        errs = []
        for m in (JAX, PORT):
            with pytest.raises(ValueError) as e:
                m.kv.open_kv(*args)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# -- block and state stores --------------------------------------------------


@pytest.fixture(scope="module")
def chains():
    mp = pytest.MonkeyPatch()
    mp.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    try:
        yield tc.drive("cometbft_tpu"), tc.drive("cometbft_tpu_torch")
    finally:
        mp.undo()


def test_stores_write_equal_raw_key_values(chains):
    (jc, _), (tcn, _) = chains
    jrows, trows = list(jc.db.iterate()), list(tcn.db.iterate())
    assert [k for k, _ in trows] == [k for k, _ in jrows]
    for (k, v), (_, w) in zip(trows, jrows):
        assert v == w, k
    prefixes = {k.split(b":")[0] for k, _ in trows}
    assert {b"H", b"P", b"C", b"SC", b"stateKey", b"validatorsKey",
            b"consensusParamsKey", b"abciResponsesKey"} <= prefixes
    assert any(k.startswith(b"evc/") for k, _ in trows)


def test_block_store_loads_back(chains):
    (jc, _), (tcn, _) = chains
    bs, jbs = tcn.block_store, jc.block_store
    assert (bs.base(), bs.height(), bs.size()) == (jbs.base(), jbs.height(), jbs.size()) == (1, 4, 4)
    for h in range(1, 5):
        meta = bs.load_block_meta(h)
        blk = bs.load_block(h)
        assert blk.hash() == meta.block_id.hash == jbs.load_block_meta(h).block_id.hash
        assert PORT.codec.encode_block(blk) == JAX.codec.encode_block(jbs.load_block(h))
        assert bs.load_block_by_hash(meta.block_id.hash).header.height == h
        assert bs.load_block_part(h, 0).bytes_ == jbs.load_block_part(h, 0).bytes_
        assert (PORT.codec.encode_commit(bs.load_seen_commit(h))
                == JAX.codec.encode_commit(jbs.load_seen_commit(h)))
        if h > 1:
            assert (PORT.codec.encode_commit(bs.load_block_commit(h - 1))
                    == JAX.codec.encode_commit(jbs.load_block_commit(h - 1)))
    assert bs.load_block(5) is None and bs.load_block_meta(0) is None


def test_state_store_loads_back(chains):
    (jc, _), (tcn, _) = chains
    ss, jss = tcn.state_store, jc.state_store
    assert ss.load().to_json() == jss.load().to_json() == tcn.state.to_json()
    for h in range(1, 7):
        got, want = ss.load_validators(h), jss.load_validators(h)
        assert (got is None) == (want is None), h
        if got is not None:
            assert got.hash() == want.hash(), h
            assert [v.voting_power for v in got.validators] == [
                v.voting_power for v in want.validators]
    assert max(v.voting_power for v in ss.load_validators(4).validators) == 2 * tc.POWER
    assert max(v.voting_power for v in ss.load_validators(3).validators) == tc.POWER
    for h in range(1, 5):
        assert ss.load_consensus_params(h) == PORT.state.state_from_genesis(
            tcn.genesis).consensus_params
        raw = ss.load_finalize_block_response(h)
        assert raw == jss.load_finalize_block_response(h)
        res = PORT.execution.fbr_from_json(raw)
        assert PORT.execution._fbr_to_json(res) == raw


def test_pruning_deletes_the_same_keys():
    out = []
    for pkg in ("cometbft_tpu", "cometbft_tpu_torch"):
        c, _ = tc.drive(pkg, heights=3)
        n = [c.block_store.prune_blocks(3), c.state_store.prune_states(1, 3)]
        c.block_store.delete_latest_block()
        out.append((n, c.block_store.base(), c.block_store.height(),
                    list(c.db.iterate())))
    assert out[0] == out[1]
    assert out[1][:3] == ([2, 2], 3, 2)


def test_sqlite_chain_store_reopens(tmp_path):
    path = str(tmp_path / "chain.db")
    db = PORT.kv.SqliteKV(path, surface="state")
    c, _ = tc.drive("cometbft_tpu_torch", heights=3, db=db)
    want = (c.state.to_json(), [c.block_store.load_block_meta(h).block_id for h in (1, 2, 3)])
    db.close()
    db = PORT.kv.SqliteKV(path, surface="state")
    bs, ss = PORT.block_store.BlockStore(db), PORT.state_store.StateStore(db)
    assert (ss.load().to_json(), [bs.load_block(h).hash() for h in (1, 2, 3)]) == (
        want[0], [b.hash for b in want[1]])
    assert bs.height() == 3
    db.close()


# -- the disk guard ----------------------------------------------------------


def _fault_script(m, tmp):
    """One scripted run under a fault plan; (outcome, retries) per step and
    the storage counters at the end."""
    dg = m.diskguard
    plan = dg.FaultPlan()
    dg.set_fault_plan(plan)
    db = m.kv.SqliteKV(os.path.join(tmp, "chain.db"), surface="state")
    idx = m.kv.SqliteKV(os.path.join(tmp, "index.db"), surface="indexer")
    out = []

    def step(fn):
        before = m.storage_stats.snapshot()
        try:
            fn()
            res = ("ok",)
        except dg.StorageFatal as e:
            res = ("StorageFatal", e.surface, e.op, e.io_errno, str(e.err))
        except OSError as e:
            res = (type(e).__name__, e.errno, str(e))
        out.append((res, m.storage_stats.snapshot() != before))

    step(lambda: db.set(b"a", b"1"))
    rule = plan.add(surface="state", op="set", err=errno.EIO, begin=0, count=1)
    step(lambda: db.set(b"b", b"2"))
    step(lambda: db.set(b"c", b"3"))
    plan.remove(rule)
    plan.add(surface="indexer", op="write_batch", err=errno.EIO, begin=0, count=2)
    step(lambda: idx.write_batch([(b"x", b"1")], []))
    plan.add(surface="indexer", op="set", err=errno.EIO, begin=0, count=99)
    step(lambda: idx.set(b"y", b"2"))
    plan.add(surface="indexer", op="delete", err=errno.ENOSPC, begin=0, count=1)
    step(lambda: idx.delete(b"x"))
    plan.add(surface="state", op="write_batch", err=errno.ENOSPC, begin=1, count=1)
    step(lambda: db.write_batch([(b"d", b"4")], [b"a"]))
    step(lambda: db.write_batch([(b"e", b"5")], []))
    plan.add(surface="blackbox", op="write", kind=dg.KIND_TORN, torn_keep=3)
    step(lambda: dg.atomic_write("blackbox", os.path.join(tmp, "j.bin"), b"abcdefgh"))
    plan.add(surface="status", kind=dg.KIND_LATENCY, latency_s=0.5)
    step(lambda: dg.atomic_write("status", os.path.join(tmp, "s.bin"), b"ok"))
    dg.clear_fault_plan()
    rows = (list(db.iterate()), list(idx.iterate()))
    db.close()
    idx.close()
    stats = m.storage_stats.snapshot()
    files = sorted(os.listdir(tmp))
    return out, rows, stats, files, [r.seen for r in plan._rules]


def test_fault_plan_gives_the_same_retries_and_fatals(tmp_path):
    got = []
    for name, m in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        got.append(_fault_script(m, str(d)))
    assert got[0] == got[1]
    out = got[1][0]
    assert out[1][0][:4] == ("StorageFatal", "state", "set", errno.EIO)
    assert out[3][0] == ("ok",) and out[4][0][0] == "OSError"
    stats = got[1][2]["surfaces"]
    assert stats["indexer"]["retries"] == 2 + PORT.diskguard.retries()
    assert stats["state"]["fatals"] == 2
