"""The port's state sync (``statesync/syncer.py``, ``stateprovider.py``,
``reactor.py``, and ``tests/torch_net.run_statesync``'s hand-off to
blocksync) held to the JAX package's.

* The syncer's chunk re-request backoff, its peer rotation and its
  discovery window on an injected clock: the same requests at the same
  virtual times in both packages.
* A fresh port joiner statesyncs a seeded ``tests/torch_chain.py`` chain
  (7 heights: the KVStore snapshot at 5, light blocks 5-7 behind it) over
  two switches on ``device="cpu"``, from a port helper and from a JAX
  helper, with its app behind the port's ABCI socket server; then it
  blocksyncs block 6.  Its bootstrapped ``State`` (JSON bytes) and app
  hashes equal a JAX joiner's on the same chain, and header 6's and 7's
  app hashes.

Both packages on ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` with serial
handshakes and frames (``COMETBFT_TPU_HANDSHAKE=0``,
``COMETBFT_TPU_AEAD=0``: no JAX program); the port's commits through the
supervisor's device-runner seam (the oracle).  Every wait has a deadline,
every switch, server and client stops in a ``finally``.
"""

import sys
import time

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_chain  # noqa: E402
import torch_net  # noqa: E402

from cometbft_tpu.statesync import syncer as jsyn  # noqa: E402

from cometbft_tpu_torch.crypto import backend_health as tbh  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import sigcache as tsc  # noqa: E402
from cometbft_tpu_torch.ops import dispatch_stats as tds  # noqa: E402
from cometbft_tpu_torch.ops import supervisor as tsup  # noqa: E402
from cometbft_tpu_torch.statesync import syncer as tsyn  # noqa: E402

JAX, PORT = "cometbft_tpu", "cometbft_tpu_torch"
CPU = {"device": "cpu"}
HEIGHTS = 7
NOW = torch_chain.T0 + 500.0
PERIOD = 10_000
WAIT_S = 60.0


def _oracle(backend, pubs, msgs, sigs, lanes):
    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
    return out


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE", "0")
    monkeypatch.setenv("COMETBFT_TPU_AEAD", "0")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()
    tsup.set_device_runner(_oracle)
    yield
    tsup.clear_device_runner()


# -- the syncer on an injected clock ------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _syncer(syn, clock, on_wait=None, chunk_timeout=10.0, peers=("p1", "p2")):
    requests = []

    def sleeper(timeout):
        clock.t += timeout
        if on_wait is not None:
            on_wait(s)

    s = syn.Syncer(None, None, lambda p, h, f, i: requests.append((clock.t, p, i)) or True,
                   chunk_timeout=chunk_timeout, clock=clock, sleeper=sleeper)
    snap = syn.SnapshotKey(height=10, format=1, hash=b"\x01" * 32, chunks=4)
    s.snapshots[snap] = syn._SnapshotInfo(snap, peers=set(peers))
    s._active = snap
    return s, snap, requests


def _run_fetch(syn, case):
    clock = _Clock()
    delivered = [0]

    def on_wait(s):
        while delivered[0] < min(int(clock.t), 4):
            s.add_chunk(10, 1, delivered[0], b"chunk%d" % delivered[0])
            delivered[0] += 1

    kw = {"timeout": dict(chunk_timeout=10.0), "progress": dict(on_wait=on_wait),
          "rotation": dict(chunk_timeout=0.2, peers=("pB", "pA", "pC"))}[case]
    s, snap, requests = _syncer(syn, clock, **kw)
    try:
        s._fetch_chunks(snap)
        err = None
    except syn.StatesyncError as e:
        err = str(e)
    return requests, err, round(clock.t, 9), sorted(s._chunks)


@pytest.mark.parametrize("case", ["timeout", "progress", "rotation"])
def test_fetch_backoff_and_rotation_equal_jax(case):
    got = _run_fetch(tsyn, case)
    assert got == _run_fetch(jsyn, case)
    requests, err = got[0], got[1]
    gaps = [b - a for a, b in zip(sorted({t for t, _, _ in requests}),
                                  sorted({t for t, _, _ in requests})[1:])]
    if case == "timeout":
        assert err == "timed out fetching chunks" and gaps == sorted(gaps)
        assert max(gaps) >= tsyn.Syncer.RETRY_MAX_S
    if case == "progress":
        assert err is None and got[3] == [0, 1, 2, 3] and got[2] < 10.0
    if case == "rotation":
        assert [p for t, p, _ in requests if t == 0.0] == ["pB", "pC", "pA", "pB"]


def test_discovery_window_equal_jax():
    got = []
    for syn in (jsyn, tsyn):
        clock, polls = _Clock(), []
        s = syn.Syncer(None, None, lambda *a: True, clock=clock,
                       sleeper=lambda dt: setattr(clock, "t", clock.t + dt))
        with pytest.raises(syn.ErrNoSnapshots):
            s.sync_any(6.0, lambda: True, rediscover=lambda: polls.append(round(clock.t, 9)))
        got.append((polls, round(clock.t, 9)))
    assert got[0] == got[1] and len(got[1][0]) >= 2


# -- a joiner over two switches ----------------------------------------------


_CHAINS = {}


def _chain(pkg):
    if pkg not in _CHAINS:
        kw = {"executor_kw": CPU, "pool_kw": CPU} if pkg == PORT else {}
        _CHAINS[pkg] = torch_chain.drive(pkg, heights=HEIGHTS, evidence_at=0,
                                         **kw)[0]
    return _CHAINS[pkg]


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _join(joiner_pkg: str, helper_pkg: str, socket_app: bool) -> dict:
    """``joiner_pkg``'s fresh node statesyncs ``helper_pkg``'s chain, then
    blocksyncs block 6.  Its light client reads the joiner package's copy
    of the chain (the same bytes): the trusted hash of block 1 and the
    headers, as a light client reads an RPC node's."""
    helper, mine = _chain(helper_pkg), _chain(joiner_pkg)
    m = torch_chain.modules(joiner_pkg)
    proxy = __import__(f"{joiner_pkg}.proxy.multi_app_conn", fromlist=["x"])
    prov = __import__(f"{joiner_pkg}.light.provider", fromlist=["x"])
    lv = __import__(f"{joiner_pkg}.light.verifier", fromlist=["x"])
    sp = __import__(f"{joiner_pkg}.statesync.stateprovider", fromlist=["x"])
    hproxy = __import__(f"{helper_pkg}.proxy.multi_app_conn", fromlist=["x"])
    port_kw = CPU if joiner_pkg == PORT else {}
    nets, server, conns = [], None, None
    hconns = hproxy.AppConns(hproxy.local_client_creator(helper.app))
    hconns.start()
    try:
        app = m.kvstore.KVStoreApplication()
        if socket_app:
            from cometbft_tpu_torch.abci.server import ABCIServer

            server = ABCIServer(app, "tcp://127.0.0.1:0")
            server.start()
            conns = proxy.AppConns(proxy.remote_client_creator(
                f"tcp://127.0.0.1:{server.bound_port}"))
        else:
            conns = proxy.AppConns(proxy.local_client_creator(app))
        conns.start()
        db = m.kv.MemKV()
        ss, bst = m.state_store.StateStore(db), m.block_store.BlockStore(db)
        genesis = mine.genesis
        state = m.state.state_from_genesis(genesis)
        pool = m.pool.EvidencePool(db, ss, bst, **port_kw)
        ex = m.execution.BlockExecutor(ss, bst, conns.consensus, m.mempool.NopMempool(),
                                       evidence_pool=pool, **port_kw)
        cfg = torch_net.modules(helper_pkg).config.P2PConfig(pex=False)
        h = torch_net.build(helper_pkg, torch_net.node_key(helper_pkg, b"ss-helper"),
                            torch_chain.CHAIN_ID, p2p_config=cfg, state=helper.state,
                            block_store=helper.block_store, statesync_app=hconns,
                            **(CPU if helper_pkg == PORT else {}))
        nets.append(h)
        j = torch_net.build(joiner_pkg, torch_net.node_key(joiner_pkg, b"ss-joiner"),
                            torch_chain.CHAIN_ID,
                            p2p_config=torch_net.modules(joiner_pkg).config.P2PConfig(pex=False),
                            state=state, block_exec=ex, block_store=bst, block_sync=False,
                            statesync_app=conns, **port_kw)
        nets.append(j)
        h.start()
        j.start([h.address])
        _wait(lambda: j.wait_peers(1, 0.1), "the dial")
        node = type("N", (), {"genesis_doc": genesis, "block_store": mine.block_store,
                              "state_store": mine.state_store,
                              "node_key": type("K", (), {"node_id": "h" * 40})})()
        trust = lv.TrustOptions(PERIOD, 1, mine.block_store.load_block_meta(1).block_id.hash)
        provider = sp.LightClientStateProvider(torch_chain.CHAIN_ID, [prov.NodeProvider(node)],
                                               trust, genesis_doc=genesis,
                                               now_fn=lambda: NOW, **port_kw)
        got = torch_net.run_statesync(j, provider, conns, ss, bst, evidence_pool=pool,
                                      discovery_s=0.5, chunk_timeout_s=10.0)
        assert got is not None, "statesync failed"
        synced, _ = got
        restored = conns.query.info().last_block_app_hash
        bs = j.reactors["BLOCKSYNC"]
        _wait(lambda: bst.height() >= 6 and not bs.syncing, "the blocksync of block 6")
        return {"state": synced.to_json(), "restored": restored,
                "after": conns.query.info().last_block_app_hash, "height": bst.height(),
                "block6": bst.load_block(6).hash(), "base": bst.base(),
                "bootstrapped": ss.load_validators(6).hash()}
    finally:
        for n in nets:
            n.stop()
        if conns is not None:
            conns.stop()
        hconns.stop()
        if server is not None:
            server.stop()


@pytest.fixture(scope="module")
def jax_joiner():
    """The JAX joiner from the JAX helper: the reference for both cases."""
    import os

    old = {k: os.environ.get(k) for k in ("COMETBFT_TPU_CRYPTO_BACKEND",
                                          "COMETBFT_TPU_HANDSHAKE", "COMETBFT_TPU_AEAD")}
    os.environ.update(COMETBFT_TPU_CRYPTO_BACKEND="cpu", COMETBFT_TPU_HANDSHAKE="0",
                      COMETBFT_TPU_AEAD="0")
    try:
        return _join(JAX, JAX, socket_app=False)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("helper_pkg", [PORT, JAX])
def test_port_joiner_statesyncs_like_jax(jax_joiner, helper_pkg):
    got = _join(PORT, helper_pkg, socket_app=True)
    chain = _chain(PORT)
    assert got == jax_joiner
    assert got["restored"] == chain.block_store.load_block_meta(6).header.app_hash
    assert got["after"] == chain.block_store.load_block_meta(7).header.app_hash
    assert got["height"] == 6 and got["base"] == 6
    assert got["block6"] == chain.block_store.load_block(6).hash()


def test_statesync_failure_falls_back_to_blocksync():
    """A trust hash no block has: the restore fails, "statesync failed" is
    logged, and the node blocksyncs from its genesis state instead."""
    errors = []

    class Log:
        def with_(self, **kw):
            return self

        def error(self, msg, **kw):
            errors.append(msg)

        info = debug = warn = lambda self, *a, **k: None

    chain = _chain(PORT)
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.proxy.multi_app_conn import AppConns, local_client_creator

    m = torch_chain.modules(PORT)
    conns = AppConns(local_client_creator(KVStoreApplication()))
    conns.start()
    db = m.kv.MemKV()
    ss, bst = m.state_store.StateStore(db), m.block_store.BlockStore(db)
    ex = m.execution.BlockExecutor(ss, bst, conns.consensus, m.mempool.NopMempool(), **CPU)
    j = torch_net.build(PORT, torch_net.node_key(PORT, b"ss-lost"), torch_chain.CHAIN_ID,
                        p2p_config=torch_net.modules(PORT).config.P2PConfig(pex=False),
                        state=m.state.state_from_genesis(chain.genesis), block_exec=ex,
                        block_store=bst, block_sync=False, statesync_app=conns, **CPU)
    try:
        j.start()

        class NoSnapshot:
            pass

        out = torch_net.run_statesync(j, NoSnapshot(), conns, ss, bst, discovery_s=0.2,
                                      logger=Log())
        assert out is None and errors == ["statesync failed, falling back to blocksync"]
        assert j.reactors["BLOCKSYNC"].syncing
    finally:
        j.stop()
        conns.stop()
