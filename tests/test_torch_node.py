"""The port's node as users start it: ``node/node.py``, ``cmd/``,
``node/rollback.py``, ``node/inspect.py`` and ``config/confix.py``.

- The JAX node's cases (``tests/test_node_rpc.py``) against a port node:
  ``cmd init``, then ``Node(cfg, device="cpu")`` answering JSON-RPC, the
  full-disk case with its black-box postmortem.
- ``rollback_state`` and ``confix.upgrade`` give the JAX package's result on
  the same input.
- A JAX node's home after some heights (``config.toml``, genesis, keys,
  ``chain.db``, ``tx_index.db``) is started by the port's ``Node``, which
  continues the chain and serves the JAX node's indexed txs.
- A port full node follows a JAX validator over a real link, and the
  reverse, to equal block hashes (serial links on both sides:
  ``COMETBFT_TPU_HANDSHAKE=0``, ``COMETBFT_TPU_AEAD=0``).
- The device rule (``Node()`` and ``cmd start`` with no card and no CPU
  asked for raise), the options that once raised naming their module (each
  now served: ``/debug/pprof/goroutine``, ``/metrics``, the gRPC services,
  the psql sink's ``block_search``, the transport's latency zone), the CLI
  command that waits for modules (``sim``: non-zero, named), and ``cmd
  trace`` and ``cmd postmortem`` against the JAX CLI's output on the same
  home.

Every node runs with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` (votes verify on the
host in both packages) and stops in a ``finally``; every wait has a deadline.
"""

from __future__ import annotations

import base64
import hashlib
import importlib
import json
import os
import time
import urllib.error
import urllib.request

import pytest

import torch_chain

from cometbft_tpu_torch.cmd.main import main as cli_main
from cometbft_tpu_torch.config import config as cfgmod
from cometbft_tpu_torch.node.node import Node

JAX, PORT = "cometbft_tpu", "cometbft_tpu_torch"


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")


def _rpc(port: int, method: str, params=None):
    body = json.dumps(
        {"jsonrpc": "2.0", "id": 1, "method": method, "params": params or {}}
    ).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=body, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=20) as resp:
        doc = json.loads(resp.read())
    if "error" in doc:
        raise RuntimeError(doc["error"])
    return doc["result"]


def _fast(cfg, db: str = "memdb"):
    cfg.base.db_backend = db
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_commit_ms = 50
    cfg.consensus.timeout_propose_ms = 2000
    return cfg


@pytest.fixture
def node(tmp_path):
    home = str(tmp_path / "node")
    assert cli_main(["--home", home, "init", "--chain-id", "rpc-test-chain"]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    n = Node(_fast(cfg), device="cpu")
    n.start()
    yield n
    n.stop()


def _wait_height(node, h, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if node.block_store.height() >= h:
            return
        time.sleep(0.05)
    raise TimeoutError(f"node at {node.block_store.height()}, wanted {h}")


# -- the JAX node's cases (tests/test_node_rpc.py) against a port node --------


def test_cli_init_files(tmp_path):
    home = str(tmp_path / "init-home")
    assert cli_main(["--home", home, "init"]) == 0
    for rel in ("config/config.toml", "config/genesis.json", "config/node_key.json",
                "config/priv_validator_key.json"):
        assert (tmp_path / "init-home" / rel).exists(), rel


def test_status_and_blocks(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 2)
    st = _rpc(port, "status")
    assert st["node_info"]["network"] == "rpc-test-chain"
    assert int(st["sync_info"]["latest_block_height"]) >= 2
    blk = _rpc(port, "block", {"height": "1"})
    assert blk["block"]["header"]["height"] == "1"
    assert blk["block"]["header"]["chain_id"] == "rpc-test-chain"
    cm = _rpc(port, "commit", {"height": "1"})
    assert cm["signed_header"]["commit"]["height"] == "1"
    assert _rpc(port, "validators")["total"] == "1"
    assert _rpc(port, "genesis")["genesis"]["chain_id"] == "rpc-test-chain"
    assert _rpc(port, "health") == {}
    assert int(_rpc(port, "abci_info")["response"]["last_block_height"]) >= 1


def test_health_503_on_storage_fatal(node):
    from cometbft_tpu_torch.libs import storage_stats

    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    url = f"http://127.0.0.1:{port}/health"
    with urllib.request.urlopen(url, timeout=20) as resp:
        assert resp.status == 200
    storage_stats.record_fatal("wal")
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=20)
        assert ei.value.code == 503
        assert "storage" in json.loads(ei.value.read())["error"]["message"]
        body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": "health",
                           "params": {}}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=body,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei2:
            urllib.request.urlopen(req, timeout=20)
        assert ei2.value.code == 503
        assert _rpc(port, "status")["node_info"]["network"] == "rpc-test-chain"
    finally:
        storage_stats.reset()
    with urllib.request.urlopen(url, timeout=20) as resp:
        assert resp.status == 200


def test_broadcast_tx_commit_roundtrip(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    res = _rpc(port, "broadcast_tx_commit",
               {"tx": base64.b64encode(b"rpckey=rpcval").decode()})
    assert res["tx_result"]["code"] == 0 and int(res["height"]) >= 1
    q = _rpc(port, "abci_query", {"path": "/store", "data": b"rpckey".hex()})
    assert base64.b64decode(q["response"]["value"]) == b"rpcval"
    br = _rpc(port, "block_results", {"height": res["height"]})
    assert len(br["txs_results"]) == 1 and br["txs_results"][0]["code"] == 0


def test_broadcast_tx_sync_and_unconfirmed(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    res = _rpc(port, "broadcast_tx_sync", {"tx": base64.b64encode(b"k2=v2").decode()})
    assert res["code"] == 0
    deadline = time.monotonic() + 20
    while int(_rpc(port, "num_unconfirmed_txs")["n_txs"]):
        assert time.monotonic() < deadline, "tx stuck in mempool"
        time.sleep(0.1)


def test_header_by_hash_and_unconfirmed_tx(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    meta = _rpc(port, "blockchain", {"min_height": 1, "max_height": 1})
    res = _rpc(port, "header_by_hash", {"hash": meta["block_metas"][0]["block_id"]["hash"]})
    assert res["header"]["height"] == "1"
    assert _rpc(port, "unconfirmed_tx", {"hash": "AA" * 32})["tx"] is None
    with pytest.raises(RuntimeError, match="empty"):
        _rpc(port, "unconfirmed_tx", {"hash": ""})


def test_unsafe_routes_gated(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    with pytest.raises(RuntimeError, match="unsafe"):
        _rpc(port, "unsafe_flush_mempool")
    node.rpc_server.config.unsafe = True
    try:
        assert _rpc(port, "unsafe_flush_mempool") == {}
        with pytest.raises(RuntimeError, match="no peers"):
            _rpc(port, "dial_peers", {"peers": []})
    finally:
        node.rpc_server.config.unsafe = False


def test_uri_get_routes(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/block?height=1", timeout=10) as r:
        assert json.loads(r.read())["result"]["block"]["header"]["height"] == "1"


def test_restart_replays_state(tmp_path):
    home = str(tmp_path / "restart-node")
    assert cli_main(["--home", home, "init", "--chain-id", "restart-chain"]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    _fast(cfg, "sqlite")
    cfg.rpc.laddr = ""
    n = Node(cfg, device="cpu")
    n.start()
    try:
        _wait_height(n, 2)
        h1 = n.block_store.height()
    finally:
        n.stop()
    n2 = Node(cfg, device="cpu")
    n2.start()
    try:
        _wait_height(n2, h1 + 1, timeout=30)
        assert n2.state_store.load().last_block_height >= h1
    finally:
        n2.stop()


def test_tx_indexing_and_search(node):
    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    tx_b = b"idxkey=idxval"
    res = _rpc(port, "broadcast_tx_commit", {"tx": base64.b64encode(tx_b).decode()})
    assert res["tx_result"]["code"] == 0
    height = res["height"]
    tx_hash = hashlib.sha256(tx_b).hexdigest().upper()
    deadline = time.monotonic() + 10
    got = None
    while got is None and time.monotonic() < deadline:
        try:
            got = _rpc(port, "tx", {"hash": tx_hash})
        except RuntimeError:
            time.sleep(0.1)
    assert got is not None, "tx never indexed"
    assert got["height"] == height and base64.b64decode(got["tx"]) == tx_b
    assert int(_rpc(port, "tx_search", {"query": f"tx.height={height}"})["total_count"]) >= 1
    by_attr = _rpc(port, "tx_search", {"query": "app.key='idxkey'"})
    assert int(by_attr["total_count"]) == 1 and by_attr["txs"][0]["hash"] == tx_hash
    bs = _rpc(port, "block_search", {"query": f"block.height<={height}"})
    assert int(bs["total_count"]) >= 1


def test_tx_prove_roundtrip(node):
    from cometbft_tpu_torch.crypto import merkle

    port = node.rpc_server.bound_port
    _wait_height(node, 1)
    tx_b = b"provekey=proveval"
    res = _rpc(port, "broadcast_tx_commit", {"tx": base64.b64encode(tx_b).decode()})
    assert res["tx_result"]["code"] == 0
    tx_hash = hashlib.sha256(tx_b).hexdigest().upper()
    deadline = time.monotonic() + 10
    got = None
    while got is None and time.monotonic() < deadline:
        try:
            got = _rpc(port, "tx", {"hash": tx_hash, "prove": True})
        except RuntimeError:
            time.sleep(0.1)
    assert got is not None, "tx never indexed"
    pj = got["proof"]
    assert pj is not None and base64.b64decode(pj["data"]) == tx_b
    blk = _rpc(port, "block", {"height": res["height"]})
    assert pj["root_hash"] == blk["block"]["header"]["data_hash"]
    proof = merkle.Proof(total=int(pj["proof"]["total"]), index=int(pj["proof"]["index"]),
                         leaf_hash=base64.b64decode(pj["proof"]["leaf_hash"]),
                         aunts=[base64.b64decode(a) for a in pj["proof"]["aunts"]])
    assert proof.verify(bytes.fromhex(pj["root_hash"]), tx_b)
    ts = _rpc(port, "tx_search", {"query": "app.key='provekey'", "prove": True})
    assert int(ts["total_count"]) == 1
    assert ts["txs"][0]["proof"]["root_hash"] == pj["root_hash"]


def test_full_disk_wal_fail_stop_e2e(node):
    """The JAX case: ENOSPC on the WAL halts consensus, flips /health to
    503, and the black-box journal decodes to a postmortem attributing the
    halt to ``disk_fatal`` on the wal surface."""
    import errno

    from cometbft_tpu_torch.libs import diskguard, storage_stats

    port = node.rpc_server.bound_port
    _wait_height(node, 2)
    url = f"http://127.0.0.1:{port}/health"
    plan = diskguard.FaultPlan()
    plan.add(surface="wal", path_substr="cs.wal", kind=diskguard.KIND_ERRNO,
             err=errno.ENOSPC)
    prev = diskguard.set_fault_plan(plan)
    try:
        deadline = time.monotonic() + 30
        cs = node.consensus
        while cs.storage_fatal_err is None and time.monotonic() < deadline:
            time.sleep(0.05)
        err = cs.storage_fatal_err
        assert err is not None, "node kept running on a full disk"
        assert err.surface == "wal" and err.io_errno == errno.ENOSPC
        h = node.block_store.height()
        time.sleep(0.5)
        assert node.block_store.height() == h
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=20)
        assert ei.value.code == 503
        assert "storage" in json.loads(ei.value.read())["error"]["message"]
        # forensics survive the halt: the journal (a degradable surface,
        # untouched by the wal rule) pins the fail-stop on the wal surface
        bb_dir = node._blackbox.dir
        node.stop()
        from cometbft_tpu_torch.libs import blackbox

        report = blackbox.postmortem_report(bb_dir)
        assert report["anomaly_counts"].get("disk_fatal", 0) >= 1, report[
            "anomaly_counts"]
        fatal = [a for a in report["anomalies"] if a.get("kind") == "disk_fatal"]
        assert fatal, report["anomalies"]
        attrs = fatal[-1].get("attrs") or {}
        assert attrs.get("surface") == "wal" and attrs.get("errno") == errno.ENOSPC
        assert report["clean_close"]
    finally:
        diskguard.set_fault_plan(prev)
        storage_stats.reset()


# -- rollback and confix against the JAX package -------------------------------


def _chain_home(pkg: str, root, heights: int = 4):
    """A home whose ``data/chain.db`` holds a seeded ``torch_chain`` chain."""
    home = root / pkg
    cfg = _m(pkg, "config.config").default_config()
    cfg.base.home = str(home)
    cfg.base.db_backend = "sqlite"
    (home / cfg.base.db_dir).mkdir(parents=True)
    db = _m(pkg, "store.kv").SqliteKV(str(home / cfg.base.db_dir / "chain.db"),
                                      surface="state")
    kw = {"executor_kw": {"device": "cpu"}, "pool_kw": {"device": "cpu"}} \
        if pkg == PORT else {}
    if pkg == PORT:
        from cometbft_tpu_torch.crypto import ed25519_ref as ref
        from cometbft_tpu_torch.ops import supervisor as tsup
        import numpy as np

        def oracle(backend, pubs, msgs, sigs, lanes):
            out = np.zeros(lanes, dtype=bool)
            out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
            return out

        tsup.set_device_runner(oracle)
        try:
            torch_chain.drive(pkg, heights=heights, db=db, **kw)
        finally:
            tsup.clear_device_runner()
    else:
        torch_chain.drive(pkg, heights=heights, db=db, **kw)
    db.close()
    return cfg


def _dump(pkg: str, cfg) -> list:
    db = _m(pkg, "store.kv").SqliteKV(os.path.join(cfg.base.home, cfg.base.db_dir,
                                                   "chain.db"), surface="state")
    try:
        return list(db.iterate(b"", None))
    finally:
        db.close()


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_rollback_equals_the_jax_package(tmp_path, hard):
    out = {}
    for pkg in (JAX, PORT):
        cfg = _chain_home(pkg, tmp_path)
        before = _dump(pkg, cfg)
        got = _m(pkg, "node.rollback").rollback_state(cfg, remove_block=hard)
        out[pkg] = (got, before, _dump(pkg, cfg))
    assert out[JAX] == out[PORT]
    assert out[PORT][0][0] == 3 and out[PORT][1] != out[PORT][2]


def test_rollback_errors_equal_the_jax_package(tmp_path):
    msgs = []
    for pkg in (JAX, PORT):
        cfg = _m(pkg, "config.config").default_config()
        cfg.base.home = str(tmp_path / pkg)
        cfg.base.db_backend = "sqlite"
        os.makedirs(os.path.join(cfg.base.home, cfg.base.db_dir))
        with pytest.raises(Exception) as ei:
            _m(pkg, "node.rollback").rollback_state(cfg)
        msgs.append((type(ei.value).__name__, str(ei.value)))
    assert msgs[0] == msgs[1]


OLD_TOML = """# an old config.toml
moniker = "carried-node"
log_level = "debug"
retired_key = 7

[rpc]
laddr = "tcp://127.0.0.1:36657"
unsafe = true
gone_too = "x"

[mempool]
size = 1234

[consensus]
timeout_commit_ms = 250
"""


@pytest.mark.parametrize("dry_run", [False, True], ids=["write", "dry-run"])
def test_confix_equals_the_jax_package(tmp_path, dry_run):
    """The same report (the backup's path relative to its home) and the same
    rewritten file, less its first line, which names the package."""
    out = {}
    for pkg in (JAX, PORT):
        home = tmp_path / pkg
        (home / "config").mkdir(parents=True)
        (home / "config" / "config.toml").write_text(OLD_TOML)
        rep = _m(pkg, "config.confix").upgrade(str(home), dry_run=dry_run)
        if rep["backup"]:
            rep["backup"] = os.path.relpath(rep["backup"], home)
        text = (home / "config" / "config.toml").read_text().split("\n", 1)[1]
        out[pkg] = (rep, text)
    assert out[JAX] == out[PORT]
    assert out[PORT][0]["unknown"] == ["retired_key", "rpc.gone_too"]


def test_cmd_confix_and_compact_db(tmp_path, capfd):
    home = tmp_path / "h"
    (home / "config").mkdir(parents=True)
    (home / "config" / "config.toml").write_text(OLD_TOML)
    assert cli_main(["--home", str(home), "confix"]) == 0
    assert "unknown (dropped): retired_key" in capfd.readouterr().out
    assert cli_main(["--home", str(home), "compact-db"]) == 1  # no database yet


# -- a JAX home carried across ---------------------------------------------------


def _jax_node(home: str, extra=None):
    jcli = _m(JAX, "cmd.main").main
    jcfg = _m(JAX, "config.config")
    if not os.path.exists(os.path.join(home, "config", "genesis.json")):
        assert jcli(["--home", home, "init", "--chain-id", "carried-chain"]) == 0
    cfg = jcfg.load_config(home)
    cfg.base.home = home
    _fast(cfg, "sqlite")
    for k, v in (extra or {}).items():
        section, _, key = k.partition(".")
        setattr(getattr(cfg, section), key, v)
    return _m(JAX, "node.node").Node(cfg), cfg


def test_port_node_continues_a_jax_home(tmp_path):
    home = str(tmp_path / "carried")
    jn, jcfg = _jax_node(home)
    jn.start()
    try:
        _wait_height(jn, 2)
        port = jn.rpc_server.bound_port
        res = _rpc(port, "broadcast_tx_commit",
                   {"tx": base64.b64encode(b"carried=yes").decode()})
        assert res["tx_result"]["code"] == 0
        _wait_height(jn, int(res["height"]) + 1)
        hashes = [jn.block_store.load_block_meta(h).block_id.hash
                  for h in range(1, int(res["height"]) + 1)]
        tx_hash = hashlib.sha256(b"carried=yes").hexdigest().upper()
        deadline = time.monotonic() + 10
        while True:  # indexed by the JAX node's service before it stops
            try:
                _rpc(port, "tx", {"hash": tx_hash})
                break
            except RuntimeError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
    finally:
        jn.stop()
    top = None
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    _fast(cfg, "sqlite")
    pn = Node(cfg, device="cpu")
    pn.start()
    try:
        top = pn.block_store.height()
        _wait_height(pn, top + 2)
        assert [pn.block_store.load_block_meta(h).block_id.hash
                for h in range(1, len(hashes) + 1)] == hashes
        port = pn.rpc_server.bound_port
        got = _rpc(port, "tx", {"hash": tx_hash, "prove": True})
        assert got["height"] == res["height"] and got["proof"] is not None
        assert _rpc(port, "abci_query", {"path": "/store", "data": b"carried".hex()})
    finally:
        pn.stop()


# -- cross-package follow over a real link ---------------------------------------


def _port_node(home: str, genesis_from: str = "", extra=None):
    if not os.path.exists(os.path.join(home, "config")):
        assert cli_main(["--home", home, "init", "--chain-id", "carried-chain"]) == 0
    if genesis_from:
        with open(os.path.join(genesis_from, "config", "genesis.json")) as f:
            g = f.read()
        with open(os.path.join(home, "config", "genesis.json"), "w") as f:
            f.write(g)
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    _fast(cfg, "sqlite")
    for k, v in (extra or {}).items():
        section, _, key = k.partition(".")
        setattr(getattr(cfg, section), key, v)
    return Node(cfg, device="cpu"), cfg


def _address(n) -> str:
    return f"{n.node_key.node_id}@{n._node_info.listen_addr}"


@pytest.mark.parametrize("validator", [JAX, PORT], ids=["port-follows-jax",
                                                        "jax-follows-port"])
def test_a_full_node_follows_the_other_package(tmp_path, monkeypatch, validator):
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE", "0")
    monkeypatch.setenv("COMETBFT_TPU_AEAD", "0")
    vhome, fhome = str(tmp_path / "validator"), str(tmp_path / "follower")
    if validator == JAX:
        v, _ = _jax_node(vhome)
    else:
        v, _ = _port_node(vhome)
    v.start()
    f = None
    try:
        _wait_height(v, 2)
        # the goal is a height the validator reached before the follower is
        # built: the one-validator chain commits ~10 blocks a second, and a
        # goal read after the build raced it (the follower blocksyncs a
        # block every 2-3 s on the CPU)
        goal = v.block_store.height() + 2
        peers = {"p2p.persistent_peers": [_address(v)]}
        if validator == JAX:
            f, _ = _port_node(fhome, genesis_from=vhome, extra=peers)
        else:
            jcli = _m(JAX, "cmd.main").main
            assert jcli(["--home", fhome, "init", "--chain-id", "carried-chain"]) == 0
            with open(os.path.join(vhome, "config", "genesis.json")) as src, \
                    open(os.path.join(fhome, "config", "genesis.json"), "w") as dst:
                dst.write(src.read())
            f, _ = _jax_node(fhome, extra=peers)
        f.start()
        _wait_height(f, goal, timeout=60)
        assert [f.block_store.load_block_meta(h).block_id.hash for h in range(1, goal + 1)] \
            == [v.block_store.load_block_meta(h).block_id.hash for h in range(1, goal + 1)]
    finally:
        if f is not None:
            f.stop()
        v.stop()


# -- the device rule, the options that raise, the commands that wait ---------------


def test_node_and_cmd_start_raise_without_a_card(tmp_path, monkeypatch):
    home = str(tmp_path / "nocard")
    assert cli_main(["--home", home, "init"]) == 0
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    with pytest.raises(RuntimeError):
        Node(_fast(cfg))
    with pytest.raises(RuntimeError):
        cli_main(["--home", home, "start"])


# the modules the option table once named, all ported: route, answer
SERVED = {"node/pprof": ("/debug/pprof/goroutine", b"Thread"),
          "libs/metrics": ("/metrics", b"cometbft_consensus_height")}


def _served(n, option: str, module: str) -> None:
    """The option's module at work on a running node ``n``."""
    if module in SERVED:
        route, want = SERVED[module]
        srv = n.pprof_server if module == "node/pprof" else n.metrics_server
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.bound_port}{route}",
                                    timeout=20) as resp:
            assert resp.status == 200 and want in resp.read()
    elif module == "rpc/grpc_server":
        from cometbft_tpu_torch.proto_gen.cometbft.services.pruning.v1 import (
            pruning_pb2 as prune,
        )
        from cometbft_tpu_torch.proto_gen.cometbft.services.version.v1 import (
            version_pb2 as ver,
        )
        from cometbft_tpu_torch.rpc.grpc_server import grpc_unary, make_client_channel

        privileged = option == "grpc.privileged_laddr"
        srv = n.grpc_privileged_server if privileged else n.grpc_server
        assert (n.grpc_server is None) == privileged
        ch = make_client_channel(f"127.0.0.1:{srv.bound_port}")
        try:
            if privileged:
                svc = "cometbft.services.pruning.v1.PruningService"
                grpc_unary(ch, svc, "SetBlockIndexerRetainHeight",
                           prune.SetBlockIndexerRetainHeightRequest(height=1),
                           prune.SetBlockIndexerRetainHeightResponse)
                got = grpc_unary(ch, svc, "GetBlockIndexerRetainHeight",
                                 prune.GetBlockIndexerRetainHeightRequest(),
                                 prune.GetBlockIndexerRetainHeightResponse)
                assert got.height == 1
            else:
                got = grpc_unary(ch, "cometbft.services.version.v1.VersionService",
                                 "GetVersion", ver.GetVersionRequest(),
                                 ver.GetVersionResponse)
                assert (got.block, got.p2p) == (11, 9)
        finally:
            ch.close()
    elif module == "indexer/psql":
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            got = _rpc(n.rpc_server.bound_port, "block_search", {"query": "block.height>=1"})
            if int(got["total_count"]) >= 1:
                break
            time.sleep(0.05)
        assert int(got["total_count"]) >= 1 and type(n.event_sink).__name__ == "PsqlEventSink"
    else:
        zone, matrix, peer_zones = n.switch.transport.latency
        assert zone == "eu" and matrix.one_way_s("eu", "us") == 0.06 and peer_zones == {}


@pytest.mark.parametrize("option,value,module", [
    ("grpc.laddr", "tcp://127.0.0.1:0", "rpc/grpc_server"),
    ("grpc.privileged_laddr", "tcp://127.0.0.1:0", "rpc/grpc_server"),
    ("rpc.pprof_laddr", "127.0.0.1:0", "node/pprof"),
    ("instrumentation.prometheus", True, "libs/metrics"),
    ("tx_index.indexer", "psql", "indexer/psql"),
    ("p2p.zone", "eu", "p2p/latency"),
])
def test_options_not_ported_raise_naming_their_module(tmp_path, option, value, module):
    """Every option this table once refused, naming the module the port
    lacked, is ported: a node with it starts and serves it.  ``node/pprof``
    and ``libs/metrics`` serve their route (``/debug/pprof/goroutine``,
    ``/metrics``) on a port of their own; ``rpc/grpc_server`` answers
    ``GetVersion`` (public) or sets and reads back a retain height
    (privileged) through ``grpc_unary``; ``indexer/psql`` serves
    ``block_search`` from its sqlite file; ``p2p/latency`` gives the
    node's transport its zone and matrix."""
    home = str(tmp_path / "opt")
    assert cli_main(["--home", home, "init"]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    section, _, key = option.partition(".")
    setattr(getattr(cfg, section), key, value)
    if module == "libs/metrics":
        cfg.instrumentation.prometheus_listen_addr = "tcp://127.0.0.1:0"
    if option == "grpc.privileged_laddr":
        cfg.grpc.pruning_service_enabled = True
    if module == "indexer/psql":
        cfg.tx_index.psql_conn = "sqlite://" + str(tmp_path / "sink.db")
    if module == "p2p/latency":
        cfg.p2p.zone_rtt_ms = {"eu": {"eu": 20, "us": 120}}
    import tracemalloc

    tracing_before = tracemalloc.is_tracing()
    n = Node(_fast(cfg), device="cpu")
    n.start()
    try:
        _wait_height(n, 1)
        _served(n, option, module)
    finally:
        n.stop()
        if not tracing_before:  # the pprof server starts tracemalloc
            tracemalloc.stop()


@pytest.mark.parametrize("argv,module", [
    pytest.param(["sim", "--scenario", "chip-death"], "parallel/elastic",
                 id="argv0-sim/"),
    (["trace", "--local"], "libs/tracing"),
    (["postmortem", "/nonexistent"], "libs/blackbox"),
])
def test_cli_commands_that_wait_exit_non_zero(tmp_path, capfd, argv, module):
    """``sim`` is ported (``sim/``), and since ``parallel/elastic`` is too a
    scenario that drives the elastic mesh runs (on the CPU here) and
    reaches its height.  ``trace`` and ``postmortem`` are ported
    (``libs/tracing``, ``libs/blackbox``): ``trace --local`` renders this
    process's recorder, and ``postmortem`` of a directory with no journal
    exits non-zero saying so, as the JAX CLI does."""
    rc = cli_main(["--home", str(tmp_path), *argv])
    out = capfd.readouterr()
    if argv[0] == "sim":
        assert rc == 0 and "scenario=chip-death" in out.out and "reached=True" in out.out
    elif argv[0] == "trace":
        assert rc == 0 and "flight recorder: on" in out.out
    else:
        assert rc != 0 and "no black-box journal under /nonexistent" in out.err


def test_cmd_trace_and_postmortem_equal_the_jax_cli(tmp_path, capfd):
    """``cmd trace`` of a live port node and ``cmd postmortem`` of its
    stopped home print what the JAX CLI prints on the same node and home,
    human and ``--json``."""
    from cometbft_tpu.cmd.main import main as jax_main

    home = str(tmp_path / "traced")
    assert cli_main(["--home", home, "init", "--chain-id", "trace-chain"]) == 0
    cfg = cfgmod.load_config(home)
    cfg.base.home = home
    n = Node(_fast(cfg), device="cpu")
    n.start()
    try:
        _wait_height(n, 3)
        n.consensus.stop()  # the ring stands still between the two reads
        capfd.readouterr()
        rpc = f"tcp://127.0.0.1:{n.rpc_server.bound_port}"
        got = {}
        for name, cli in (("jax", jax_main), ("port", cli_main)):
            for extra in ([], ["--json"]):
                assert cli(["trace", "--rpc", rpc, "--spans", "16", *extra]) == 0
                got[(name, bool(extra))] = capfd.readouterr().out
    finally:
        n.stop()
    assert got[("port", False)] == got[("jax", False)]
    assert got[("port", True)] == got[("jax", True)]
    doc = json.loads(got[("port", True)])
    assert "verify.commit" in doc["stages"] and doc["node"]["latest_block_height"]
    for extra in ([], ["--json"]):
        outs = []
        for cli in (jax_main, cli_main):
            assert cli(["postmortem", home, *extra]) == 0
            outs.append(capfd.readouterr().out)
        assert outs[1] == outs[0]
    report = json.loads(outs[1])
    assert report["clean_close"] and report["last_committed_height"] >= 3


def test_cmd_testnet_show_and_reset(tmp_path, capfd):
    out = tmp_path / "net"
    assert cli_main(["--home", str(tmp_path), "testnet", "--v", "3", "--o", str(out),
                     "--chain-id", "tn"]) == 0
    gens = {(out / f"node{i}" / "config" / "genesis.json").read_text() for i in range(3)}
    assert len(gens) == 1 and len(json.loads(gens.pop())["validators"]) == 3
    home = str(out / "node0")
    capfd.readouterr()
    assert cli_main(["--home", home, "show-node-id"]) == 0
    assert len(capfd.readouterr().out.strip()) == 40
    assert cli_main(["--home", home, "show-validator"]) == 0
    assert json.loads(capfd.readouterr().out)["type"] == "tendermint/PubKeyEd25519"
    assert cli_main(["--home", home, "unsafe-reset-all"]) == 0
    assert cli_main(["--home", home, "version"]) == 0


# -- admission against a commit (a departure, ROADMAP §3) ---------------------------


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_a_tx_committed_during_its_check_stays_out_of_the_mempool(pkg):
    """A block carrying tx T commits (``update`` under the mempool's lock)
    while T's own ``check_tx`` waits in the app.  The port's admission holds
    that lock, as the reference's CheckTx read-locks its updateMtx, so the
    commit waits and T leaves the mempool; the JAX package's does not, and T
    stays in, to be proposed again (a double inclusion seen in phase 21)."""
    import threading

    at = _m(pkg, "abci.types")
    mp_mod = _m(pkg, "mempool.clist_mempool")
    inside, release = threading.Event(), threading.Event()

    class SlowApp:
        def check_tx(self, req):
            inside.set()
            assert release.wait(10)
            return at.CheckTxResponse(code=0)

    mp = mp_mod.CListMempool(_m(pkg, "config.config").MempoolConfig(recheck=False),
                             SlowApp(), height=1)
    tx = b"raced=1"
    checker = threading.Thread(target=mp.check_tx, args=(tx,))
    checker.start()
    assert inside.wait(10)

    def commit():
        mp.lock()
        try:
            mp.update(2, [tx], [at.ExecTxResult(code=0)])
        finally:
            mp.unlock()

    committer = threading.Thread(target=commit)
    committer.start()
    time.sleep(0.2)  # the commit is waiting on the lock (port) or done (JAX)
    release.set()
    for t in (checker, committer):
        t.join(10)
        assert not t.is_alive()
    assert mp.size() == (0 if pkg == PORT else 1)
