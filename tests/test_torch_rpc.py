"""The port's JSON-RPC (``rpc/core.py``, ``rpc/server.py``) against the JAX
package's, over one chain built to equal bytes in both packages.

``tests/torch_sim.py`` runs its ``clean`` script (four validators on
virtual time, 16 txs a height, 5 heights) in each package; node 0's stores,
consensus state, mempool, app and event bus stand behind each package's
``Environment``, with a kv tx and block index built from the stored
FinalizeBlock responses.  Every read route, ``tx?prove=true``, the paged
and ordered searches and the error cases must give equal JSON.  The chain
is on the virtual clock, so its block times are equal too; what differs by
construction is named in ``LEFT_OUT``: the genesis time, which each
package stamps from the wall clock, and the trace document's wall-clock
readings and health values (the node's identity is one stub in both).
Each package's flight recorder runs on its cluster's virtual clock
(``tests/torch_sim.py``), so span ids, times and stages are compared.  The server is then held to the same
bytes over HTTP POST, URI GET, batches and the websocket.
"""

from __future__ import annotations

import base64
import importlib
import json
import socket
import time
import urllib.request
from types import SimpleNamespace

import pytest

import torch_sim

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")

# route -> what is left out of the comparison, and why
LEFT_OUT = {
    # each package's GenesisDoc.validate_and_complete stamps a zero genesis
    # time with the wall clock when its cluster is built: a time field
    "genesis": "genesis.genesis_time",
    "genesis_chunked": "genesis_time inside the base64 data",
    # the trace document's wall-clock readings (the recorder's overhead,
    # its lifetime totals) and each package's own health sections, which
    # read that package's process-wide stats (``_trace_view``)
    "debug_verify_trace": "overhead and lifetime; the health sections' values",
    # the websocket upgrade head carries the server's clock to the second:
    # two servers can answer in different seconds
    "websocket": "the Date: line of the upgrade head",
}


def _without_date(head: bytes) -> bytes:
    """The upgrade head with its ``Date:`` line taken out (``LEFT_OUT``)."""
    lines = head.split(b"\r\n")
    assert sum(ln.startswith(b"Date: ") for ln in lines) == 1, head
    return b"\r\n".join(ln for ln in lines if not ln.startswith(b"Date: "))


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _node(pkg: str, root):
    c = torch_sim.run_script(pkg, root / pkg, "clean", heights=5, txs_per_height=16,
                             device="cpu" if pkg.endswith("_torch") else None)
    h = c.nodes[0]
    kv = _m(pkg, "indexer.kv")
    idx = _m(pkg, "store.kv").MemKV()
    txi, bli = kv.KVTxIndexer(idx), kv.KVBlockIndexer(idx)
    fbr = _m(pkg, "state.execution").fbr_from_json
    for height in range(1, h.block_store.height() + 1):
        res = fbr(h.state_store.load_finalize_block_response(height))
        bli.index(height, res.events)
        for i, tx in enumerate(h.block_store.load_block(height).data.txs):
            txi.index(height, i, tx, res.tx_results[i])
    node = SimpleNamespace(
        block_store=h.block_store, state_store=h.state_store, consensus=h.cs,
        genesis_doc=c.gdoc, node_key=SimpleNamespace(node_id="ab" * 20),
        priv_validator=h.priv_val, mempool=h.mempool, proxy_app=h.app_conns,
        tx_indexer=txi, block_indexer=bli, switch=None, evidence_pool=h.evidence_pool,
        event_bus=h.event_bus, config=_m(pkg, "config.config").default_config())
    return SimpleNamespace(cluster=c, node=node,
                           env=_m(pkg, "rpc.core").Environment(node))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    try:
        root = tmp_path_factory.mktemp("rpc")
        out = {pkg: _node(pkg, root) for pkg in PKGS}
        yield out
    finally:
        for n in out.values():
            torch_sim.stop(n.cluster)
        mp.undo()


def _scrub(route: str, doc):
    """``doc`` without the fields ``LEFT_OUT`` names for ``route``."""
    if doc is None:
        return doc
    if route == "genesis":
        doc["genesis"].pop("genesis_time")
    if route == "genesis_chunked":
        g = json.loads(base64.b64decode(doc["data"]))
        g.pop("genesis_time")
        doc["data"] = json.dumps(g, sort_keys=True)
    return doc


def _trace_view(doc: dict) -> dict:
    """The trace document less ``LEFT_OUT["debug_verify_trace"]``: the
    recorder's wall-clock overhead and lifetime totals, and the values of
    each health section, which reads its own package's process-wide stats
    (the port's warm boot counts nvcc builds where the JAX package counts
    XLA executables; its dispatch counters have no mesh): each section is
    only held to render, without an import error."""
    doc = json.loads(json.dumps(doc))
    for k in ("overhead_seconds", "lifetime"):
        doc["tracing"].pop(k)
    for name in HEALTH_SECTIONS:
        sec = doc[name]
        doc[name] = isinstance(sec, dict) and "error" not in sec
    return doc


# the sections of the trace document that read process-wide stats
HEALTH_SECTIONS = ("backend", "sigcache", "dispatch", "sched", "warmboot", "ingest",
                   "device", "blackbox", "storage", "proofserve", "blocksync")


def _call(pkg_node, pkg: str, route: str, params: dict):
    """``(result, None)`` or ``(None, (code, message))``."""
    core = _m(pkg, "rpc.core")
    fn = getattr(pkg_node.env, core.ROUTES.get(route) or core.UNSAFE_ROUTES[route])
    try:
        return _scrub(route, json.loads(json.dumps(fn(**core.coerce_params(params))))), None
    except core.RPCError as e:
        return None, (e.code, e.message)
    except Exception as e:  # noqa: BLE001 - the server turns these into -32603
        return None, (type(e).__name__, str(e))


def _both(nodes, route: str, params=None):
    params = params or {}
    got = [_call(nodes[p], p, route, params) for p in PKGS]
    assert got[0] == got[1], (route, params)
    return got[1]


def _a_tx_hash(nodes) -> str:
    blk = nodes[PKGS[1]].node.block_store.load_block(3)
    return _m(PKGS[1], "crypto.tmhash").sum256(blk.data.txs[5]).hex().upper()


READS = [
    ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
    ("genesis_chunked", {"chunk": "0"}), ("genesis_chunked", {"chunk": "3"}),
    ("blockchain", {}), ("blockchain", {"min_height": "2", "max_height": "4"}),
    ("block", {}), ("block", {"height": "2"}), ("block", {"height": "99"}),
    ("block_results", {"height": "3"}), ("block_results", {}),
    ("header", {"height": "4"}), ("commit", {"height": "3"}), ("commit", {}),
    ("validators", {}), ("validators", {"height": "2", "page": "2", "per_page": "3"}),
    ("consensus_params", {"height": "2"}), ("consensus_state", {}),
    ("dump_consensus_state", {}), ("abci_info", {}),
    ("abci_query", {"path": "/store", "data": b"k3-5".hex()}),
    ("abci_query", {"path": "/store", "data": b"missing".hex()}),
    ("num_unconfirmed_txs", {}), ("unconfirmed_txs", {"limit": "5"}),
    ("unconfirmed_tx", {"hash": "AA" * 32}), ("unconfirmed_tx", {"hash": ""}),
    ("tx_search", {"query": "tx.height=3"}),
    ("tx_search", {"query": "tx.height>=2", "page": "2", "per_page": "7",
                   "order_by": "desc"}),
    ("tx_search", {"query": "tx.height<=2", "prove": "true", "per_page": "3"}),
    ("tx_search", {"query": "app.key EXISTS", "page": "3", "per_page": "10"}),
    ("tx_search", {"query": "not a query ((("}),
    ("block_search", {"query": "block.height>2", "per_page": "2"}),
    ("block_search", {"query": "block.height<=5", "order_by": "desc", "page": "2",
                      "per_page": "2"}),
    ("tx", {"hash": "00" * 32}), ("tx", {"hash": "zz"}),
    ("dial_peers", {"peers": []}), ("broadcast_evidence", {"evidence": "AAAA"}),
]


@pytest.mark.parametrize("route,params", READS, ids=lambda x: str(x)[:40])
def test_read_route_json_equals_the_jax_package(nodes, route, params):
    _both(nodes, route, params)


def test_block_and_header_by_hash_and_tx_with_proof(nodes):
    res, _ = _both(nodes, "block", {"height": "3"})
    bhash = res["block_id"]["hash"]
    _both(nodes, "block_by_hash", {"hash": bhash})
    _both(nodes, "header_by_hash", {"hash": bhash})
    got, err = _both(nodes, "tx", {"hash": _a_tx_hash(nodes), "prove": "true"})
    assert err is None and got["proof"]["root_hash"] == res["block"]["header"]["data_hash"]
    merkle = _m(PKGS[1], "crypto.merkle")
    pj = got["proof"]
    proof = merkle.Proof(total=int(pj["proof"]["total"]), index=int(pj["proof"]["index"]),
                         leaf_hash=base64.b64decode(pj["proof"]["leaf_hash"]),
                         aunts=[base64.b64decode(a) for a in pj["proof"]["aunts"]])
    assert proof.verify(bytes.fromhex(pj["root_hash"]), base64.b64decode(got["tx"]))


def test_mempool_routes_equal_the_jax_package(nodes):
    tx = base64.b64encode(b"rpc-key=rpc-value").decode()
    _both(nodes, "check_tx", {"tx": tx})
    _both(nodes, "broadcast_tx_sync", {"tx": tx})
    _both(nodes, "broadcast_tx_sync", {"tx": tx})  # in the cache now: the error
    _both(nodes, "num_unconfirmed_txs", {})
    _both(nodes, "unconfirmed_txs", {})
    _both(nodes, "unsafe_flush_mempool", {})
    _both(nodes, "num_unconfirmed_txs", {})


def test_route_tables_and_debug_routes(nodes):
    jc, pc = _m(PKGS[0], "rpc.core"), _m(PKGS[1], "rpc.core")
    assert jc.ROUTES == pc.ROUTES and jc.UNSAFE_ROUTES == pc.UNSAFE_ROUTES
    assert set(LEFT_OUT) - {"websocket"} <= set(pc.ROUTES)  # the upgrade is no route
    assert not any(k in json.dumps(_both(nodes, "block", {"height": "1"})) for k in
                   ("genesis_time",))
    docs = [_call(nodes[p], p, "debug_verify_trace", {"spans": "64"}) for p in PKGS]
    assert docs[0][1] is None and docs[1][1] is None
    assert _trace_view(docs[1][0]) == _trace_view(docs[0][0])
    assert all(_trace_view(docs[1][0])[name] for name in HEALTH_SECTIONS)
    assert docs[1][0]["stages"]["verify.commit"]["count"] > 0
    assert docs[1][0]["node"]["latest_block_height"] == "5"
    _both(nodes, "debug_postmortem", {})


# -- the server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(nodes):
    out = {}
    for pkg in PKGS:
        cfg = _m(pkg, "config.config").default_config().rpc
        cfg.laddr = "tcp://127.0.0.1:0"
        srv = _m(pkg, "rpc.server").RPCServer(cfg, nodes[pkg].env, nodes[pkg].node.event_bus)
        srv.start()
        out[pkg] = srv
    yield out
    for srv in out.values():
        srv.stop()


def _http(port: int, path: str, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=20) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port: int, doc):
    return _http(port, "/", json.dumps(doc).encode())


@pytest.mark.parametrize("path", [
    "/status", "/block?height=2", "/commit?height=3", "/validators?height=1&per_page=2",
    '/abci_query?path="/store"&data="k3-5"', "/tx_search?query=%22tx.height%3D2%22",
    "/block?height=x", "/no_such_route", "/health", "/unsafe_flush_mempool",
    "/debug/verify_trace",
])
def test_uri_get_bytes_equal(servers, path):
    got = [_http(servers[p].bound_port, path) for p in PKGS]
    if "debug" in path:  # LEFT_OUT: the document less its wall clock and health
        assert got[0][0] == got[1][0] == 200
        views = [_trace_view(json.loads(body)["result"]) for _, body in got]
        assert views[1] == views[0]
        return
    assert got[0] == got[1]


@pytest.mark.parametrize("doc", [
    {"jsonrpc": "2.0", "id": 1, "method": "block", "params": {"height": "3"}},
    {"jsonrpc": "2.0", "id": "x", "method": "tx_search",
     "params": {"query": "tx.height>3", "per_page": 5, "page": 2}},
    {"jsonrpc": "2.0", "id": 2, "method": "nope", "params": {}},
    {"jsonrpc": "2.0", "id": 3, "method": "dial_seeds", "params": {"seeds": []}},
    [{"jsonrpc": "2.0", "id": 4, "method": "health", "params": {}},
     {"jsonrpc": "2.0", "id": 5, "method": "status", "params": {}},
     {"jsonrpc": "2.0", "id": 6, "method": "commit", "params": {"height": "2"}}],
    [],
], ids=["post", "paged", "unknown", "unsafe", "batch", "empty-batch"])
def test_post_and_batch_bytes_equal(servers, doc):
    got = [_post(servers[p].bound_port, doc) for p in PKGS]
    assert got[0] == got[1]


def test_malformed_body_bytes_equal(servers):
    got = [_http(servers[p].bound_port, "/", b"{not json") for p in PKGS]
    assert got[0] == got[1]


def _ws_open(port: int):
    from cometbft_tpu_torch.rpc.server import _ws_recv

    s = socket.create_connection(("127.0.0.1", port), timeout=20)
    s.sendall((f"GET /websocket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               "Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    head = b""
    while b"\r\n\r\n" not in head:
        head += s.recv(1)
    return s, head, lambda: _ws_recv(s)


def test_websocket_subscribe_events_and_unsubscribe_bytes_equal(servers, nodes):
    from cometbft_tpu_torch.rpc.server import _ws_send

    frames = {}
    for pkg in PKGS:
        s, head, recv = _ws_open(servers[pkg].bound_port)
        got = [_without_date(head)]
        for doc in ({"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                     "params": {"query": "tm.event='NewBlock'"}},
                    {"jsonrpc": "2.0", "id": 2, "method": "subscribe",
                     "params": {"query": "bad ((("}},
                    {"jsonrpc": "2.0", "id": 3, "method": "status", "params": {}}):
            _ws_send(s, json.dumps(doc).encode())
            got.append(recv())
        ev = _m(pkg, "types.events")
        bs = nodes[pkg].node.block_store
        for h in (2, 3):
            nodes[pkg].node.event_bus.publish_new_block(
                ev.EventDataNewBlock(block=bs.load_block(h), block_id=bs.load_block_meta(h)
                                     .block_id, result_finalize_block=None))
            got.append(recv())
        _ws_send(s, json.dumps({"jsonrpc": "2.0", "id": 4, "method": "unsubscribe",
                                "params": {"query": "tm.event='NewBlock'"}}).encode())
        got.append(recv())
        s.close()
        frames[pkg] = got
    assert frames[PKGS[0]] == frames[PKGS[1]]
    assert len(frames[PKGS[1]]) == 7 and b'"height": "3"' in frames[PKGS[1]][5][1]
