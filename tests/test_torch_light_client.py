"""The port's light client (``light/client.py``, ``light/store.py``,
``light/provider.py``) held to the JAX package's on one seeded
``tests/torch_chain.py`` chain built in each package (the same bytes):
sequential and skipping sync (with bisection), a witness that diverges
(the error, and the attack evidence reported both ways, byte for byte),
prune, the store's bytes, and ``HTTPProvider``'s parsing of one JSON-RPC
document served by a stub ``http.server`` (the JAX ``rpc/core`` encoders).

The JAX package runs on its CPU backend (``COMETBFT_TPU_CRYPTO_BACKEND=cpu``);
the port's client on ``device="cpu"`` with the supervisor's device-runner
seam answering from the oracle, so no plain verify runs.
"""

import http.server
import json
import sys
import threading
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_chain  # noqa: E402

from cometbft_tpu.light import client as jlc  # noqa: E402
from cometbft_tpu.light import provider as jprov  # noqa: E402
from cometbft_tpu.light import store as jls  # noqa: E402
from cometbft_tpu.light import verifier as jlv  # noqa: E402
from cometbft_tpu.rpc import core as jrpc  # noqa: E402

from cometbft_tpu_torch.crypto import backend_health as tbh  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from cometbft_tpu_torch.crypto import sigcache as tsc  # noqa: E402
from cometbft_tpu_torch.light import client as tlc  # noqa: E402
from cometbft_tpu_torch.light import provider as tprov  # noqa: E402
from cometbft_tpu_torch.light import store as tls  # noqa: E402
from cometbft_tpu_torch.light import verifier as tlv  # noqa: E402
from cometbft_tpu_torch.ops import dispatch_stats as tds  # noqa: E402
from cometbft_tpu_torch.ops import supervisor as tsup  # noqa: E402

JAX, PORT = "cometbft_tpu", "cometbft_tpu_torch"
CPU = {"device": "cpu"}
HEIGHTS = 8
NOW = torch_chain.T0 + 500.0
PERIOD = 10_000


def _oracle(backend, pubs, msgs, sigs, lanes):
    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
    return out


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()
    tsup.set_device_runner(_oracle)
    yield
    tsup.clear_device_runner()


_CHAINS = {}


def _chain(pkg: str, seed: int = 20261039):
    """The seeded chain of ``pkg`` (built once a module): 8 heights, 8 txs
    each, validator 1 to power 20 at height 2 (the set changes at 4), the
    last validator absent from every commit."""
    key = (pkg, seed)
    if key not in _CHAINS:
        kw = {"executor_kw": CPU, "pool_kw": CPU} if pkg == PORT else {}
        tsup.set_device_runner(_oracle)
        _CHAINS[key] = torch_chain.drive(pkg, heights=HEIGHTS, evidence_at=0, seed=seed,
                                         **kw)[0]
    return _CHAINS[key]


class Recorder:
    """A provider over a chain's stores (the JAX ``NodeProvider`` on a
    stand-in node) that records the evidence reported to it."""

    def __init__(self, pkg: str, chain, name: str):
        prov = jprov if pkg == JAX else tprov
        node = SimpleNamespace(genesis_doc=chain.genesis, block_store=chain.block_store,
                               state_store=chain.state_store, evidence_pool=chain.pool,
                               node_key=SimpleNamespace(node_id=name * 6),
                               consensus=SimpleNamespace(state=chain.state))
        self.inner = prov.NodeProvider(node)
        self.codec = chain.m.codec
        self.reported = []

    def chain_id(self):
        return self.inner.chain_id()

    def id(self):
        return self.inner.id()

    def light_block(self, height):
        return self.inner.light_block(height)

    def consensus_params(self, height):
        return self.inner.consensus_params(height)

    def report_evidence(self, ev):
        self.reported.append(self.codec.encode_evidence(ev))


def _client(pkg: str, mode: str, witnesses=(), **kw):
    chain = _chain(pkg)
    lc, lv, ls = (jlc, jlv, jls) if pkg == JAX else (tlc, tlv, tls)
    primary = Recorder(pkg, chain, "p")
    trust = lv.TrustOptions(period_s=PERIOD, height=1,
                            hash=primary.light_block(1).hash())
    store = ls.LightStore(chain.m.kv.MemKV())
    extra = CPU if pkg == PORT else {}
    client = lc.LightClient(torch_chain.CHAIN_ID, trust, primary, list(witnesses), store,
                            mode=mode, now_fn=lambda: NOW, **kw, **extra)
    return client, primary, store


def _store_bytes(store) -> list:
    return list(store._db.iterate(b"lb/", b"lb/\xff"))


@pytest.mark.parametrize("mode,target,level", [
    ("sequential", HEIGHTS, None), ("skipping", HEIGHTS, None),
    ("skipping", HEIGHTS, Fraction(4, 5))])
def test_sync_equals_jax(mode, target, level):
    """Verified header and store, byte for byte; ``Fraction(4, 5)`` makes
    the trusted set too weak for the jump, so the client bisects."""
    got = {}
    for pkg in (JAX, PORT):
        kw = {"trust_level": level} if level is not None else {}
        client, _, store = _client(pkg, mode, **kw)
        lb = client.verify_light_block_at_height(target)
        got[pkg] = (lb.hash(), store.heights(), _store_bytes(store),
                    client.update().hash(), client.trusted_light_block(0).height)
    assert got[JAX] == got[PORT]
    heights = got[PORT][1]
    if mode == "sequential":
        assert heights == list(range(1, target + 1))
    elif level is None:
        assert heights == [1, target]
    else:
        assert len(heights) > 2  # bisection stored the midpoints it trusted


def test_verify_errors_equal():
    """Below the trusted root, an expired trusted header, a bad trust hash."""
    got = {}
    for pkg in (JAX, PORT):
        lc = jlc if pkg == JAX else tlc
        out = []
        client, primary, store = _client(pkg, "skipping")
        client.verify_light_block_at_height(5)
        store.prune(1)
        for call in (lambda: client.verify_light_block_at_height(3),
                     lambda: client.verify_light_block_at_height(7, now=NOW + 10 * PERIOD)):
            try:
                call()
                out.append(None)
            except lc.LightClientError as e:
                out.append((type(e).__name__, str(e)))
        lv = jlv if pkg == JAX else tlv
        try:
            lc.LightClient(torch_chain.CHAIN_ID, lv.TrustOptions(PERIOD, 1, bytes(32)), primary,
                           [], (jls if pkg == JAX else tls).LightStore(
                               _chain(pkg).m.kv.MemKV()), now_fn=lambda: NOW,
                           **(CPU if pkg == PORT else {}))
        except lc.LightClientError as e:
            out.append((type(e).__name__, str(e)))
        got[pkg] = out
    assert got[JAX] == got[PORT]
    assert [o[0] for o in got[PORT]] == ["LightClientError", "ErrOldHeaderExpired",
                                         "LightClientError"]


def test_witness_divergence_equals_jax():
    """A witness on another chain of the same id: the header is not
    trusted, the error names it, and attack evidence goes both ways."""
    got = {}
    for pkg in (JAX, PORT):
        other = _chain(pkg, seed=20261041)
        witness = Recorder(pkg, other, "w")
        client, primary, store = _client(pkg, "skipping", witnesses=[witness])
        with pytest.raises((jlc if pkg == JAX else tlc).ErrLightClientDivergence) as e:
            client.verify_light_block_at_height(6)
        got[pkg] = (str(e.value), store.heights(), primary.reported, witness.reported)
    assert got[JAX] == got[PORT]
    assert got[PORT][1] == [1] and len(got[PORT][2]) == len(got[PORT][3]) == 1


def test_prune_equals_jax():
    got = {}
    for pkg in (JAX, PORT):
        client, _, store = _client(pkg, "sequential")
        client.verify_light_block_at_height(HEIGHTS)
        n = client.prune(3)
        got[pkg] = (n, store.heights(), _store_bytes(store), store.size(),
                    store.first().height, store.light_block_before(7).height)
    assert got[JAX] == got[PORT] == (got[PORT][0], [6, 7, 8], got[PORT][2], 3, 6, 6)


def test_light_client_takes_the_card_by_default(monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND", raising=False)
    chain = _chain(PORT)
    primary = Recorder(PORT, chain, "p")
    trust = tlv.TrustOptions(PERIOD, 1, primary.light_block(1).hash())
    with pytest.raises(Exception, match="(?i)cuda|device|card"):
        tlc.LightClient(torch_chain.CHAIN_ID, trust, primary, [],
                        tls.LightStore(chain.m.kv.MemKV()), now_fn=lambda: NOW)
    from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider

    with pytest.raises(Exception, match="(?i)cuda|device|card"):
        LightClientStateProvider(torch_chain.CHAIN_ID, [primary], trust, now_fn=lambda: NOW)
    sp = LightClientStateProvider(torch_chain.CHAIN_ID, [primary], trust, now_fn=lambda: NOW,
                                  device="cpu")
    assert sp.client.device == "cpu"


# -- HTTPProvider against a stub JSON-RPC server -----------------------------


class _Rpc(http.server.BaseHTTPRequestHandler):
    chain = None

    def do_POST(self):  # noqa: N802 — http.server's name
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        p, c = req["params"], self.chain
        h = int(p.get("height", c.block_store.height()))
        try:
            if req["method"] == "commit":
                meta = c.block_store.load_block_meta(h)
                commit = c.block_store.load_block_commit(h) or c.block_store.load_seen_commit(h)
                if meta is None:
                    raise KeyError(f"height {h} not found")
                res = {"signed_header": {"header": jrpc._header_json(meta.header),
                                         "commit": jrpc._commit_json(commit)}}
            elif req["method"] == "validators":
                vals = c.state_store.load_validators(h).validators
                per, page = int(p["per_page"]), int(p["page"])
                items = [{"address": v.address.hex().upper(),
                          "pub_key": {"type": "tendermint/PubKeyEd25519",
                                      "value": jrpc._b64(v.pub_key.bytes())},
                          "voting_power": str(v.voting_power),
                          "proposer_priority": str(v.proposer_priority)}
                         for v in vals][(page - 1) * per: page * per]
                res = {"validators": items, "total": str(len(vals))}
            elif req["method"] == "consensus_params":
                from cometbft_tpu.state.state import _params_to_json

                res = {"consensus_params": _params_to_json(
                    c.state_store.load_consensus_params(h))}
            else:
                res = {}
            body = {"jsonrpc": "2.0", "id": 1, "result": res}
        except KeyError as e:
            body = {"jsonrpc": "2.0", "id": 1, "error": {"code": -32603,
                                                         "message": str(e.args[0])}}
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_http_provider_parses_like_jax():
    handler = type("H", (_Rpc,), {"chain": _chain(JAX)})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"127.0.0.1:{srv.server_address[1]}"
        jp = jprov.HTTPProvider(torch_chain.CHAIN_ID, url, timeout=10)
        tp = tprov.HTTPProvider(torch_chain.CHAIN_ID, "tcp://" + url, timeout=10)
        assert jp.base_url == tp.base_url == "http://" + url
        for h in (0, 1, 4, HEIGHTS):
            jb = _chain(JAX).m.codec.encode_light_block(jp.light_block(h))
            tb = _chain(PORT).m.codec.encode_light_block(tp.light_block(h))
            assert jb == tb, h
        assert (_chain(PORT).m.state._params_to_json(tp.consensus_params(3))
                == _chain(JAX).m.state._params_to_json(jp.consensus_params(3)))
        for prov, mod in ((jp, jprov), (tp, tprov)):
            with pytest.raises(mod.ErrLightBlockNotFound):
                prov.light_block(HEIGHTS + 5)
    finally:
        srv.shutdown()
        srv.server_close()
    for prov, mod in ((jprov.HTTPProvider(torch_chain.CHAIN_ID, url, timeout=2), jprov),
                      (tprov.HTTPProvider(torch_chain.CHAIN_ID, url, timeout=2), tprov)):
        with pytest.raises(mod.ErrNoResponse):
            prov.light_block(1)
