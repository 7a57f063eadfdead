"""The port's light-client proxy (``light/proxy.py``) against the JAX
package's, in front of a primary that tells the truth and one that lies.

Each package builds the same seeded ``tests/torch_chain.py`` chain (equal
bytes) and serves it through its own ``rpc/server.RPCServer``: the primary.
A ``LightProxy`` over each package's ``LightClient`` and ``HTTPProvider``
reads it.  The same requests must get the same JSON from both proxies:
verified ``commit``, ``validators``, ``header`` and ``block`` at every
height (skipping hops first, then adjacent ones), forwarded routes, and,
on a tampered primary (a header's app hash changed, a validator set
swapped, a block's bytes changed), the same error.  ``light_status`` and
some errors name the primary's URL, which differs by port: left out and
named in ``LEFT_OUT``.  The JAX
package runs on its CPU backend; the port's client on ``device="cpu"``
with the supervisor's device-runner seam answering from the oracle.
"""

from __future__ import annotations

import importlib
import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import torch_chain

from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup

JAX, PORT = "cometbft_tpu", "cometbft_tpu_torch"
PKGS = (JAX, PORT)
HEIGHTS = 6
NOW = torch_chain.T0 + 500.0
PERIOD = 10_000
# the response fields left out of the comparison, by route
LEFT_OUT = {"light_status": "primary (the primary's URL: its port differs)",
            "errors": "the primary's URL in a message, written <primary>"}


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


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


_CHAINS: dict = {}


def _chain(pkg: str):
    if pkg not in _CHAINS:
        kw = {"executor_kw": {"device": "cpu"}, "pool_kw": {"device": "cpu"}} \
            if pkg == PORT else {}
        tsup.set_device_runner(_oracle)
        _CHAINS[pkg] = torch_chain.drive(pkg, heights=HEIGHTS, evidence_at=0, **kw)[0]
    return _CHAINS[pkg]


class _Primary:
    """``pkg``'s RPC server over the chain's stores; ``lie`` rewrites one
    route's answer at one height (the same way in both packages)."""

    def __init__(self, pkg: str, lie=None):
        c = _chain(pkg)
        node = SimpleNamespace(
            block_store=c.block_store, state_store=c.state_store,
            consensus=SimpleNamespace(state=c.state), genesis_doc=c.genesis,
            node_key=SimpleNamespace(node_id="cd" * 20), priv_validator=c.privs[0],
            evidence_pool=c.pool, config=_m(pkg, "config.config").default_config(),
            switch=None, mempool=None, proxy_app=None)
        env = _m(pkg, "rpc.core").Environment(node)
        if lie is not None:
            route, height, edit = lie
            real = getattr(env, route)

            def lying(*a, **kw):
                doc = real(*a, **kw)
                if int(kw.get("height") or 0) == height:
                    edit(doc)
                return doc

            setattr(env, route, lying)
        cfg = _m(pkg, "config.config").default_config().rpc
        cfg.laddr = "tcp://127.0.0.1:0"
        self.server = _m(pkg, "rpc.server").RPCServer(cfg, env, None)
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.bound_port}"


def _proxy(pkg: str, primary: _Primary):
    c = _chain(pkg)
    lc, lv, ls, lp = (_m(pkg, f"light.{n}") for n in ("client", "verifier", "store",
                                                        "provider"))
    prov = lp.HTTPProvider(torch_chain.CHAIN_ID, primary.url)
    trust = lv.TrustOptions(period_s=PERIOD, height=1,
                            hash=c.block_store.load_block_meta(1).block_id.hash)
    extra = {"device": "cpu"} if pkg == PORT else {}
    client = lc.LightClient(torch_chain.CHAIN_ID, trust, prov, [],
                            ls.LightStore(c.m.kv.MemKV()), now_fn=lambda: NOW, **extra)
    proxy = _m(pkg, "light.proxy").LightProxy(client, primary.url, laddr="tcp://127.0.0.1:0")
    proxy.start()
    return proxy


def _ask(proxy, primary, method: str, params: dict) -> dict:
    body = json.dumps({"jsonrpc": "2.0", "id": 9, "method": method,
                       "params": params}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{proxy.bound_port}/", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        doc = json.loads(resp.read().decode().replace(primary.url, "<primary>"))
    if method == "light_status" and "result" in doc:
        doc["result"].pop("primary")
    return doc


def _set_app_hash(doc):
    doc["signed_header"]["header"]["app_hash"] = "AB" * 32


def _swap_validator(doc):
    doc["validators"][0]["voting_power"] = "999"


def _set_block_txs(doc):
    doc["block"]["data"]["txs"] = doc["block"]["data"]["txs"][:-1]
    doc["block_id"]["hash"] = "CD" * 32


READS = [("commit", h) for h in (3, 5, 2, 4, 6)] + [
    ("validators", 5), ("header", 3), ("block", 4), ("block", 6), ("commit", 0),
    ("light_status", None), ("genesis", None), ("status", None), ("nope", None)]


@pytest.mark.parametrize("lie", [
    None,
    ("commit", 4, _set_app_hash),
    ("validators", 5, _swap_validator),
    ("block", 6, _set_block_txs),
], ids=["honest", "app-hash", "validators", "block"])
def test_proxy_answers_and_errors_equal_the_jax_package(lie):
    got = {}
    for pkg in PKGS:
        primary = _Primary(pkg, lie)
        proxy = _proxy(pkg, primary)
        try:
            got[pkg] = [_ask(proxy, primary, m, {} if h is None else {"height": str(h)})
                        for m, h in READS]
        finally:
            proxy.stop()
            primary.server.stop()
    assert got[JAX] == got[PORT]
    errors = [d for d in got[PORT] if "error" in d]
    if lie is None:  # only the unknown route
        assert len(errors) == 1 and "nope" in errors[0]["error"]["message"]
    else:  # the lie is caught, and nothing else fails but the unknown route
        assert len(errors) >= 2


def test_proxy_client_follows_the_device_rule(monkeypatch):
    """A proxy's light client with no card and no CPU asked for raises
    when it is built (``cmd light`` builds it on the card)."""
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    primary = _Primary(PORT)
    try:
        with pytest.raises(RuntimeError):
            lc = _m(PORT, "light.client")
            lv = _m(PORT, "light.verifier")
            lc.LightClient(torch_chain.CHAIN_ID, lv.TrustOptions(PERIOD, 1, b"\x00" * 32),
                           _m(PORT, "light.provider").HTTPProvider(torch_chain.CHAIN_ID,
                                                                   primary.url),
                           [], _m(PORT, "light.store").LightStore(_m(PORT, "store.kv").MemKV()))
    finally:
        primary.server.stop()
