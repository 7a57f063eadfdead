"""A node's p2p stack wired in either package by name, as the JAX package's
``node/node.py`` ``_setup_p2p`` (:350-466) and ``on_start`` (:595-605)
wire it.

``build("cometbft_tpu", ...)`` and ``build("cometbft_tpu_torch", ...)`` give
the same stack: a ``NodeKey``, a ``Transport`` and a ``Switch`` listening
on ``127.0.0.1:0`` (the advertised address fixed up with the bound port),
and whichever of the consensus, blocksync, mempool, evidence and PEX
reactors the caller's parts allow, with the node info advertising the
union of their channels.  ``from_handle`` wires a validator that
``sim/node.build_node`` assembled.  The port's transport and blocksync
reactor take ``device`` (None: the card); the JAX package's take none.
Statesync and ``txingest`` are left out.

The module imports neither package at the top: ``chip_smoke.py`` loads it
to wire phase 19's nodes on the card, and the jax-free subprocess of
``tests/test_torch_import_audit.py`` drives the port with it.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import time
from types import SimpleNamespace
from typing import Optional

PORT = "cometbft_tpu_torch"
LOCALHOST = "127.0.0.1"

_MODULES = {
    "nodekey": "node.nodekey",
    "node_info": "p2p.node_info",
    "transport": "p2p.transport",
    "switch": "p2p.switch",
    "pex": "p2p.pex",
    "conn": "p2p.conn",
    "reactor": "p2p.reactor",
    "consensus_reactor": "consensus.reactor",
    "mempool_reactor": "mempool.reactor",
    "evidence_reactor": "evidence.reactor",
    "blocksync_reactor": "blocksync.reactor",
    "config": "config.config",
    "keys": "crypto.keys",
    "version": "version",
}


def modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}")
                              for k, v in _MODULES.items()})


def node_key(pkg: str, name: bytes):
    """A deterministic node key: the Ed25519 seed is SHA-256 of ``name``."""
    m = modules(pkg)
    return m.nodekey.NodeKey(m.keys.Ed25519PrivKey.from_seed(hashlib.sha256(name).digest()))


class NetNode:
    """One node's switch and reactors, listening and ready to start."""

    def __init__(self, pkg, key, info, transport, switch, reactors, addr_book, port):
        self.pkg = pkg
        self.key = key
        self.info = info
        self.transport = transport
        self.switch = switch
        self.reactors = reactors
        self.addr_book = addr_book
        self.port = port

    @property
    def node_id(self) -> str:
        return self.key.node_id

    @property
    def address(self) -> str:
        """``id@127.0.0.1:port``, as a persistent peer names this node."""
        return f"{self.node_id}@{LOCALHOST}:{self.port}"

    def start(self, persistent_peers=()) -> None:
        """Start the switch (and so the reactors), then dial the
        persistent peers, as the JAX node's ``on_start`` does."""
        self.switch.start()
        if persistent_peers:
            self.switch.dial_peers_async(list(persistent_peers), persistent=True)

    def stop(self) -> None:
        if self.switch.is_running:
            self.switch.stop()
        else:
            self.transport.close()

    def wait_peers(self, n: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while len(self.switch.peers_list()) < n:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True


def build(
    pkg: str,
    key,
    chain_id: str,
    *,
    p2p_config=None,
    mempool_config=None,
    cs=None,
    block_store=None,
    state=None,
    block_exec=None,
    mempool=None,
    evidence_pool=None,
    block_sync: bool = False,
    home: Optional[str] = None,
    moniker: str = "",
    logger=None,
    device=None,
    extra_reactors=(),
) -> NetNode:
    """The reactors are those whose parts are given: consensus with ``cs``
    and ``block_store``; blocksync with ``state``, ``block_exec`` and
    ``block_store`` (syncing when ``block_sync``, serving always); mempool
    with ``mempool``; evidence with ``evidence_pool``; PEX when the config
    says ``pex`` (its book under ``home``, in memory without one).
    ``extra_reactors`` are (name, reactor) pairs added last."""
    m = modules(pkg)
    cfg = p2p_config if p2p_config is not None else m.config.P2PConfig()
    log = (lambda module: logger.with_(module=module)) if logger is not None else (
        lambda module: None)
    info = m.node_info.NodeInfo(
        node_id=key.node_id, network=chain_id, moniker=moniker,
        version=m.version.CMT_SEMVER)
    tkw = {"device": device} if pkg == PORT else {}
    transport = m.transport.Transport(
        key, lambda: info, handshake_timeout=cfg.handshake_timeout_s,
        dial_timeout=cfg.dial_timeout_s, **tkw)
    sw = m.switch.Switch(cfg, transport, lambda: info, logger=log("p2p"))
    reactors = {}
    consensus = None
    if cs is not None:
        consensus = reactors["CONSENSUS"] = m.consensus_reactor.ConsensusReactor(
            cs, block_store, wait_sync=block_sync, logger=log("consensus-reactor"))
    if state is not None and block_store is not None:
        reactors["BLOCKSYNC"] = m.blocksync_reactor.BlocksyncReactor(
            state, block_exec, block_store, consensus_reactor=consensus,
            enabled=block_sync, logger=log("blocksync"), **tkw)
    if mempool is not None:
        mcfg = mempool_config if mempool_config is not None else m.config.MempoolConfig()
        reactors["MEMPOOL"] = m.mempool_reactor.MempoolReactor(
            mcfg, mempool, logger=log("mempool-reactor"))
    if evidence_pool is not None:
        reactors["EVIDENCE"] = m.evidence_reactor.EvidenceReactor(
            evidence_pool, logger=log("evidence-reactor"))
    book = None
    if cfg.pex:
        path = os.path.join(home, cfg.addr_book_file) if home else ""
        book = m.pex.AddrBook(path, strict=cfg.addr_book_strict)
        book.add_our_id(key.node_id)
        reactors["PEX"] = m.pex.PEXReactor(
            book, seeds=cfg.seeds, seed_mode=cfg.seed_mode, logger=log("pex"))
        sw.addr_book = book
    for name, reactor in list(reactors.items()) + list(extra_reactors):
        sw.add_reactor(name, reactor)
    info.channels = bytes(sorted(sw._chan_to_reactor.keys()))
    _, port = transport.listen(f"tcp://{LOCALHOST}:0")
    info.listen_addr = f"{LOCALHOST}:{port}"
    return NetNode(pkg, key, info, transport, sw, {**reactors, **dict(extra_reactors)},
                   book, port)


def from_handle(pkg: str, handle, key, chain_id: str, *, block_sync: Optional[bool] = None,
                **kw) -> NetNode:
    """Wire a validator assembled by ``sim/node.build_node``: consensus,
    blocksync, mempool, evidence and PEX.  ``block_sync`` defaults to the
    JAX node's rule: sync unless this node is the only validator."""
    cs = handle.cs
    if block_sync is None:
        vals = cs.state.validators
        only_us = (len(vals) == 1 and vals.validators[0].address
                   == handle.priv_val.pub_key().address())
        block_sync = not only_us
    return build(pkg, key, chain_id, cs=cs, block_store=handle.block_store,
                 state=cs.state, block_exec=cs.block_exec, mempool=handle.mempool,
                 evidence_pool=handle.evidence_pool, block_sync=block_sync, **kw)
