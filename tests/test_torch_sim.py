"""Whole-network differentials: four validators of each package's
``sim/cluster.SimCluster`` on one seeded virtual-time network, driven by
``tests/torch_sim.py``'s scripts, with the invariant checker raising on any
violation.

For the clean, crash-restart and lossy-link scripts both packages commit
the same chain: equal block hashes, app hashes and WAL ``#ENDHEIGHT`` sets
at every height on every node, and the same event trace line for line
(each delivered vote and proposal with its signature's prefix).  The port
runs on ``device="cpu"``; both packages' gates stay closed
(``COMETBFT_TPU_CRYPTO_BACKEND=cpu``), so votes are checked on the host and
no JAX program is compiled.  The node's device rule (``build_node``
resolves the batch backend on the card before it returns) is checked on a
stand-in card.
"""

from __future__ import annotations

import importlib
import json

import pytest
import torch

import torch_sim

J, P = "cometbft_tpu", torch_sim.PORT


@pytest.fixture(autouse=True)
def _host_only(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("COMETBFT_TPU_PROOFSERVE", "0")


def _run(pkg, root, script, seed=42, heights=5):
    dev = {"device": "cpu"} if pkg == P else {}
    return torch_sim.run_script(pkg, root / pkg, script, seed=seed, heights=heights, **dev)


def _node_mod(pkg):
    return importlib.import_module(f"{pkg}.sim.node")


@pytest.mark.parametrize("script,heights", [("clean", 5), ("crash", 6), ("lossy", 5)])
def test_both_packages_commit_the_same_chain(tmp_path, script, heights):
    jax_c, port_c = (_run(pkg, tmp_path, script, heights=heights) for pkg in (J, P))
    try:
        for c in (jax_c, port_c):
            assert min(c.heights()) >= heights
            assert not c.checker.violations
            assert c.checker.commits_verified >= 4 * heights
        chain = torch_sim.chain(port_c, heights)
        assert chain == torch_sim.chain(jax_c, heights)
        for node in chain.values():
            assert len(set(node["blocks"])) == heights
            assert node["ends"] == list(range(1, heights + 1))
        assert len({tuple(n["blocks"]) for n in chain.values()}) == 1
        assert len({tuple(n["apps"]) for n in chain.values()}) == 1
        assert port_c.trace == jax_c.trace
        if script == "crash":
            assert any("restart node1" in line for line in port_c.trace)
            # the restarted node replayed its WAL and signed after it
            node = port_c.nodes[1]
            addr = port_c.privs[1].pub_key().address()
            last = node.block_store.load_seen_commit(heights)
            assert any(cs.validator_address == addr for cs in last.signatures)
        if script == "lossy":
            assert port_c.net.stats.dropped_rate > 0
            assert port_c.net.stats.dropped_rate == jax_c.net.stats.dropped_rate
    finally:
        torch_sim.stop(jax_c)
        torch_sim.stop(port_c)


def test_same_seed_same_trace_in_the_port(tmp_path):
    runs = [_run(P, tmp_path / sub, "lossy", seed=7) for sub in ("a", "b")]
    assert runs[0].trace == runs[1].trace
    assert torch_sim.chain(runs[0], 5) == torch_sim.chain(runs[1], 5)
    other = _run(P, tmp_path / "c", "lossy", seed=8)
    assert other.trace != runs[0].trace
    # last built, first stopped: each cluster gives the tracer back the
    # black-box sinks it found, and only while its own are installed
    for c in (other, *reversed(runs)):
        torch_sim.stop(c)


def test_build_node_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    node_mod = _node_mod(P)
    privs, gdoc = node_mod.make_genesis(1, "device-rule")
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        node_mod.build_node(0, privs[0], gdoc, tmp_path / "a")
    node = node_mod.build_node(0, privs[0], gdoc, tmp_path / "b", device="cpu")
    assert node.cs.block_exec.device == "cpu"
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    node_mod.build_node(0, privs[0], gdoc, tmp_path / "c")


@pytest.mark.parametrize("device,resolves", [(None, True), ("cuda", True),
                                             ("cuda:0", True), ("cpu", False)])
def test_build_node_opens_the_scheduler_gate_on_the_card(tmp_path, monkeypatch,
                                                         device, resolves):
    """On a stand-in card (``resolve_device`` answers a CUDA device, the
    kernel's self-check is recorded), ``build_node`` has run the batch
    seam's self-check before it returns, so the scheduler takes the
    node's first vote."""
    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import verify as ov

    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")

    def stand_in(d=None):
        dev = torch.device("cuda" if d is None else d)
        return torch.device("cuda", 0) if dev.type == "cuda" else dev

    monkeypatch.setattr(ov, "resolve_device", stand_in)
    monkeypatch.setattr(cbatch, "_SELF_CHECKED", set())
    checks = []
    monkeypatch.setattr(cbatch, "gpu_self_check", lambda dev: checks.append(str(dev)))
    node_mod = _node_mod(P)
    privs, gdoc = node_mod.make_genesis(1, "device-rule")
    assert not verifysched.scheduler_active()
    node_mod.build_node(0, privs[0], gdoc, tmp_path, device=device)
    assert checks == (["cuda:0"] if resolves else [])
    assert verifysched.scheduler_active() == resolves


def _oracle(backend, pubs, msgs, sigs, lanes):
    import numpy as np

    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
    return out


def test_statesync_join_through_handle_provider_equals_jax(tmp_path):
    """Node 3 drops out at height 2 and comes back at height 8 as a fresh
    machine: its light client reads the helper's stores through
    ``HandleProvider`` and ``build_node`` takes the restored app
    (``app``/``app_conns``).  Both packages give the same light blocks, the
    same trace and the same chain; the joiner holds blocks from its
    snapshot's height on.  The port's light-client batches go through the
    supervisor's device-runner seam (the oracle)."""
    import torch_chain

    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.ops import supervisor

    heights = 10
    sigcache.reset_cache()
    supervisor.set_device_runner(_oracle)
    try:
        jax_c, port_c = (_run(pkg, tmp_path, "join", heights=heights) for pkg in (J, P))
    finally:
        supervisor.clear_device_runner()
    try:
        for c in (jax_c, port_c):
            assert min(c.heights()) >= heights
            assert not c.checker.violations
        assert port_c.trace == jax_c.trace
        assert "join node3 statesync complete h=5" in " ".join(port_c.trace)
        for pkg, c in ((J, jax_c), (P, port_c)):
            helper = _node_mod(pkg).HandleProvider(c.nodes[0], torch_sim.CHAIN_ID)
            assert helper.id() == "simnode:0" and helper.chain_id() == torch_sim.CHAIN_ID
        codecs = [torch_chain.modules(pkg).codec for pkg in (J, P)]
        for h in range(1, heights + 1):
            blocks = [codec.encode_light_block(_node_mod(pkg).HandleProvider(
                c.nodes[0], torch_sim.CHAIN_ID).light_block(h))
                for codec, pkg, c in zip(codecs, (J, P), (jax_c, port_c))]
            assert blocks[0] == blocks[1], h
        joiner = port_c.nodes[3]
        assert joiner.block_store.base() == 6
        assert joiner.app_conns.query.info().last_block_height >= heights
        chain = torch_sim.chain(port_c, heights)
        assert chain == torch_sim.chain(jax_c, heights)
        assert chain[3]["blocks"] == chain[0]["blocks"][5:]
        assert chain[3]["apps"] == chain[0]["apps"][5:]
        from cometbft_tpu_torch.light.provider import ErrLightBlockNotFound

        with pytest.raises(ErrLightBlockNotFound):
            _node_mod(P).HandleProvider(port_c.nodes[0], torch_sim.CHAIN_ID).light_block(99)
    finally:
        torch_sim.stop(jax_c)
        torch_sim.stop(port_c)


@pytest.mark.parametrize("script,heights", [("clean", 5), ("crash", 6)])
def test_span_streams_and_journals_equal_the_jax_package(tmp_path, script, heights):
    """The flight recorder on the virtual clock and a black box per node
    (``tests/torch_sim.py``, as the JAX ``SimCluster`` installs them): both
    packages record the same span stream and write the same journal bytes
    on every node.  The one difference by construction is a path: the
    journals sit under each package's own directory (``_journals`` reads
    them relative to it)."""
    runs = {pkg: _run(pkg, tmp_path, script, heights=heights) for pkg in (J, P)}
    try:
        streams = {pkg: json.dumps(c.tracer.tail(0), sort_keys=True)
                   for pkg, c in runs.items()}
        rounds = {pkg: json.dumps(c.tracer.rounds_report(), sort_keys=True)
                  for pkg, c in runs.items()}
        for c in runs.values():
            torch_sim.stop(c)  # every journal closes with its clean-close sentinel
        journals = {pkg: _journals(tmp_path / pkg) for pkg in runs}
    finally:
        for c in runs.values():
            torch_sim.stop(c)
    assert streams[P] == streams[J]
    assert rounds[P] == rounds[J]
    assert journals[P] == journals[J]
    spans = json.loads(streams[P])
    stages = {s["stage"] for s in spans}
    assert {"consensus.round", "consensus.step", "consensus.vote",
            "consensus.proposal", "verify.commit"} <= stages
    assert len(journals[P]) == 4 and all(journals[P].values())
    if script == "crash":
        (pm,) = runs[P].postmortems
        assert not pm["report"]["clean_close"] and pm["report"]["in_flight"]
        assert pm == runs[J].postmortems[0]


def _journals(root) -> dict:
    out = {}
    for d in sorted(root.glob("node*/blackbox")):
        for f in sorted(d.iterdir()):
            out[str(f.relative_to(root))] = f.read_bytes()
    return out
