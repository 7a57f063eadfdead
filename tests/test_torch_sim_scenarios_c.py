"""Scenario differentials, part C (the crypto planes under load and faults): each of the port's scenarios
(``sim/scenarios``) run on ``device="cpu"`` beside the JAX package's at the
seed and size its JAX test uses (``tests/test_sim.py``; seed 42 where that
file runs none), both on their host-oracle seams.  ``tests/torch_sim.py``'s
``assert_same_runs`` holds the two results to each other: the trace line
for line, the commit hash at every height, ``summary()``, every stats
block, every journal record and anomaly dump, with the JAX package's tier
names mapped through ``torch_sim.TIER`` and nothing else.  Both packages
run with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` outside the scenarios' own
setups, and each test has a wall bound.
"""

from __future__ import annotations

import pytest

import torch_sim

# (scenario, seed, run_scenario overrides) as the JAX tests run them
CASES = [
    ("dial-storm", 42, {}),
    ("backend-brownout", 3, {}),
    ("backend-wedge", 5, {}),
    ("backend-flap", 2, {}),
    ("gossip-burst", 3, {}),
    ("light-stampede", 3, {}),
    ("pipeline-burst", 3, {}),
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    torch_sim.reset_caches()
    with torch_sim.wall_bound(300):
        yield


@pytest.mark.parametrize("name,seed,kw", CASES, ids=[c[0] for c in CASES])
def test_scenario_equals_jax(tmp_path, name, seed, kw):
    j, p = torch_sim.run_pair(name, seed, tmp_path, **kw)
    torch_sim.assert_same_runs(j, p, tmp_path)


def test_tx_flood_equals_jax(tmp_path, monkeypatch):
    """Seed 3, as the JAX test runs it.  Two settings of the test, both
    for the JAX side's sake: its secp256k1 signer draws a random nonce
    (``cryptography``'s ECDSA), so its envelopes are signed here by the
    port's RFC 6979 signer, the bytes the port's scenario signs; and both
    packages take the host oracle at their tree-runner seams
    (``sha256_tree.set_tree_runner(host_tree_runner)``), which keeps a block
    of 32 or more txs off the JAX package's XLA tree (its scenario installs
    no tree runner, and that compile has held the JAX test past the suite's
    limit)."""
    from cometbft_tpu.crypto import secp256k1 as jsecp
    from cometbft_tpu.ops import sha256_tree as jtree

    from cometbft_tpu_torch.crypto import secp256k1 as psecp
    from cometbft_tpu_torch.ops import sha256_tree as ptree

    monkeypatch.setattr(jsecp.Secp256k1PrivKey, "sign",
                        lambda self, msg: psecp.Secp256k1PrivKey(self.secret).sign(msg))
    jtree.set_tree_runner(jtree.host_tree_runner)
    ptree.set_tree_runner(ptree.host_tree_runner)
    try:
        j, p = torch_sim.run_pair("tx-flood", 3, tmp_path)
    finally:
        jtree.clear_tree_runner()
        ptree.clear_tree_runner()
    torch_sim.assert_same_runs(j, p, tmp_path)
    assert p.ingest["shed_to_sync"] > 0 and p.sched["shed"]["consensus"] == 0
