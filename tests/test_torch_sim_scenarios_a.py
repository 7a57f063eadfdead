"""Scenario differentials, part A (the blocksync and partition scenarios): each of the port's scenarios
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
    ("wan-catchup", 7, {}),
    ("baseline", 42, {}),
    ("message-storm", 42, {}),
    ("partition-minority", 42, {}),
    ("partition-leader", 42, {}),
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


def test_blocksync_storm_equals_jax_without_the_progress_rule(tmp_path, monkeypatch):
    """The port's block pool restarts a delivering peer's request clocks
    (its progress rule, a departure from the JAX pool pinned in ROADMAP
    §3); ``COMETBFT_TPU_BSYNC_ADAPTIVE=0`` takes both pools to fixed
    timeouts, where they are bit for bit.  Seed 3, as the JAX package's
    kill-switch test runs this scenario."""
    monkeypatch.setenv("COMETBFT_TPU_BSYNC_ADAPTIVE", "0")
    j, p = torch_sim.run_pair("blocksync-storm", 3, tmp_path)
    torch_sim.assert_same_runs(j, p, tmp_path)
    assert p.bsync["heights_synced"] >= 40 and p.bsync["probes"] == 0


def test_blocksync_storm_with_the_progress_rule(tmp_path):
    """The port alone at the JAX test's seed, its pool's progress rule on:
    the joiner syncs the catchup span through the storm, times out on
    dropped replies, bans a helper, probes it half-open and re-admits it,
    dies mid-catchup and resumes, and promotes; agreement and validity
    hold.  (The JAX test also asserts a forged body redone: under the
    progress rule no forged body is redone at this seed, ``redos`` 0,
    where the JAX pool redoes 18.)"""
    res = torch_sim.sim(torch_sim.PORT).run_scenario(
        "blocksync-storm", 7, root=tmp_path, raise_on_violation=True,
        device="cpu")
    assert res.reached and not res.violations, res.heights
    b = res.bsync
    assert b["heights_synced"] >= 40, b
    assert b["timeouts"] >= 1 and b["bans"] >= 1, b
    assert b["probes"] >= 1 and b["probe_passes"] >= 1, b
    assert any("crashed mid-catchup" in ln for ln in res.trace)
    assert any("blocksync peer banned" in ln for ln in res.trace)
    assert any("probe passed, peer re-admitted" in ln for ln in res.trace)
    done = [ln for ln in res.trace if "bsync node" in ln and "complete h=" in ln]
    assert done and "dispatches=" in done[-1]
