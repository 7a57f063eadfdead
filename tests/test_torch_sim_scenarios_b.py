"""Scenario differentials, part B (churn, evidence and storage): each of the port's scenarios
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
    ("fleet-churn", 3, {"n_vals": 8}),
    ("light-attack", 3, {}),
    ("dup-vote-flood", 3, {}),
    ("statesync-storm", 3, {}),
    ("validator-rotation", 3, {}),
    ("byzantine-voter", 3, {}),
    ("asymmetric-loss", 42, {}),
    ("crash-restart", 42, {}),
    ("torn-wal-restart", 7, {}),
    ("disk-full", 7, {}),
    ("disk-brownout", 7, {}),
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
