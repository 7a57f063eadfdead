"""Scenario differentials of the elastic mesh: ``chip-death``,
``mesh-brownout`` and ``combined-storm`` run on ``device="cpu"`` beside the
JAX package's at seed 3, as its tests run them (``tests/test_sim.py``).
Both packages configure four virtual ordinals with the host oracle at
``parallel/elastic``'s mesh runner seam.  ``tests/torch_sim.py``'s
``assert_same_runs`` holds the two results to each other: the trace line
for line, the commit hash at every height, ``summary()`` (with the mesh's
width, shrinks and restores), every stats block, every journal record and
anomaly dump, with the JAX package's tier names mapped through
``torch_sim.TIER`` and nothing else.  Then ``combined-storm`` under the
card's rule on a stand-in card (the port alone: the JAX package has no such
rule).  Each test has a wall bound.
"""

from __future__ import annotations

import pytest

import torch_sim

CASES = ("chip-death", "mesh-brownout", "combined-storm")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    torch_sim.reset_caches()
    with torch_sim.wall_bound(300):
        yield


@pytest.mark.parametrize("name", CASES)
def test_mesh_scenario_equals_jax(tmp_path, name):
    j, p = torch_sim.run_pair(name, 3, tmp_path)
    torch_sim.assert_same_runs(j, p, tmp_path)
    b = p.backend
    assert b["mesh_shrinks"] >= 1 and "mesh_width" in b, b
    if name != "combined-storm":
        assert b["mesh_restores"] >= 1, b


def test_combined_storm_under_the_cards_rule_reaches_its_height(tmp_path, monkeypatch):
    """The card's rule on a stand-in card: the supervisor treats the CPU as
    the card (a batch the device tier did not serve raises, nothing answers
    below it), the host oracle stands in for the kernel at the mesh's and
    the supervisor's seams.  A vote check that raised is not consumed: the
    cluster offers the input again (``ConsensusState.on_unserved``), as a
    peer's gossip would, so the storm still reaches its height, with no
    signature answered by the host and the burst's raised items counted in
    the trace."""
    from cometbft_tpu_torch.ops import supervisor
    from cometbft_tpu_torch.sim import scenarios as psc

    monkeypatch.setattr(supervisor, "_on_card", lambda device: True)
    monkeypatch.setattr(psc, "on_card", lambda cluster: False)
    res = psc.run_scenario("combined-storm", 3, root=tmp_path, device="cpu")
    assert res.reached and not res.violations, res.heights
    assert res.backend["fallback_signatures"] == 0, res.backend
    assert res.sched["shed"]["consensus"] == 0, res.sched
    assert any("raised unserved" in ln for ln in res.trace)
    assert any(" unserved node" in ln for ln in res.trace)
