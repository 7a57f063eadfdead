"""The port's ``cmd sim`` against the JAX CLI's, and the port's simulator
alone: its scenario list, its determinism, and the device rule of
``run_scenario``.

``cmd sim --list`` prints the JAX CLI's lines, all 28; ``cmd sim
--scenario crash-restart --json`` prints the JAX CLI's summary, and so
does each of the three elastic-mesh scenarios (journal byte counts aside:
they follow the lengths of the tier names in the records, which
``tests/test_torch_sim_mesh.py`` compares one by one).  Both CLIs run in
this process with
``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` (the port's ``sim`` then runs on the
CPU).  On the card's side: with no card and no CPU asked for,
``run_scenario`` raises; on a card no host-oracle stand-in is installed at
any seam (a ``cuda`` test).
"""

from __future__ import annotations

import json

import pytest
import torch

import torch_sim
from cometbft_tpu_torch.cmd.main import main as port_main
from cometbft_tpu_torch.sim import scenarios as psc

MESH = ("chip-death", "mesh-brownout", "combined-storm")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    torch_sim.reset_caches()
    with torch_sim.wall_bound(240):
        yield


def _cli(main, argv, capfd):
    # the journals hold the scenario's own records, as in ``run_pair``
    with torch_sim.own_threads_only():
        rc = main(argv)
    out = capfd.readouterr()
    return rc, out.out, out.err


def test_list_is_the_jax_list(capfd):
    from cometbft_tpu.cmd.main import main as jax_main

    rc_j, out_j, _ = _cli(jax_main, ["sim", "--list"], capfd)
    rc_p, out_p, _ = _cli(port_main, ["sim", "--list"], capfd)
    assert rc_j == rc_p == 0
    assert out_p.splitlines() == out_j.splitlines()
    assert len(out_p.splitlines()) == len(psc.SCENARIOS) == 28
    assert set(MESH) <= set(psc.SCENARIOS)


def test_scenarios_are_the_jax_scenarios():
    from cometbft_tpu.sim import scenarios as jsc

    assert list(psc.SCENARIOS) == list(jsc.SCENARIOS)
    for name, sc in psc.SCENARIOS.items():
        j = jsc.SCENARIOS[name]
        assert (sc.description, sc.n_vals, sc.target_height, sc.max_time,
                sc.n_spares) == (j.description, j.n_vals, j.target_height,
                                 j.max_time, j.n_spares), name


def test_json_summary_equals_the_jax_cli(capfd):
    from cometbft_tpu.cmd.main import main as jax_main

    argv = ["sim", "--scenario", "crash-restart", "--json"]
    rc_j, out_j, _ = _cli(jax_main, argv, capfd)
    rc_p, out_p, _ = _cli(port_main, argv, capfd)
    assert rc_j == rc_p == 0
    assert json.loads(out_p) == torch_sim.map_tiers(json.loads(out_j))
    row = json.loads(out_p)
    assert row["reached"] and row["invariants_ok"] and row["seed"] == 42


def _without_journal_bytes(row: dict) -> dict:
    for k in ("bytes", "disk_bytes"):
        row.get("blackbox", {}).pop(k, None)
    return row


@pytest.mark.parametrize("name", MESH)
def test_mesh_scenario_json_summary_equals_the_jax_cli(capfd, name):
    from cometbft_tpu.cmd.main import main as jax_main

    argv = ["sim", "--scenario", name, "--seed", "3", "--json"]
    rc_j, out_j, _ = _cli(jax_main, argv, capfd)
    rc_p, out_p, _ = _cli(port_main, argv, capfd)
    assert rc_j == rc_p == 0
    row = _without_journal_bytes(json.loads(out_p))
    assert row == torch_sim.map_tiers(_without_journal_bytes(json.loads(out_j)))
    assert row["reached"] and row["invariants_ok"] and row["seed"] == 3
    assert row["backend"]["mesh_shrinks"] >= 1


def test_same_seed_same_trace_two_seeds_diverge(tmp_path):
    """The port alone: ``baseline`` twice at seed 42 gives the same trace,
    commit hashes and event count; seeds 1 and 2 give different traces."""
    runs = []
    for sub in ("a", "b"):
        res = psc.run_scenario("baseline", 42, root=tmp_path / sub,
                               keep_cluster=True, device="cpu")
        hashes = [res.cluster.commit_hash(h)
                  for h in range(1, res.target_height + 1)]
        runs.append((res.trace, hashes, res.events))
    assert runs[0] == runs[1]
    r1, r2 = (psc.run_scenario("baseline", s, root=tmp_path / str(s),
                               device="cpu") for s in (1, 2))
    assert r1.reached and r2.reached
    assert r1.trace != r2.trace


def test_run_scenario_without_a_card_raises(tmp_path, monkeypatch):
    """``device=None`` is the card: with none, and no CPU asked for, the
    cluster's entry point raises before any node is built."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        psc.run_scenario("baseline", 42, root=tmp_path)
    assert not list(tmp_path.glob("node*"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("light-stampede", 3), ("dial-storm", 42)])
def test_card_installs_no_stand_in(tmp_path, monkeypatch, card, name, seed):
    """On the card the setups install nothing at the seams: every Ed25519,
    tree, ladder and AEAD pass of the run is the kernel's (``cuda``)."""
    from cometbft_tpu_torch.ops import chacha_aead, dispatch_stats, sha256_tree
    from cometbft_tpu_torch.ops import supervisor, x25519_ladder

    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    installed = []
    for mod, fn in ((supervisor, "set_device_runner"), (sha256_tree, "set_tree_runner"),
                    (x25519_ladder, "set_ladder_runner"),
                    (chacha_aead, "set_aead_runner")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda f, o=orig, n=fn: (
            installed.append(n) if f is not None else None, o(f))[-1])
    dispatch_stats.reset()
    res = psc.run_scenario(name, seed, root=tmp_path, raise_on_violation=True)
    assert res.reached and not res.violations
    assert installed == []
    for kind in ("ed25519", "merkle", "x25519", "aead"):
        tiers = dispatch_stats.tier_counts(kind)
        assert tiers.get("torch", (0, 0))[0] == tiers.get("host", (0, 0))[0] == 0, kind
