"""Deterministic simulation & fault-injection harness: the port of the JAX
package's ``sim/``.

FoundationDB-style discipline: an N-validator cluster runs entirely in one
thread on *virtual* time.  Every source of scheduling nondeterminism — link
delays, drops, duplicates, reordering, partitions, crashes, churn
(statesync and blocksync joins, graceful leaves), validator-set rotation,
consensus timeouts — flows through one seeded ``random.Random`` and one
event heap (``VirtualClock``), so a failing run reproduces byte-identically
from its seed.  Invariant checkers (agreement / validity / validator-set /
WAL replay) run after every delivered event, verifying commits against the
height-correct validator set across rotations.

Entry points (``device=None`` runs on the card, ``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` on the CPU):
  * ``SimCluster``   — assemble and drive a cluster programmatically
  * ``run_scenario`` — named fault scripts (``cometbft-tpu sim`` CLI)
  * ``compose``      — merge fault scripts into combined-fault scenarios

The three elastic-mesh scenarios run over ``scenarios.SIM_MESH_WIDTH``
virtual ordinals (``parallel/elastic``).
"""

from cometbft_tpu_torch.sim.clock import SimTicker, VirtualClock
from cometbft_tpu_torch.sim.cluster import SimCluster
from cometbft_tpu_torch.sim.invariants import InvariantChecker, InvariantViolation
from cometbft_tpu_torch.sim.network import LinkConfig, SimNetwork
from cometbft_tpu_torch.sim.scenarios import SCENARIOS, compose, run_scenario

__all__ = [
    "SCENARIOS",
    "InvariantChecker",
    "InvariantViolation",
    "LinkConfig",
    "SimCluster",
    "SimNetwork",
    "SimTicker",
    "VirtualClock",
    "compose",
    "run_scenario",
]
