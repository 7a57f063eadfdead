"""Deterministic simulation harness: the virtual clock and ticker, the
seeded faulty network, node assembly and the safety invariants.  The
JAX package's ``SimCluster``, its scenarios and the sim's blocksync wait
for ROADMAP "Node assembly" stage (d); ``tests/torch_sim.py`` drives a
cluster of these parts in the meantime.
"""

from cometbft_tpu_torch.sim.clock import SimTicker, VirtualClock
from cometbft_tpu_torch.sim.invariants import InvariantChecker, InvariantViolation
from cometbft_tpu_torch.sim.network import LinkConfig, SimNetwork

__all__ = [
    "InvariantChecker",
    "InvariantViolation",
    "LinkConfig",
    "SimNetwork",
    "SimTicker",
    "VirtualClock",
]
