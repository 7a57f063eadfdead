"""Named fault scripts for the deterministic simulator: the port of the
JAX package's ``sim/scenarios.py``.

A scenario is a list of ``Action``s — (virtual time, description, callable)
— applied to a running ``SimCluster``.  Everything an action does flows
through the cluster's seeded clock and RNG, so ``run_scenario(name, seed)``
reproduces byte-identically: same event trace, same commit hashes, same
failure (if any).

``SCENARIOS`` holds every scenario of the JAX package.  The three that
drive the elastic mesh (``chip-death``, ``mesh-brownout``,
``combined-storm``) configure ``parallel/elastic`` over ``SIM_MESH_WIDTH``
virtual ordinals: on the CPU with the host oracle at the mesh runner seam,
as the JAX setups do; on the card with no stand-in, each shard a launch of
the kernel on its virtual ordinal's stream (``_mesh_setup``).

``run_scenario(..., device=None)`` runs on the card; ``device="cpu"`` (or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu``) asks for the CPU.  The scenarios that
drive the crypto planes (``backend-*``, ``gossip-burst``,
``pipeline-burst``, ``light-stampede``, ``dial-storm``, ``tx-flood``, the
evidence and blocksync scenarios) force the supervised device path, where
the JAX package forces its ``tpu`` backend:

  * on the CPU, the gate is held open on the CPU (``verifysched.open_gate``,
    entered by the setup, closed by the teardown in ``run_scenario``'s finally)
    and the host-oracle stand-ins sit at the seams exactly where the JAX
    setups put theirs (``supervisor.set_device_runner``, the tree, ladder
    and AEAD runners), so the breaker, watchdog, injector, scheduler and
    plane machinery above them runs as on a device with no plain-version
    verify; the kernels' plain versions are the device tier (``torch``),
    the host reference answers below it, as the JAX package's host does
    below its ``xla`` tier;
  * on the card, the batch backend is resolved (the kernel's self-check)
    and a verify is run before a scenario's environment shortens the
    watchdog, and no stand-in is installed: the kernels answer.  A batch
    the kernel did not serve raises ``BackendError`` (the port's rule), so
    under the ``backend-*`` faults every Ed25519 batch is served by
    ``cuda`` or raised, where the JAX package degrades to its host.

The tier and breaker names in traces and ``summary()`` are the port's
(``cuda``, ``torch``, ``host``).  The sigcache is disabled in the backend
scenarios so that every commit verification really dispatches, the breaker
clock is pinned to the cluster's ``VirtualClock`` (so backoff windows are
deterministic), and a ``FaultyBackend`` injector is installed at scripted
virtual times.  One process hosts every sim node, so the circuit breaker
registry is shared: a victim node's failures demote the device for the
whole cluster.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time as _wall
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Optional

from cometbft_tpu_torch.config.config import MempoolConfig
from cometbft_tpu_torch.crypto.backend_health import BackendError
from cometbft_tpu_torch.ops import supervisor
from cometbft_tpu_torch.sim.cluster import SimCluster


@dataclass
class Action:
    at: float
    name: str
    fn: Callable[[SimCluster], None]


def compose(*generators: Callable[["Scenario"], list[Action]]):
    """Merge several action generators into one scenario script — the
    combined-fault composition layer.  Actions keep their scripted times;
    the virtual clock's (time, schedule-order) ordering resolves ties
    deterministically, so composing scripts never changes the members'
    individual timing."""

    def gen(s: "Scenario") -> list[Action]:
        acts: list[Action] = []
        for g in generators:
            acts.extend(g(s))
        return acts

    return gen


@dataclass
class Scenario:
    name: str
    description: str
    n_vals: int = 4
    target_height: int = 5
    max_time: float = 120.0
    # standby full nodes beyond the genesis validator set (churn/rotation
    # scenarios spawn or statesync-join them mid-run)
    n_spares: int = 0
    link_overrides: dict = field(default_factory=dict)
    actions: Callable[[Scenario], list[Action]] = lambda _s: []
    # setup runs after the cluster is built but before it starts; teardown
    # runs in run_scenario's finally (process-global state the scenario
    # touched — env knobs, fault injectors, breaker clocks — MUST be
    # restored there)
    setup: Optional[Callable[[SimCluster], None]] = None
    teardown: Optional[Callable[[SimCluster], None]] = None
    # per-node app/mempool overrides (tx-flood wraps the kvstore in the
    # SigVerifyingApp middleware and turns recheck on)
    app_factory: Optional[Callable] = None
    mempool_config: Optional[object] = None


@dataclass
class ScenarioResult:
    scenario: str
    seed: int
    n_vals: int
    target_height: int
    reached: bool
    heights: list[int]
    virtual_time: float
    events: int
    commits_verified: int
    violations: list[str]
    trace: list[str]
    cluster: Optional[SimCluster] = None
    # backend supervisor counters captured at end-of-run (backend-* fault
    # scenarios only): demotions, repromotions, watchdog_fires, breakers…
    backend: dict = field(default_factory=dict)
    # verify-scheduler counters captured at end-of-run (scenarios that
    # force the tpu backend): submitted/shed per class, flushes, dedup…
    sched: dict = field(default_factory=dict)
    # tx-ingestion counters captured at end-of-run (tx-flood): enqueued,
    # shed_to_sync, flushes, batch occupancy, cache hits, rejections…
    ingest: dict = field(default_factory=dict)
    # evidence-pool counters captured at end-of-run (dup-vote-flood,
    # light-attack): added/dedup/dropped/rejected/committed…
    evidence: dict = field(default_factory=dict)
    # validator-set rotations the invariant checker authenticated
    rotations: int = 0
    # flight-recorder capture (docs/observability.md): span/anomaly
    # counts, per-stage latency summary over the ring, and the anomaly
    # dump files (name + sha256 — hashed BEFORE the run root is deleted,
    # so determinism tests byte-compare dumps across same-seed runs)
    spans: dict = field(default_factory=dict)
    # black-box journal counters (records/bytes/drops/rotations summed
    # over the cluster) plus the restart-time postmortem reports of every
    # crashed node, captured before the run root is deleted
    blackbox: dict = field(default_factory=dict)
    postmortems: list = field(default_factory=list)
    # disk-fault supervisor capture (libs/diskguard): per-surface
    # write/fsync/retry/drop/fatal/repair counters — attached when the
    # run saw injector or real-IO trouble — plus the fail-stopped nodes
    storage: dict = field(default_factory=dict)
    fail_stopped: list = field(default_factory=list)
    # Merkle/hash-plane + proof-server counters captured at end-of-run
    # (light-stampede): queries/cache hits per kind, sheds, tree builds…
    proofs: dict = field(default_factory=dict)
    # transport data-plane counters captured at end-of-run (dial-storm):
    # frames per route, AEAD dispatch tiers, handshake pool/sync/shed…
    transport: dict = field(default_factory=dict)
    # blocksync catchup counters captured at end-of-run (blocksync-storm,
    # wan-catchup): requests/timeouts/bans/probes/redos/stall-switches,
    # heights synced and the virtual-time catchup rate
    bsync: dict = field(default_factory=dict)

    def summary(self) -> dict:
        """JSON-serializable row for soak artifacts (scripts/sim_soak.py)."""
        row = {
            "scenario": self.scenario,
            "seed": self.seed,
            "n_vals": self.n_vals,
            "target_height": self.target_height,
            "reached": self.reached,
            "heights": self.heights,
            "virtual_time": round(self.virtual_time, 6),
            "events": self.events,
            "commits_verified": self.commits_verified,
            "invariants_ok": not self.violations,
            "violations": self.violations,
        }
        if self.backend:
            row["backend"] = self.backend
        if self.sched:
            row["sched"] = {
                "submitted": self.sched["submitted"],
                "shed": self.sched["shed"],
                "flushes": self.sched["flushes"],
                "dedup_hits": self.sched["dedup_hits"],
            }
        if self.ingest:
            row["ingest"] = {
                k: self.ingest[k]
                for k in (
                    "enqueued",
                    "shed_to_sync",
                    "flushes",
                    "batch_occupancy",
                    "cache_hits",
                    "admitted",
                    "rejected_total",
                    "app_batches",
                    "sig_prechecked",
                    "recheck_batches",
                )
            }
        if self.evidence:
            row["evidence"] = dict(self.evidence)
        if self.rotations:
            row["rotations"] = self.rotations
        if self.blackbox:
            row["blackbox"] = dict(self.blackbox)
        if self.storage:
            t = self.storage.get("totals", {})
            row["storage"] = {
                k: t.get(k, 0)
                for k in (
                    "writes",
                    "fsyncs",
                    "retries",
                    "drops",
                    "fatals",
                    "injected",
                    "repairs",
                    "repaired_bytes",
                )
            }
            if self.fail_stopped:
                row["storage"]["fail_stopped_nodes"] = list(
                    self.fail_stopped
                )
        if self.proofs:
            row["proofs"] = {
                k: self.proofs[k]
                for k in (
                    "queries_total",
                    "cache_hits_total",
                    "shed_total",
                    "serial_fallbacks",
                    "tree_builds_total",
                    "trees_device",
                    "trees_host",
                    "proof_cache_hit_rate",
                    "queries_per_flush",
                )
            }
        if self.transport:
            row["transport"] = {
                k: self.transport[k]
                for k in (
                    "frames_total",
                    "frames",
                    "dispatches",
                    "frames_per_batch",
                    "bad_tags",
                    "handshakes",
                    "hs_shed",
                    "handshakes_per_flush",
                )
            }
        if self.bsync:
            row["bsync"] = {
                k: self.bsync[k]
                for k in (
                    "requests",
                    "timeouts",
                    "bans",
                    "probes",
                    "probe_passes",
                    "redos",
                    "stall_switches",
                    "blocks_received",
                    "heights_synced",
                    "heights_per_second",
                )
            }
        if self.spans:
            row["spans"] = {
                "recorded": self.spans.get("recorded", 0),
                "anomalies": self.spans.get("anomalies", {}),
                "dumps": [d["file"] for d in self.spans.get("dumps", ())],
                # p99 per stage only — the full summary stays on the result
                "p99_ms": {
                    stage: s["p99_ms"]
                    for stage, s in self.spans.get("stages", {}).items()
                },
            }
            rounds = self.spans.get("rounds") or {}
            if rounds.get("rounds_seen"):
                # the round-timeline row: per-step p50/p99 (virtual ms),
                # quorum-arrival percentiles and the commit-to-proposal
                # linkage counts — a consensus latency regression is a
                # diffable soak column, not a rerun
                row["spans"]["rounds"] = {
                    "seen": rounds["rounds_seen"],
                    "commits_linked": rounds.get("commits_linked", 0),
                    "commits_unlinked": rounds.get("commits_unlinked", 0),
                    "steps": {
                        step: {
                            "p50_ms": s.get("p50_ms", 0.0),
                            "p99_ms": s.get("p99_ms", 0.0),
                        }
                        for step, s in rounds.get("steps", {}).items()
                    },
                    "quorum": {
                        k: {
                            "p50_ms": q.get("p50_ms", 0.0),
                            "p99_ms": q.get("p99_ms", 0.0),
                        }
                        for k, q in rounds.get("quorum", {}).items()
                        if q.get("count")
                    },
                }
        return row


def _proposer_index(cluster: SimCluster) -> int:
    """Index of the proposer for the current round in the first live
    node's view (resolved at action-fire time, not script time)."""
    node = cluster.live_nodes()[0]
    addr = node.cs.rs.validators.get_proposer().address
    for i, priv in enumerate(cluster.privs):
        if priv.pub_key().address() == addr:
            return i
    return 0


def _f(n_vals: int) -> int:
    """Max tolerable faulty nodes for n validators (f < n/3), at least 1."""
    return max(1, (n_vals - 1) // 3)


def _partition_minority(s: Scenario) -> list[Action]:
    minority = list(range(s.n_vals - _f(s.n_vals), s.n_vals))
    return [
        Action(3.0, f"partition minority {minority}",
               lambda c, m=minority: c.net.partition(m)),
        Action(25.0, "heal", lambda c: c.net.heal()),
    ]


def _partition_leader(s: Scenario) -> list[Action]:
    def cut(c: SimCluster) -> None:
        leader = _proposer_index(c)
        c._log("scenario: partitioning leader node%d" % leader)
        c.net.partition([leader])

    return [
        Action(3.0, "partition current leader", cut),
        Action(25.0, "heal", lambda c: c.net.heal()),
    ]


def _crash_restart(s: Scenario) -> list[Action]:
    victims = list(range(1, 1 + _f(s.n_vals)))
    acts: list[Action] = []
    for v in victims:
        acts.append(Action(4.0, f"crash node{v}", lambda c, v=v: c.crash(v)))
        acts.append(Action(20.0, f"restart node{v}", lambda c, v=v: c.restart(v)))
    return acts


def _asymmetric_loss(s: Scenario) -> list[Action]:
    def degrade(c: SimCluster) -> None:
        for dst in range(1, c.n_vals):
            c.net.set_link(0, dst, drop_rate=0.3)  # egress only; ingress clean

    return [Action(0.0, "30% loss on node0 egress", degrade)]


# -- backend fault scenarios -------------------------------------------------

_BACKEND_ENV_KNOBS = (
    "COMETBFT_TPU_CRYPTO_BACKEND",
    "COMETBFT_TPU_SIGCACHE",
    "COMETBFT_TPU_DISPATCH_TIMEOUT_MS",
    "COMETBFT_TPU_BREAKER_THRESHOLD",
    "COMETBFT_TPU_SUPERVISOR_BISECT",
    "COMETBFT_TPU_VERIFY_SCHED",
    "COMETBFT_TPU_SCHED_FLUSH_US",
    "COMETBFT_TPU_SCHED_QUEUE",
    "COMETBFT_TPU_SCHED_PIPELINE",
    "COMETBFT_TPU_SCHED_INFLIGHT",
    "COMETBFT_TPU_TXINGEST",
    "COMETBFT_TPU_TXINGEST_QUEUE",
    "COMETBFT_TPU_TXINGEST_BATCH",
    "COMETBFT_TPU_TXINGEST_FLUSH_US",
    # Merkle/hash plane + proof server (proofserve): light-stampede
    # overrides these via extra_env; same save/restore as the rest
    "COMETBFT_TPU_PROOFSERVE",
    "COMETBFT_TPU_PROOFSERVE_QUEUE",
    "COMETBFT_TPU_PROOFSERVE_FLUSH_US",
    "COMETBFT_TPU_PROOFSERVE_CACHE",
    "COMETBFT_TPU_MERKLE_MIN_BATCH",
    "COMETBFT_TPU_MERKLE_MAX_LANES",
    # encrypted transport data plane (transportplane + handshake_pool):
    # dial-storm overrides these via extra_env; same save/restore
    "COMETBFT_TPU_AEAD",
    "COMETBFT_TPU_AEAD_DEVICE",
    "COMETBFT_TPU_AEAD_MIN_BATCH",
    "COMETBFT_TPU_AEAD_MAX_LANES",
    "COMETBFT_TPU_HANDSHAKE",
    "COMETBFT_TPU_HANDSHAKE_QUEUE",
    "COMETBFT_TPU_HANDSHAKE_FLUSH_US",
    "COMETBFT_TPU_HANDSHAKE_MAX_BATCH",
    "COMETBFT_TPU_HANDSHAKE_TIMEOUT_S",
    "COMETBFT_TPU_X25519_DEVICE",
    "COMETBFT_TPU_X25519_MAX_LANES",
    # elastic mesh supervision (parallel/elastic): mesh scenarios force
    # membership + the shard runner in setup; these knobs ride the same
    # save/restore as everything else
    "COMETBFT_TPU_MESH_SUPERVISOR",
    "COMETBFT_TPU_MESH",
    "COMETBFT_TPU_MESH_MIN_BATCH",
    "COMETBFT_TPU_WARMBOOT_MESH_SHRINK",
    # blocksync adaptive catchup (blocksync/pool.py + reactor.py): the
    # WAN scenarios pin BAN_BASE/STALL_SECS via extra_env so ban/probe
    # cycles fit inside a catchup window; same save/restore as the rest
    "COMETBFT_TPU_BSYNC_ADAPTIVE",
    "COMETBFT_TPU_BSYNC_TIMEOUT_MULT",
    "COMETBFT_TPU_BSYNC_TIMEOUT_FLOOR",
    "COMETBFT_TPU_BSYNC_TIMEOUT_CAP",
    "COMETBFT_TPU_BSYNC_BAN_BASE",
    "COMETBFT_TPU_BSYNC_BAN_CAP",
    "COMETBFT_TPU_BSYNC_BAN_STRIKES",
    "COMETBFT_TPU_BSYNC_STALL_SECS",
    "COMETBFT_TPU_BSYNC_SOLO_GRACE",
    "COMETBFT_TPU_BLOCKSYNC_WINDOW",
    # observability knobs: saved/restored for cross-run hygiene only.
    # NOTE the cluster reads the BLACKBOX knobs at construction — before
    # setup hooks run — so a scenario override affects only journals
    # built AFTER setup (restart/spawn); flip these via the test/CLI
    # environment, not extra_env, to change a whole run's journaling
    "COMETBFT_TPU_TRACE_DUMP_ALL",
    "COMETBFT_TPU_BLACKBOX",
    "COMETBFT_TPU_BLACKBOX_SEGMENTS",
    "COMETBFT_TPU_BLACKBOX_SEGMENT_BYTES",
)


def _sim_device_runner(backend, pubs, msgs, sigs, lanes):
    """Host-backed stand-in for the device tier on the CPU (supervisor
    device-runner seam): verdict-identical to the kernel by construction —
    it IS the kernel's differential oracle — without the ~2 s a plain
    PyTorch verify costs on the CPU.  The breaker/watchdog/injector
    machinery under test runs unchanged above this seam.  Never installed
    on the card."""
    import numpy as np

    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [
        ref.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)
    ]
    return out


def on_card(cluster: SimCluster) -> bool:
    """Whether the cluster runs on the card (its device None or CUDA)."""
    return supervisor._on_card(cluster.device)


def _warm_card(cluster: SimCluster) -> None:
    """On the card: resolve the batch backend (the kernel's known-answer
    self-check, which opens the gate) and run one verify through the
    supervisor, before a scenario's environment shortens the watchdog —
    a first launch that loads the kernel's library would otherwise read
    as a wedge (backend-wedge's 80 ms) and open the breaker at t=0."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import verify as ov

    cbatch.default_backend()
    seed = b"\x07" * 32
    ov.verify_batch(
        [ref.pubkey_from_seed(seed)],
        [b"warmup"],
        [ref.sign(seed, b"warmup")],
        cluster.device,
    )


def _backend_faults_setup(extra_env: Optional[dict] = None):
    """Build a Scenario.setup that forces the supervised device verify
    path and pins breaker backoff to the cluster's virtual clock.  The
    matching teardown restores every piece of process-global state."""

    def setup(cluster: SimCluster) -> None:
        from cometbft_tpu_torch import verifysched
        from cometbft_tpu_torch.crypto import backend_health
        from cometbft_tpu_torch.libs import tracing as _tracing

        saved_env = {k: os.environ.get(k) for k in _BACKEND_ENV_KNOBS}
        # the gate held open on the CPU below: closed by the teardown,
        # which run_scenario's finally runs whatever raised in here
        gate = contextlib.ExitStack()
        cluster._backend_saved = (saved_env, gate)
        # the anomaly-dump latch (first-per-kind set + dump seq) is
        # process-global state exactly like the env knobs: setup hooks may
        # trip anomalies (warmup traffic, breaker pokes) and composed
        # scenarios run several setup/teardown pairs, so the latch rides
        # the same save/restore — teardown puts it back below
        cluster._dump_saved = _tracing.get_tracer().dump_state()
        # without this every apply-time commit would resolve from verdicts
        # cached at gossip time and the fault window would exercise nothing
        os.environ["COMETBFT_TPU_SIGCACHE"] = "0"
        # scheduler OFF by default: the backend-* scenarios exercise the
        # supervisor chain BELOW the scheduler, and the per-verify flush
        # deadline would only slow them; gossip-burst re-enables it via
        # extra_env (it is the scheduler's own scenario)
        os.environ["COMETBFT_TPU_VERIFY_SCHED"] = "0"
        supervisor.clear_fault_injector()
        if on_card(cluster):
            # the device path: the card's backend, its gate opened by the
            # self-check, the kernel warm before the env overrides apply
            os.environ["COMETBFT_TPU_CRYPTO_BACKEND"] = "gpu"
            _warm_card(cluster)
        else:
            # the device path on the CPU: the gate opened on it, every
            # other caller's backend the host, the device tier's verifies
            # on the host-oracle stand-in
            os.environ["COMETBFT_TPU_CRYPTO_BACKEND"] = "cpu"
            gate.enter_context(verifysched.open_gate(cluster.device))
            supervisor.set_device_runner(_sim_device_runner)
        for k, v in (extra_env or {}).items():
            os.environ[k] = v
        # reset AFTER the env overrides so scenario breakers pick up the
        # overridden threshold (breaker knobs are read at creation), and
        # after the warmup so its breaker traffic doesn't leak into stats
        backend_health.reset()
        backend_health.registry().set_clock(cluster.clock.now)
        # fresh verify scheduler so it re-reads the scenario's flush/queue
        # knobs and the gate's device, with clean stats for the run's
        # ScenarioResult capture
        verifysched.reset_scheduler()
        verifysched.stats.reset()

    return setup


def _backend_faults_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch import verifysched
    from cometbft_tpu_torch.crypto import backend_health

    # drain + drop the scenario's scheduler BEFORE the env knobs flip back
    # (its dispatcher must finish under the scenario's device runner), and
    # zero its stats so nothing leaks into later tests
    verifysched.reset_scheduler()
    verifysched.stats.reset()
    supervisor.clear_fault_injector()
    supervisor.clear_device_runner()
    saved_env, gate = getattr(cluster, "_backend_saved", ({}, None))
    for k in _BACKEND_ENV_KNOBS:
        v = saved_env.get(k)
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if gate is not None:
        gate.close()
    backend_health.registry().set_clock(_wall.monotonic)
    backend_health.reset()
    dump_saved = getattr(cluster, "_dump_saved", None)
    if dump_saved is not None:
        from cometbft_tpu_torch.libs import tracing as _tracing

        _tracing.get_tracer().restore_dump_state(dump_saved)
        cluster._dump_saved = None


def _sim_mesh_runner(ordinal, pubs, msgs, sigs, lanes):
    """Host-backed stand-in for ONE mesh shard on the CPU (the elastic
    supervisor's ``set_mesh_runner`` seam): verdict-identical to the
    kernel by construction (the host ZIP-215 oracle IS its differential
    oracle) without a plain-version verify per shard.  Breakers,
    membership, the shrink ladder, re-admission probes and the
    FaultyDevice injector all run unchanged above this seam.  Never
    installed on the card."""
    from cometbft_tpu_torch.parallel import elastic

    return elastic.host_oracle_runner(ordinal, pubs, msgs, sigs, lanes)


SIM_MESH_WIDTH = 4  # virtual ordinals the mesh scenarios run on


def _card_mesh_ordinals(width: int) -> "list[int]":
    """On the card: ``width`` ordinals over the CUDA devices in turn (one
    card: ``width`` virtual ordinals of it), registered with
    ``parallel/mesh``.  They must be 0..width-1, the ordinals the
    scenarios' faults name."""
    import torch

    from cometbft_tpu_torch.parallel import mesh as pmesh

    count = torch.cuda.device_count()
    ordinals = pmesh.register_devices(
        [torch.device("cuda", i % count) for i in range(width)])
    if ordinals != list(range(width)):
        raise RuntimeError(
            f"the mesh scenarios need ordinals 0..{width - 1}; the CUDA "
            f"devices registered as {ordinals}")
    return ordinals


def _mesh_setup(extra_env: Optional[dict] = None, width: int = SIM_MESH_WIDTH):
    """Backend setup (the forced device path, virtual-clock breakers)
    PLUS an elastic mesh of ``width`` virtual ordinals: on the CPU on the
    per-shard host oracle, on the card on the kernel (no runner).
    Threshold 1 for the same reason the brownout scenario uses it: the
    in-process breaker registry is cluster-shared, so healthy traffic
    would otherwise keep resetting a sick ordinal's consecutive-failure
    count."""
    base = _backend_faults_setup(
        dict(
            {
                "COMETBFT_TPU_BREAKER_THRESHOLD": "1",
                # sim commits are a handful of signatures; the production
                # min-batch cutoff would keep them off the mesh path
                # under test
                "COMETBFT_TPU_MESH_MIN_BATCH": "1",
            },
            **(extra_env or {}),
        )
    )

    def setup(cluster: SimCluster) -> None:
        from cometbft_tpu_torch.ops import device_health
        from cometbft_tpu_torch.parallel import elastic

        base(cluster)
        # per-ordinal probe state is process-global like the breakers: a
        # previous run's down-marks must not swallow this run's flips
        device_health.reset()
        elastic.clear()
        if on_card(cluster):
            elastic.configure(_card_mesh_ordinals(width))
        else:
            elastic.configure(range(width))
            elastic.set_mesh_runner(_sim_mesh_runner)

    return setup


def _mesh_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.ops import device_health
    from cometbft_tpu_torch.parallel import elastic

    elastic.clear()  # drops membership + runner + injector, zeroes width
    device_health.reset()
    _backend_faults_teardown(cluster)


def _chip_death(s: Scenario) -> list[Action]:
    """One card of the virtual mesh dies mid-dispatch and STAYS dead:
    every later dispatch touching ordinal 2 raises, so the first dispatch
    after t=5 must shrink the mesh 4->3 and re-dispatch (only the failed
    dispatch re-runs); the mesh_dev2 breaker opens (threshold 1) and
    keeps the corpse out of membership, with each elapsed backoff costing
    exactly one failed one-signature probe.  At t=8 a chip-watcher-style
    health probe reports ordinal 1 down too — PROACTIVE exclusion: the
    card leaves membership before any dispatch pays a failure to find
    out; because that card actually dispatches fine, its next half-open
    probe re-admits it (the probe dispatch is the arbiter, so a flaky
    watcher can't permanently cost a lane) while the truly dead ordinal
    2 stays out.  The fleet keeps committing throughout."""

    def die(c: SimCluster) -> None:
        from cometbft_tpu_torch.parallel import elastic

        c._log("scenario: mesh ordinal 2 dies (every dispatch raises)")
        elastic.set_fault_injector(
            elastic.FaultyDevice("raise", ordinals=(2,))
        )

    def probe_down(c: SimCluster) -> None:
        from cometbft_tpu_torch.ops import device_health

        c._log("scenario: health probe reports mesh ordinal 1 down")
        device_health.record_probe(
            False, source="chipwatch", t=c.clock.now(), ordinal=1
        )

    return [
        Action(5.0, "chip death: mesh ordinal 2", die),
        Action(8.0, "probe-down: mesh ordinal 1", probe_down),
    ]


def _mesh_brownout(s: Scenario) -> list[Action]:
    """A flapping card: ordinal 1 fails in bursts (fail 2 / pass 4,
    counter-based so the run is deterministic per seed) from t=4 to t=12.
    The mesh must shrink on each failing burst, the mesh_dev1 breaker
    must cycle open -> half-open -> closed on the virtual-clock backoff
    (a pass-phase probe re-admits the card: ``mesh_restore``), and after
    t=12 the mesh must settle back at full width — all without a single
    wrong verdict or a missed commit."""

    def flap(c: SimCluster) -> None:
        from cometbft_tpu_torch.parallel import elastic

        c._log("scenario: mesh ordinal 1 flapping (fail 2 / pass 4)")
        elastic.set_fault_injector(
            elastic.FaultyDevice("flap", ordinals=(1,), fail_n=2, pass_n=4)
        )

    def stable(c: SimCluster) -> None:
        from cometbft_tpu_torch.parallel import elastic

        c._log("scenario: mesh ordinal 1 stable again")
        elastic.clear_fault_injector()

    return [
        Action(4.0, "mesh brownout: ordinal 1 flaps", flap),
        Action(12.0, "mesh brownout ends", stable),
    ]


def _mesh_blackout(s: Scenario) -> list[Action]:
    """Three of the four mesh ordinals die at t=5 (overlapping the
    composed backend brownout's window): the mesh collapses below width 2
    and every batch falls into the SINGLE-CARD chain, which the composed
    ``_backend_brownout`` is failing on the victim nodes at the same
    time, so the whole ladder mesh(4)->3->2->single card is exercised in
    one storm (on the CPU down to the host; on a card a batch the kernel
    did not serve raises).  At t=10.5 the cards heal; half-open probes
    re-admit them and the mesh climbs back to full width."""

    def blackout(c: SimCluster) -> None:
        from cometbft_tpu_torch.parallel import elastic

        c._log("scenario: mesh blackout (ordinals 1, 2, 3 die)")
        elastic.set_fault_injector(
            elastic.FaultyDevice("raise", ordinals=(1, 2, 3))
        )

    def restore(c: SimCluster) -> None:
        from cometbft_tpu_torch.parallel import elastic

        c._log("scenario: mesh blackout ends")
        elastic.clear_fault_injector()

    return [
        Action(5.0, "mesh blackout: 3 of 4 ordinals die", blackout),
        Action(10.5, "mesh blackout ends", restore),
    ]


def _byzantine_voter(s: Scenario) -> list[Action]:
    """ROADMAP item 5 follow-up: a LIVE validator equivocates — from
    t=2 to t=8 the last validator double-signs every non-nil prevote and
    precommit it broadcasts (a second vote for a fabricated block id,
    signed with its real key, through the production gossip fabric).
    Honest nodes must detect the conflict in their vote sets
    (``ConflictingVoteError`` -> ``report_conflicting_votes``), convert
    it to ``DuplicateVoteEvidence`` at finalize through the evidence
    pool's consensus buffer, COMMIT the evidence in a later block, and
    keep agreement + validator-set invariants green — no crafted
    evidence anywhere in the path."""
    byz = s.n_vals - 1

    def start(c: SimCluster) -> None:
        import hashlib

        from cometbft_tpu_torch.consensus.messages import VoteMessage
        from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader
        from cometbft_tpu_torch.types.vote import Vote

        node = c.nodes[byz]
        if node is None:
            return
        orig = node.cs.broadcast_hook
        priv = c.privs[byz]
        chain_id = c.gdoc.chain_id
        c._log(
            "scenario: node%d turns byzantine (double-signs every vote)"
            % byz
        )

        def double(msg):
            orig(msg)
            if not isinstance(msg, VoteMessage):
                return
            v = msg.vote
            if v.block_id.is_zero():
                return
            # a second vote for a fabricated block at the SAME (height,
            # round, type) — a real equivocation, deterministically
            # derived from the honest vote it shadows
            alt = hashlib.sha256(
                b"byzantine-fork" + v.block_id.hash
                + v.height.to_bytes(8, "big") + bytes([v.type_])
            ).digest()
            v2 = Vote(
                type_=v.type_,
                height=v.height,
                round_=v.round_,
                block_id=BlockID(
                    hash=alt,
                    part_set_header=PartSetHeader(
                        total=1, hash=hashlib.sha256(alt + b"p").digest()
                    ),
                ),
                timestamp=v.timestamp,
                validator_address=v.validator_address,
                validator_index=v.validator_index,
            )
            v2.signature = priv.sign(v2.sign_bytes(chain_id))
            orig(VoteMessage(v2))

        c._byz_orig = (byz, orig)
        node.cs.broadcast_hook = double

    def stop(c: SimCluster) -> None:
        saved = getattr(c, "_byz_orig", None)
        if saved is None:
            return
        idx, orig = saved
        node = c.nodes[idx]
        if node is not None:
            node.cs.broadcast_hook = orig
            c._log("scenario: node%d honest again" % idx)
        c._byz_orig = None

    return [
        Action(2.0, "validator turns byzantine", start),
        Action(8.0, "byzantine validator stops double-signing", stop),
    ]


def _victims(n_vals: int) -> list[int]:
    """f+1 nodes lose their device: more than the Byzantine tolerance —
    agreement must survive anyway because degradation is verdict-
    preserving, not because the victims are outvoted."""
    return list(range(_f(n_vals) + 1))


def _install_victim_injector(cluster: SimCluster, shim) -> None:
    victims = set(_victims(cluster.n_vals))

    def inject(backend, pubs, msgs, sigs):
        if cluster.active_node not in victims:
            return None  # healthy node (or cluster-level work, e.g. checker)
        return shim(backend, pubs, msgs, sigs)

    supervisor.set_fault_injector(inject)


def _backend_brownout(s: Scenario) -> list[Action]:
    def down(c: SimCluster) -> None:
        c._log(
            "scenario: device backend down on nodes %s" % _victims(c.n_vals)
        )
        _install_victim_injector(c, supervisor.FaultyBackend("raise"))

    def aux_breakers(c: SimCluster) -> None:
        """Fail the single-tier secp256k1/BLS device breakers mid-brownout
        through the SAME supervised protocol the batch verifiers use: with
        the scenario's threshold of 1 each failure opens its breaker, and
        each breaker kind must produce its OWN anomaly dump — the ed25519
        brownout's breaker_open dump must not eat them
        (docs/observability.md anomaly taxonomy)."""

        from cometbft_tpu_torch.crypto.backend_health import BackendError

        def boom() -> None:
            raise RuntimeError("sim aux-device fault")

        for name in ("secp_device", "bls_g1"):
            try:
                out = supervisor.supervised_device_call(
                    name, boom, device=c.device
                )
            except BackendError:
                out = "raised"  # the card's rule: no host below the kernel
            c._log(
                "scenario: %s breaker poked (supervised -> %s)" % (name, out)
            )

    def up(c: SimCluster) -> None:
        c._log("scenario: device backend restored")
        supervisor.clear_fault_injector()

    return [
        Action(5.0, "device backend brownout (f+1 nodes)", down),
        Action(6.0, "secp/bls device breakers fail", aux_breakers),
        Action(10.0, "restore device backend", up),
    ]


def _backend_wedge(s: Scenario) -> list[Action]:
    def wedge(c: SimCluster) -> None:
        c._log(
            "scenario: device dispatches wedge on nodes %s" % _victims(c.n_vals)
        )
        # hang_s is real (wall) time: it must exceed the scenario's 80 ms
        # watchdog but stay small so abandoned workers drain quickly
        _install_victim_injector(
            c, supervisor.FaultyBackend("hang", hang_s=0.25)
        )

    def up(c: SimCluster) -> None:
        c._log("scenario: device backend unwedged")
        supervisor.clear_fault_injector()

    return [
        Action(4.0, "device backend wedge (f+1 nodes)", wedge),
        Action(9.0, "unwedge device backend", up),
    ]


def _backend_flap(s: Scenario) -> list[Action]:
    def flap(c: SimCluster) -> None:
        c._log("scenario: device backend flapping (all nodes)")
        # bursts of fail_n=4 failures (past the breaker threshold of 3)
        # followed by pass_n=2 clean dispatches: the breaker must open,
        # probe half-open on the virtual-clock backoff, re-promote on a
        # pass-phase probe, and re-open on the next burst
        supervisor.set_fault_injector(
            supervisor.FaultyBackend("flap", fail_n=4, pass_n=2)
        )

    def up(c: SimCluster) -> None:
        c._log("scenario: device backend stable")
        supervisor.clear_fault_injector()

    return [
        Action(3.0, "device backend flap", flap),
        Action(14.0, "stabilize device backend", up),
    ]


def _gossip_burst(s: Scenario) -> list[Action]:
    """Vote storm + scripted bulk-verify overload against the continuous-
    batching verification scheduler (docs/verify-scheduler.md): links
    duplicate and reorder gossip (so the same vote signature reaches nodes
    repeatedly and concurrently-queued duplicates exercise the in-flight
    dedup), while scripted bursts of seeded bulk-class submissions slam the
    scheduler's bounded queue past its (scenario-shrunk) capacity.
    Admission control must shed ONLY bulk-class items; consensus votes are
    exempt by design, so agreement and progress must be untouched and the
    trace stays byte-identical per seed (verdicts never depend on how items
    happened to coalesce)."""

    def storm(c: SimCluster) -> None:
        c.net.set_all_links(dup_rate=0.25, reorder_rate=0.5, reorder_jitter=0.5)

    def burst(c: SimCluster) -> None:
        import hashlib

        from cometbft_tpu_torch import verifysched

        sched = verifysched.get_scheduler()
        tag = b"gossip-burst-%d-%d" % (c.seed, int(c.clock.now() * 1000))
        shed = 0
        futs = []
        # pause/resume brackets the burst so the overload is deterministic:
        # the sim is single-threaded (every consensus verify blocks on its
        # future), so the queue is empty here, the dispatcher cannot drain
        # mid-burst, and exactly queue_cap items are admitted
        sched.pause()
        try:
            for i in range(256):
                h = hashlib.sha256(tag + b"-%d" % i).digest()
                try:
                    futs.append(
                        sched.submit(
                            h,  # structurally valid, crypto garbage
                            b"burst-msg-%d" % i,
                            h + h,
                            verifysched.PRIO_BLOCKSYNC,
                        )
                    )
                except verifysched.QueueFullError:
                    shed += 1
        finally:
            sched.resume()
        # wait the admitted items out: the queue is empty again before the
        # action returns, so the next burst's shed count (logged into the
        # byte-compared trace) cannot depend on dispatcher wall-time.  On
        # the card a flush the kernel did not serve raises (the card's
        # rule): counted, never a verdict
        raised = 0
        for f in futs:
            try:
                ok = f.result(timeout=30)
            except BackendError:
                raised += 1
                continue
            assert ok is False  # garbage never verifies
        c._log("scenario: bulk burst of 256 submissions, %d shed" % shed
               + (", %d raised unserved" % raised if raised else ""))

    return [Action(0.0, "storm links: dup 25%, reorder 50%", storm)] + [
        Action(float(t), "bulk verify burst (256 items)", burst)
        for t in (3, 5, 7)
    ]


def _pipeline_burst(s: Scenario) -> list[Action]:
    """In-flight verify pipeline under deterministic load
    (docs/verify-scheduler.md "In-flight pipeline"): two paused bulk
    rounds submitted back-to-back while the completion pool is gated
    shut, so the dispatcher MUST ship the second fused flush while the
    first is still in flight (depth 2 — the pipelined high-water mark is
    captured in ScenarioResult.sched).  Every future still resolves with
    the definitive verdict before the action logs, so the byte-compared
    trace cannot depend on completion-pool timing."""

    def burst(c: SimCluster) -> None:
        import hashlib
        import threading
        import time as _time

        from cometbft_tpu_torch import verifysched
        from cometbft_tpu_torch.verifysched import stats as sstats

        sched = verifysched.get_scheduler()
        tag = b"pipeline-burst-%d-%d" % (c.seed, int(c.clock.now() * 1000))
        futs = []
        gate = threading.Event()
        orig = supervisor._DEVICE_RUNNER
        if orig is not None:
            # park the completion pool on the gate so the overlap is
            # deterministic, not a race the CI host may lose (on the card
            # the kernel runs and the gating is skipped)
            def gated(backend, pubs, msgs, sigs, lanes):
                gate.wait(20)
                return orig(backend, pubs, msgs, sigs, lanes)

            supervisor.set_device_runner(gated)
        try:
            # two paused rounds -> two separate drains -> two flushes;
            # flush B dispatches while flush A sits gated in flight
            for half in (b"a", b"b"):
                sched.pause()
                try:
                    for i in range(40):
                        h = hashlib.sha256(
                            tag + b"-" + half + b"-%d" % i
                        ).digest()
                        futs.append(
                            sched.submit(
                                h,  # structurally valid, crypto garbage
                                b"pipe-msg-%d" % i,
                                h + h,
                                verifysched.PRIO_BLOCKSYNC,
                            )
                        )
                finally:
                    sched.resume()
                if half == b"a" and orig is not None:
                    # don't let round b land in round a's drain: wait
                    # until flush A is dispatched (the gate pins it in
                    # flight), so round b forces a SECOND fused flush
                    deadline = _time.monotonic() + 10
                    while (
                        sstats.snapshot()["inflight_depth"] < 1
                        and _time.monotonic() < deadline
                    ):
                        _time.sleep(0.002)
            if orig is not None:
                deadline = _time.monotonic() + 10
                while (
                    sstats.snapshot()["inflight_depth"] < 2
                    and _time.monotonic() < deadline
                ):
                    _time.sleep(0.002)
            gate.set()
            # block on EVERY future before logging: nothing timing-
            # dependent may precede the byte-compared trace line
            for f in futs:
                assert f.result(timeout=30) is False
        finally:
            gate.set()
            if orig is not None:
                supervisor.set_device_runner(orig)
        c._log(
            "scenario: pipelined burst of %d submissions resolved"
            % len(futs)
        )

    return [
        Action(float(t), "pipelined bulk burst (2x40 items)", burst)
        for t in (3, 5)
    ]


def _light_stampede(s: Scenario) -> list[Action]:
    """Light-client read stampede against the proof-serving coalescer
    (docs/proof-serving.md): scripted bursts of tx/header/valset proof
    queries — thousands per burst against a scenario-shrunk queue — fire
    mid-consensus on node0's stores, on the host-oracle tree-runner seam.
    Admission control sheds only proof queries (nothing consensus-class
    rides this queue by construction); consensus agreement and progress
    must be untouched, every admitted future must resolve, and the
    response-bytes digest logged into the byte-compared trace makes the
    answers themselves part of the determinism check."""

    def stampede(c: SimCluster) -> None:
        import hashlib

        from cometbft_tpu_torch import proofserve

        node = c.nodes[0]
        if node is None:
            return
        bs, ss = node.block_store, node.state_store

        def tx_loader(h):
            blk = bs.load_block(int(h))
            return None if blk is None else list(blk.data.txs)

        def header_hasher(h):
            meta = bs.load_block_meta(int(h))
            return None if meta is None else meta.header.hash()

        def valset_hasher(h):
            try:
                vals = ss.load_validators(int(h))
            except Exception:  # noqa: BLE001 — pruned/unknown height
                return None
            return None if vals is None else vals.hash()

        srv = proofserve.get_server()
        if srv is None:
            srv = proofserve.configure(tx_loader, header_hasher, valset_hasher)
        top = max(bs.height(), 1)
        shed = 0
        futs = []
        # pause/resume brackets the burst so the overload is
        # deterministic: the sim is single-threaded, so the dispatcher
        # cannot drain mid-burst and exactly queue_cap non-cache-hit
        # queries are admitted (LRU hits resolve without a slot)
        srv.pause()
        try:
            for i in range(1500):
                kind = ("header", "valset", "tx")[i % 3]
                h = max(1, top - (i % 2))
                try:
                    futs.append((kind, srv.submit(kind, h)))
                except proofserve.QueueFullError:
                    shed += 1
        finally:
            srv.resume()
        # wait every admitted future out (queue empty again before the
        # action returns — the next burst's shed count cannot depend on
        # dispatcher wall-time), folding the response bytes into a
        # digest: the ANSWERS are part of the byte-compared trace
        digest = hashlib.sha256()
        for kind, f in futs:
            res = f.result(timeout=30)
            if res is None:
                digest.update(b"\x00none")
            elif kind == "tx":
                root, proofs = res
                digest.update(root)
                for p in proofs:
                    digest.update(p.leaf_hash)
                    for a in p.aunts:
                        digest.update(a)
            else:
                digest.update(res)
        c._log(
            "scenario: proof stampede of 1500 queries at h=%d, %d shed, "
            "digest=%s" % (top, shed, digest.hexdigest()[:16])
        )

    return [
        Action(float(t), "light-client proof stampede (1500 queries)", stampede)
        for t in (3, 5, 7)
    ]


def _light_stampede_setup():
    base = _backend_faults_setup(
        {
            # verify scheduler ON so the run proves proof traffic cannot
            # shed consensus-class verifies (they ride different queues)
            "COMETBFT_TPU_VERIFY_SCHED": "1",
            "COMETBFT_TPU_PROOFSERVE": "1",
            "COMETBFT_TPU_PROOFSERVE_QUEUE": "512",
            "COMETBFT_TPU_PROOFSERVE_FLUSH_US": "500",
            # sim blocks are small: drop the min-batch gate so tree
            # passes actually traverse the plane's device path (on the
            # CPU the host-oracle runner below answers for the kernel)
            "COMETBFT_TPU_MERKLE_MIN_BATCH": "4",
        }
    )

    def setup(cluster: SimCluster) -> None:
        base(cluster)
        from cometbft_tpu_torch import proofserve
        from cometbft_tpu_torch.ops import sha256_tree

        if not on_card(cluster):
            # host-oracle tree-runner seam on the CPU: the breaker/stats
            # machinery above the seam runs unchanged, with no plain-version
            # pass (mirrors _sim_device_runner); cleared in teardown
            sha256_tree.set_tree_runner(sha256_tree.host_tree_runner)
        proofserve.reset_server()
        proofserve.stats.reset()

    return setup


def _light_stampede_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch import proofserve
    from cometbft_tpu_torch.ops import sha256_tree

    # drain the proof server BEFORE the env knobs flip back (its
    # dispatcher must finish under the scenario's tree runner)
    proofserve.reset_server()
    proofserve.stats.reset()
    sha256_tree.clear_tree_runner()
    _backend_faults_teardown(cluster)


def _dial_storm(s: Scenario) -> list[Action]:
    """Inbound-connection storm against the encrypted transport plane
    mid-consensus (docs/transport-plane.md): scripted waves of 600
    concurrent X25519 handshake admissions against a 256-slot pool queue
    plus coalesced AEAD frame batches (sizes straddling the 64-byte
    block edges, one deliberately tampered frame).  Shed handshakes fall
    to the sync dial — never a dropped connection — and every count and
    digest logged into the byte-compared trace is a function of the
    seeded inputs and verdicts only, never of flush timing.  The final
    wave re-runs a slice with both kill switches off and asserts the
    bytes are identical: the plane is an optimization, not a cipher."""

    def storm(c: SimCluster, wave: int) -> None:
        import hashlib

        from cometbft_tpu_torch.crypto import aead_ref
        from cometbft_tpu_torch.ops import x25519_ladder
        from cometbft_tpu_torch.p2p import handshake_pool as hp
        from cometbft_tpu_torch.p2p import transport_stats as tstats
        from cometbft_tpu_torch.p2p import transportplane

        # deterministic dial population: scalars and peer keys are pure
        # functions of (wave, i) — the storm's trace bytes depend on
        # nothing else
        def scalar(i: int) -> bytes:
            return hashlib.sha256(b"dial-storm-%d-%d" % (wave, i)).digest()

        peer_pubs = [
            aead_ref.x25519(
                hashlib.sha256(b"dial-storm-peer-%d" % j).digest(),
                x25519_ladder.BASE_U,
            )
            for j in range(8)
        ]
        pairs = [(scalar(i), peer_pubs[i % 8]) for i in range(600)]

        # pause/resume brackets the burst so the overload is
        # deterministic: the sim is single-threaded, so the dispatcher
        # cannot drain mid-burst and exactly queue_cap dials are
        # admitted; the rest shed to the sync ladder
        pool = hp.get_pool()
        futs = []
        pool.pause()
        try:
            for p in pairs:
                try:
                    futs.append(pool.submit(*p))
                except hp.QueueFullError:
                    tstats.record_hs_shed()
                    futs.append(None)
        finally:
            pool.resume()
        digest = hashlib.sha256()
        shed = 0
        for f, p in zip(futs, pairs):
            if f is None:
                shed += 1
                tstats.record_handshake("sync")
                secret = hp.sync_exchange(*p)
            else:
                secret = f.result(timeout=30)
                tstats.record_handshake("pool")
            digest.update(secret)

        # coalesced AEAD leg: one batch of frames straddling the 64-byte
        # ChaCha block edges, with frame 25 tampered — the batch must
        # deliver exactly the 25-frame prefix and reject the rest
        key = hashlib.sha256(b"dial-storm-key-%d" % wave).digest()
        sizes = (0, 1, 63, 64, 65, 100, 128, 500, 1021, 1024) * 4
        payloads = [
            hashlib.sha256(b"frame-%d-%d" % (wave, i)).digest() * 32
            for i in range(len(sizes))
        ]
        payloads = [p[:n] for p, n in zip(payloads, sizes)]
        sealed = transportplane.seal_frames(key, 0, payloads)
        for ct in sealed:
            digest.update(ct)
        tampered = list(sealed)
        tampered[25] = tampered[25][:-1] + bytes(
            [tampered[25][-1] ^ 0x01]
        )
        pts, bad = transportplane.open_frames(key, 0, tampered)
        assert bad == 25 and pts == payloads[:25], (
            "tampered batch must deliver exactly the prefix before the "
            "bad tag"
        )
        c._log(
            "scenario: dial storm wave %d: 600 dials, %d shed, "
            "aead frames=%d delivered=%d bad_at=%d digest=%s"
            % (wave, shed, len(sealed), len(pts), bad,
               digest.hexdigest()[:16])
        )

    def kill_switch_parity(c: SimCluster) -> None:
        import hashlib

        from cometbft_tpu_torch.p2p import handshake_pool as hp
        from cometbft_tpu_torch.p2p import transportplane

        # plane output for a slice of deterministic inputs...
        key = hashlib.sha256(b"dial-storm-parity-key").digest()
        payloads = [
            hashlib.sha256(b"parity-%d" % i).digest() * 8 for i in range(8)
        ]
        scalars = [
            hashlib.sha256(b"parity-scalar-%d" % i).digest()
            for i in range(4)
        ]
        plane_sealed = transportplane.seal_frames(key, 0, payloads)
        plane_secrets = [hp.public_key(s) for s in scalars]
        # ...must be byte-identical with both kill switches off (the
        # serial pure-Python path): the plane is an optimization, never
        # a different cipher
        saved = {
            k: os.environ.get(k)
            for k in ("COMETBFT_TPU_AEAD", "COMETBFT_TPU_HANDSHAKE")
        }
        os.environ["COMETBFT_TPU_AEAD"] = "0"
        os.environ["COMETBFT_TPU_HANDSHAKE"] = "0"
        try:
            from cometbft_tpu_torch.p2p.secret_connection import _HalfDuplex

            hd = _HalfDuplex(key)
            serial_sealed = [hd.seal(p) for p in payloads]
            serial_secrets = [hp.public_key(s) for s in scalars]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert plane_sealed == serial_sealed, (
            "COMETBFT_TPU_AEAD=0 kill-switch parity broken"
        )
        assert plane_secrets == serial_secrets, (
            "COMETBFT_TPU_HANDSHAKE=0 kill-switch parity broken"
        )
        c._log("scenario: dial-storm kill-switch parity ok (8 frames, 4 keys)")

    return [
        Action(float(t), "inbound dial storm (600 handshakes)",
               lambda c, w=w: storm(c, w))
        for w, t in enumerate((3, 5, 7))
    ] + [
        Action(9.0, "kill-switch parity check", kill_switch_parity)
    ]


def _dial_storm_setup():
    base = _backend_faults_setup(
        {
            # verify scheduler ON so the run proves transport traffic
            # cannot shed consensus-class verifies (different queues)
            "COMETBFT_TPU_VERIFY_SCHED": "1",
            "COMETBFT_TPU_AEAD": "1",
            # sim batches are small: drop the min-batch gate so frame
            # batches actually traverse the plane (on the CPU the
            # host-oracle runners below answer for the kernels)
            "COMETBFT_TPU_AEAD_MIN_BATCH": "4",
            "COMETBFT_TPU_HANDSHAKE": "1",
            "COMETBFT_TPU_HANDSHAKE_QUEUE": "256",
            "COMETBFT_TPU_HANDSHAKE_FLUSH_US": "500",
            "COMETBFT_TPU_HANDSHAKE_MAX_BATCH": "128",
        }
    )

    def setup(cluster: SimCluster) -> None:
        base(cluster)
        from cometbft_tpu_torch.ops import chacha_aead, x25519_ladder
        from cometbft_tpu_torch.p2p import handshake_pool
        from cometbft_tpu_torch.p2p import transport_stats as tstats

        if not on_card(cluster):
            # host-oracle runner seams on the CPU: the pool/breaker/stats
            # machinery above the seams runs unchanged, with no
            # plain-version pass (mirrors _sim_device_runner); cleared in
            # teardown
            x25519_ladder.set_ladder_runner(x25519_ladder.host_exchange)
            chacha_aead.set_aead_runner(chacha_aead._host_pass)
        handshake_pool.reset_pool()
        tstats.reset()

    return setup


def _dial_storm_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.ops import chacha_aead, x25519_ladder
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p import transport_stats as tstats

    # drain the pool BEFORE the env knobs flip back (its dispatcher must
    # finish under the scenario's ladder runner)
    handshake_pool.reset_pool()
    tstats.reset()
    x25519_ladder.clear_ladder_runner()
    chacha_aead.clear_aead_runner()
    _backend_faults_teardown(cluster)


def _txflood_app():
    """Envelope-verifying kvstore: signature checks hoisted onto the
    crypto seam, payloads (``key=value``) served by the stock app."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.txingest import SigVerifyingApp

    return SigVerifyingApp(KVStoreApplication())


def _tx_flood_setup(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.txingest import stats as istats

    _backend_faults_setup(
        {
            # apply-time re-checks (process-proposal, finalize, recheck)
            # must resolve from cache — that's the pipeline under test
            "COMETBFT_TPU_SIGCACHE": "1",
            "COMETBFT_TPU_VERIFY_SCHED": "1",
            "COMETBFT_TPU_SCHED_FLUSH_US": "500",
            "COMETBFT_TPU_TXINGEST": "1",
            # a queue far smaller than the burst: most of each burst must
            # shed to the per-tx sync path and STILL reach a verdict
            "COMETBFT_TPU_TXINGEST_QUEUE": "32",
            "COMETBFT_TPU_TXINGEST_BATCH": "24",
        }
    )(cluster)
    istats.reset()


def _tx_flood_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.txingest import stats as istats

    _backend_faults_teardown(cluster)
    istats.reset()


def _tx_flood(s: Scenario) -> list[Action]:
    """Sustained signed-tx bursts against every node's mempool through a
    deterministically-driven ingest coalescer (docs/tx-ingest.md).  Each
    burst mixes valid ed25519/secp256k1 envelopes, forged signatures,
    malformed envelopes, an oversize tx, in-burst duplicates and re-sends
    of burst 0 (cross-burst duplicates, incl. committed txs).  The
    coalescer queue (32 slots, scenario-shrunk) is far smaller than the
    burst, so most submissions shed to the per-tx sync path — a shed
    costs the batching win, never a verdict.  Every count logged into the
    byte-compared trace is a function of verdicts and the seeded
    submission order only, never of flush timing."""

    def burst(c: SimCluster, burst_no: int) -> None:
        from cometbft_tpu_torch.abci import types as at
        from cometbft_tpu_torch.crypto import keys as ck
        from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
        from cometbft_tpu_torch.mempool.clist_mempool import (
            MempoolError,
            TxInCacheError,
        )
        from cometbft_tpu_torch.txingest import IngestCoalescer
        from cometbft_tpu_torch.txingest import envelope as ev

        privs = [
            ck.Ed25519PrivKey.from_seed(bytes([0x20 + i]) * 32)
            for i in range(3)
        ]
        secp = Secp256k1PrivKey.from_secret(b"\x41" * 32)

        def valid(b: int, i: int) -> bytes:
            # nonces advance across bursts (b*100+i): a well-behaved sender
            # never reuses one, so the coalescer's replay LRU only fires on
            # the scripted replays below
            return ev.sign_tx(
                privs[i % len(privs)], b"f%d_%d=%d" % (b, i, i),
                nonce=b * 100 + i,
            )

        txs: "list[bytes]" = [valid(burst_no, i) for i in range(36)]
        txs.append(
            ev.sign_tx(secp, b"s%d=%d" % (burst_no, burst_no), nonce=burst_no)
        )
        # forged: structurally valid envelope, signature from a different
        # preimage (nonce bumped after signing — far past any nonce a later
        # burst will legitimately use, and never recorded by the replay LRU
        # because the signature never verifies)
        for i in range(4):
            g = ev.decode(txs[i])
            txs.append(
                ev.encode(
                    ev.Envelope(
                        g.key_type, g.pubkey, g.nonce + 100_000, g.payload,
                        g.signature,
                    )
                )
            )
        # malformed: envelope magic, garbage structure
        for i in range(3):
            txs.append(ev.MAGIC + b"\x7fgarbage-%d-%d" % (burst_no, i))
        # oversize: past the scenario mempool's 2048-byte max_tx_bytes
        txs.append(
            ev.sign_tx(privs[0], b"big%d=" % burst_no + b"x" * 4096, nonce=99)
        )
        # in-burst duplicates (same bytes twice before any flush) plus,
        # after burst 0, re-sends of burst 0's first txs — cross-burst
        # duplicates that are by then cached and possibly committed — and
        # REPLAYS: fresh payloads re-signed under burst 0's nonces, which
        # must die at ingest with the canonical stale-nonce code instead
        # of reaching the app (docs/tx-ingest.md replay protection)
        txs += [valid(burst_no, 0), valid(burst_no, 1)]
        if burst_no > 0:
            txs += [valid(0, 0), valid(0, 1)]
            for i in range(2):
                txs.append(
                    ev.sign_tx(
                        privs[i], b"replay%d_%d=1" % (burst_no, i), nonce=i
                    )
                )
        c.rng.shuffle(txs)

        ingestors = getattr(c, "_flood_ingest", None)
        if ingestors is None:
            ingestors = c._flood_ingest = {}
        for i, node in enumerate(c.live_nodes()):
            outcomes = {"ok": 0, "rejected": 0, "errors": 0}

            def note(sender, res, o=outcomes):
                if isinstance(res, at.CheckTxResponse):
                    o["ok" if res.ok else "rejected"] += 1
                else:
                    o["errors"] += 1

            # one coalescer per node for the whole run (like production):
            # its verified-nonce LRU must span bursts for replay rejection
            ing = ingestors.get(node.index)
            if ing is None:
                ing = ingestors[node.index] = IngestCoalescer(
                    node.mempool, start_thread=False, device=c.device
                )
            ing.on_result = note
            queued = dedup = synced = 0
            for tx in txs:
                try:
                    res = ing.submit(tx, sender="flood")
                except TxInCacheError:
                    dedup += 1
                    continue
                except MempoolError:
                    outcomes["errors"] += 1
                    synced += 1
                    continue
                if res is None:
                    queued += 1
                else:
                    synced += 1
                    note("flood", res)
            ing.flush_now()
            c._log(
                "scenario: tx-flood burst %d node%d: queued=%d shed_sync=%d "
                "dedup=%d ok=%d rejected=%d errors=%d"
                % (
                    burst_no,
                    i,
                    queued,
                    synced,
                    dedup,
                    outcomes["ok"],
                    outcomes["rejected"],
                    outcomes["errors"],
                )
            )

    return [
        Action(float(t), "signed-tx flood burst %d" % b,
               lambda c, b=b: burst(c, b))
        for b, t in enumerate((2, 4, 6, 8))
    ]


def _message_storm(s: Scenario) -> list[Action]:
    def inject_txs(c: SimCluster) -> None:
        h = c.live_nodes()[0].cs.rs.height
        for node in c.live_nodes():
            node.mempool.check_tx(b"storm%d=%d" % (h, h))

    acts = [
        Action(
            0.0,
            "storm links: dup 25%, reorder 50%",
            lambda c: c.net.set_all_links(
                dup_rate=0.25, reorder_rate=0.5, reorder_jitter=0.5
            ),
        )
    ]
    acts += [
        Action(float(t), "inject txs", inject_txs) for t in (2, 5, 8, 11, 14)
    ]
    return acts


# -- fleet-scale churn / rotation scenarios ----------------------------------


def _retrying_join(
    c: SimCluster, idx: int, attempt: int = 0, max_attempts: int = 10
) -> None:
    """Statesync-join ``idx``, retrying every 2 virtual seconds while no
    viable snapshot exists (or another join is mid-flight).  All retries
    ride the scripted clock, so the whole dance replays from the seed."""
    if c.nodes[idx] is not None:
        return
    if not c.join(idx) and attempt + 1 < max_attempts:
        c.clock.call_later(
            2.0,
            lambda: _retrying_join(c, idx, attempt + 1, max_attempts),
            label=f"scenario join-retry node{idx}",
        )


def _validator_rotation(s: Scenario) -> list[Action]:
    """A standby full node comes online at genesis, gets voted in, and a
    genesis validator is voted out — the minimal end-to-end rotation on
    the production validate_validator_updates path."""
    spare = s.n_vals  # first spare index

    return [
        Action(1.0, f"spawn standby node{spare}",
               lambda c: c.spawn_spare(spare)),
        Action(3.0, f"vote node{spare} into the validator set",
               lambda c: c.add_validator(spare)),
        Action(7.0, "vote node0 out of the validator set",
               lambda c: c.remove_validator(0)),
    ]


def _fleet_churn(s: Scenario) -> list[Action]:
    """The fleet acceptance script: validator rotation + node churn in one
    run.  A spare is voted in and later joins as a FRESH machine via
    statesync; the last genesis validator is voted out and gracefully
    leaves; another validator hard-crashes and restarts from its stores.
    Scales with n_vals — the nightly lane runs it at 100 validators, the
    tier-1 lane at a single-digit size."""
    spare = s.n_vals
    leaver = s.n_vals - 1
    crasher = 1

    return [
        Action(2.0, f"vote spare node{spare} in",
               lambda c: c.add_validator(spare)),
        Action(3.0, f"vote node{leaver} out",
               lambda c: c.remove_validator(leaver)),
        Action(8.0, f"node{leaver} leaves gracefully",
               lambda c: c.leave(leaver)),
        Action(9.0, f"node{spare} joins via statesync",
               lambda c: _retrying_join(c, spare)),
        Action(11.0, f"crash node{crasher}", lambda c: c.crash(crasher)),
        Action(15.0, f"restart node{crasher}", lambda c: c.restart(crasher)),
    ]


def _statesync_storm(s: Scenario) -> list[Action]:
    """Two joiners statesync through lossy links while a serving peer
    crashes mid-sync: chunk re-requests must back off exponentially and
    rotate to surviving peers, and both joins must still complete."""
    j1, j2 = s.n_vals, s.n_vals + 1

    def degrade(c: SimCluster) -> None:
        c.net.set_node_links(j1, drop_rate=0.25)
        c.net.set_node_links(j2, drop_rate=0.25)

    return [
        Action(0.0, "25% loss on both joiners' links", degrade),
        Action(9.0, f"node{j1} joins via statesync (lossy)",
               lambda c: _retrying_join(c, j1)),
        Action(10.0, "crash node3 (a chunk-serving peer)",
               lambda c: c.crash(3)),
        Action(11.0, f"node{j2} joins via statesync (lossy)",
               lambda c: _retrying_join(c, j2)),
        Action(15.0, "restart node3", lambda c: c.restart(3)),
    ]


# -- blocksync catchup scenarios ---------------------------------------------


def _retrying_bsync_join(
    c: SimCluster, idx: int, attempt: int = 0, max_attempts: int = 10
) -> None:
    """Blocksync-join ``idx``, retrying every 2 virtual seconds while no
    live helper exists (or a previous join is still in flight).  All
    retries ride the scripted clock, so the dance replays from the seed."""
    if c.nodes[idx] is not None:
        return
    if not c.blocksync_join(idx) and attempt + 1 < max_attempts:
        c.clock.call_later(
            2.0,
            lambda: _retrying_bsync_join(c, idx, attempt + 1, max_attempts),
            label=f"scenario bsync-retry node{idx}",
        )


def _bsync_fault(j: int, method: str, src: int, on: bool):
    """Action body toggling a fault hook on joiner ``j``'s live harness —
    a no-op once the joiner has promoted (the harness is gone), so late
    scripted toggles can't crash a run that synced faster than scripted."""

    def act(c: SimCluster) -> None:
        h = c.blocksync_harness(j)
        if h is not None:
            getattr(h, method)(src, on)

    return act


def _blocksync_storm(s: Scenario) -> list[Action]:
    """A late joiner blocksyncs 40+ heights through lossy high-latency
    links while the helper set misbehaves: node1 goes mute mid-window
    (adaptive RTT timeouts fire and its requests re-assign), node2 serves
    forged block bodies (validate_block redo + exponential ban, then a
    half-open probe re-admits it once clean), and the joiner itself
    crash-restarts mid-catchup and resumes from its surviving stores."""
    j = s.n_vals

    def shape(c: SimCluster) -> None:
        c.net.set_node_links(
            j,
            delay_min=0.25,
            delay_max=0.7,
            drop_rate=0.2,
            bandwidth_bytes_per_s=65536.0,
        )

    return [
        Action(0.0, "WAN-grade loss/latency on the joiner's links", shape),
        Action(45.0, f"node{j} joins via blocksync (lossy)",
               lambda c: _retrying_bsync_join(c, j)),
        Action(47.0, "mute helper node1 (stall mid-window)",
               _bsync_fault(j, "set_mute", 1, True)),
        Action(48.0, "helper node2 starts forging block bodies",
               _bsync_fault(j, "set_tamper", 2, True)),
        Action(49.5, f"crash joiner node{j} mid-catchup",
               lambda c: c.blocksync_crash(j)),
        Action(50.5, f"node{j} resumes blocksync from its stores",
               lambda c: _retrying_bsync_join(c, j)),
        # the fresh pool's first volley lands on a forging node2: the
        # forged bodies sit just ahead of the low frontier, so the
        # validate-redo ban fires mid-storm and the half-open probe (and
        # re-admission) play out while the catchup is still running
        Action(50.6, "helper node2 forges again (post-restart)",
               _bsync_fault(j, "set_tamper", 2, True)),
        Action(53.0, "helper node2 behaves again",
               _bsync_fault(j, "set_tamper", 2, False)),
        Action(53.5, "mute helper node1 again (post-restart)",
               _bsync_fault(j, "set_mute", 1, True)),
        Action(58.0, "unmute helper node1",
               _bsync_fault(j, "set_mute", 1, False)),
        # the storm passes: with ~1.5 s lossy RTT against a ~1 s block
        # interval the head-chase can hover forever; clean links let the
        # joiner converge and switch to consensus
        Action(60.0, "storm passes: joiner links recover",
               lambda c, j=j: c.net.set_node_links(
                   j, delay_min=0.01, delay_max=0.05, drop_rate=0.0,
                   bandwidth_bytes_per_s=0.0)),
    ]


def _wan_catchup(s: Scenario) -> list[Action]:
    """3-region geo topology: a joiner in region 2 blocksyncs cross-region
    while consensus continues; mid-sync its whole region is geo-partitioned
    off (the 5-of-7 majority keeps committing — cutting the region costs
    only 2 validators — while the joiner drains its frozen intra-region
    helpers) and after heal it catches the moving head."""
    j = s.n_vals
    regions = [[0, 1, 2], [3, 4], [5, 6, j]]

    def shape(c: SimCluster) -> None:
        c.net.set_geo_clusters(regions, bandwidth_bytes_per_s=262144.0)

    return [
        Action(0.0, "geo-cluster fabric: 3 regions, bandwidth-shaped",
               shape),
        Action(62.0, f"node{j} joins via blocksync cross-region",
               lambda c: _retrying_bsync_join(c, j)),
        # mid-volley: cross-region requests in flight are yanked with the
        # cable, time out on the adaptive schedule and re-assign to the
        # joiner's (frozen) intra-region helpers
        Action(62.3, "geo-partition the joiner's region off",
               lambda c: c.net.geo_partition(2)),
        Action(68.0, "heal the geo-partition", lambda c: c.net.heal()),
    ]


# -- adversarial evidence scenarios ------------------------------------------


def _craft_dup_vote(c: SimCluster, signer: int, height: int, round_: int,
                    tag: bytes, forge: bool = False):
    """Real (or, with ``forge``, signature-broken) DuplicateVoteEvidence:
    validator ``signer`` double-signs two synthetic block ids at a
    committed height, timestamped to that height's block time so the
    production evidence verification chain accepts it."""
    import hashlib

    from cometbft_tpu_torch.types.basic import (
        PRECOMMIT_TYPE,
        BlockID,
        PartSetHeader,
    )
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
    from cometbft_tpu_torch.types.vote import Vote

    node = c.live_nodes()[0]
    meta = node.block_store.load_block_meta(height)
    vals = node.state_store.load_validators(height)
    priv = c.privs[signer]
    addr = priv.pub_key().address()
    idx, val = vals.get_by_address(addr)

    def mk(sub: bytes) -> Vote:
        seed = tag + sub
        bid = BlockID(
            hash=hashlib.sha256(seed).digest(),
            part_set_header=PartSetHeader(
                total=1, hash=hashlib.sha256(seed + b"p").digest()
            ),
        )
        v = Vote(
            type_=PRECOMMIT_TYPE,
            height=height,
            round_=round_,
            block_id=bid,
            timestamp=meta.header.time,
            validator_address=addr,
            validator_index=idx,
        )
        v.signature = priv.sign(v.sign_bytes(c.gdoc.chain_id))
        return v

    v1, v2 = mk(b"a"), mk(b"b")
    if forge:
        v2.signature = bytes(64)  # structurally plausible, never verifies
    return DuplicateVoteEvidence.from_votes(
        v1, v2, meta.header.time, val.voting_power, vals.total_voting_power()
    )


def _craft_light_attack(c: SimCluster, common_height: int,
                        signers: list[int], forge: bool = False):
    """Lunatic light-client attack: the header at common_height+1 with a
    forged app_hash, committed by ``signers`` (a >1/3 subset of the common
    validator set).  With ``forge`` the signatures are broken, so the
    evidence must be REJECTED."""
    import dataclasses
    import hashlib

    from cometbft_tpu_torch.types.basic import (
        BLOCK_ID_FLAG_ABSENT,
        BLOCK_ID_FLAG_COMMIT,
        PRECOMMIT_TYPE,
        BlockID,
        PartSetHeader,
    )
    from cometbft_tpu_torch.types.block import Commit
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.vote import CommitSig, Vote

    node = c.live_nodes()[0]
    h = common_height + 1
    real = node.block_store.load_block_meta(h)
    common_meta = node.block_store.load_block_meta(common_height)
    vals_h = node.state_store.load_validators(h)
    common_vals = node.state_store.load_validators(common_height)

    forged_header = dataclasses.replace(
        real.header, app_hash=hashlib.sha256(b"lunatic-app-state").digest()
    )
    bid = BlockID(
        hash=forged_header.hash(),
        part_set_header=PartSetHeader(
            total=1, hash=hashlib.sha256(b"lunatic-parts").digest()
        ),
    )
    signer_addrs = {c.privs[i].pub_key().address() for i in signers}
    sigs = []
    for idx, val in enumerate(vals_h.validators):
        if val.address not in signer_addrs:
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_ABSENT,
                    validator_address=b"",
                    timestamp=forged_header.time,
                    signature=b"",
                )
            )
            continue
        priv = next(
            c.privs[i]
            for i in signers
            if c.privs[i].pub_key().address() == val.address
        )
        v = Vote(
            type_=PRECOMMIT_TYPE,
            height=h,
            round_=0,
            block_id=bid,
            timestamp=forged_header.time,
            validator_address=val.address,
            validator_index=idx,
        )
        sig = priv.sign(v.sign_bytes(c.gdoc.chain_id))
        sigs.append(
            CommitSig(
                block_id_flag=BLOCK_ID_FLAG_COMMIT,
                validator_address=val.address,
                timestamp=forged_header.time,
                signature=bytes(64) if forge else sig,
            )
        )
    commit = Commit(height=h, round_=0, block_id=bid, signatures=sigs)
    byzantine = [
        common_vals.get_by_address(a)[1]
        for a in sorted(signer_addrs)
        if common_vals.get_by_address(a) is not None
    ]
    return LightClientAttackEvidence(
        conflicting_block=LightBlock(
            signed_header=SignedHeader(header=forged_header, commit=commit),
            validator_set=vals_h,
        ),
        common_height=common_height,
        byzantine_validators=byzantine,
        total_voting_power=common_vals.total_voting_power(),
        timestamp=common_meta.header.time,
    )


def _flood_pools(c: SimCluster, pieces: list, label: str) -> None:
    """Offer every crafted piece to every live node's evidence pool (the
    sim analog of evidence gossip), counting outcomes per node into the
    byte-compared trace."""
    from cometbft_tpu_torch.types.evidence import EvidenceError

    for node in c.live_nodes():
        before = node.evidence_pool.occupancy()
        rejected = 0
        for ev in pieces:
            try:
                node.evidence_pool.add_evidence(ev)
            except EvidenceError:
                rejected += 1
        depth, size = node.evidence_pool.occupancy()
        c._log(
            "scenario: %s node%d: offered=%d rejected=%d pool=%d->%d (%dB)"
            % (label, node.index, len(pieces), rejected, before[0], depth, size)
        )


def _dup_vote_flood(s: Scenario) -> list[Action]:
    """Duplicate-vote flood into the evidence pool: each wave mixes fresh
    real equivocations (distinct rounds), byte-identical duplicates of the
    first wave, and signature-forged pieces.  Dedup must catch repeats
    before any signature work, the scenario-shrunk pool bound must degrade
    overflow to counted drops, forgeries must be rejected — and verified
    evidence must still reach blocks through proposals while consensus
    stays unshed."""

    def flood(c: SimCluster, wave: int) -> None:
        height = 2  # committed well before the first wave fires
        pieces = []
        for j in range(12):
            pieces.append(
                _craft_dup_vote(
                    c, signer=1, height=height, round_=wave * 32 + j,
                    tag=b"flood-%d-%d" % (wave, j),
                )
            )
        # duplicates of wave 0 (identical bytes -> pool dedup, no sig work)
        for j in range(12):
            pieces.append(
                _craft_dup_vote(
                    c, signer=1, height=height, round_=j,
                    tag=b"flood-0-%d" % j,
                )
            )
        # forged: must be rejected by verification, never pooled
        for j in range(4):
            pieces.append(
                _craft_dup_vote(
                    c, signer=2, height=height, round_=wave * 32 + j,
                    tag=b"forged-%d-%d" % (wave, j), forge=True,
                )
            )
        _flood_pools(c, pieces, "dup-vote flood wave %d" % wave)

    return [
        Action(float(t), "duplicate-vote flood wave %d" % w,
               lambda c, w=w: flood(c, w))
        for w, t in enumerate((4, 6, 8))
    ]


def _light_attack(s: Scenario) -> list[Action]:
    """Light-client-attack evidence: a real lunatic forgery (>1/3 of the
    common set double-signing a conflicting header) must verify on the
    evidence seam and reach a block; a signature-broken variant must be
    rejected.  Both ride the verify scheduler's evidence class without
    ever blocking consensus submissions."""

    def attack(c: SimCluster) -> None:
        real = _craft_light_attack(c, common_height=2, signers=[0, 1])
        broken = _craft_light_attack(
            c, common_height=3, signers=[0, 1], forge=True
        )
        _flood_pools(c, [real, broken], "light attack")

    return [Action(6.0, "light-client attack evidence", attack)]


def _evidence_setup(extra_env: Optional[dict] = None, pool_max: int = 16):
    """Backend setup (host-oracle seam, scheduler ON so evidence checks
    ride the evidence class) plus a scenario-shrunk evidence pool bound and
    clean evidence counters."""
    base = _backend_faults_setup(
        dict(
            {
                "COMETBFT_TPU_VERIFY_SCHED": "1",
                "COMETBFT_TPU_SCHED_FLUSH_US": "500",
            },
            **(extra_env or {}),
        )
    )

    def setup(cluster: SimCluster) -> None:
        from cometbft_tpu_torch.evidence import stats as evstats

        base(cluster)
        evstats.reset()
        for node in cluster.live_nodes():
            node.evidence_pool.max_pending = pool_max

    return setup


def _evidence_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.evidence import stats as evstats

    _backend_faults_teardown(cluster)
    evstats.reset()


# -- disk-fault scenarios (docs/storage-robustness.md) ------------------------


def _disk_setup(cluster: SimCluster) -> None:
    """Install a fresh ``diskguard.FaultPlan`` for the run and pin the
    retry-backoff sleeper to a no-op: injection windows are COUNT-based
    (rule ordinals over the deterministic per-seed IO sequence), so wall
    sleeps would only slow the run without adding determinism."""
    from cometbft_tpu_torch.libs import diskguard as dg

    cluster._disk_prev_plan = dg.set_fault_plan(dg.FaultPlan())
    dg.set_sleeper(lambda _s: None)


def _disk_teardown(cluster: SimCluster) -> None:
    from cometbft_tpu_torch.libs import diskguard as dg

    dg.set_fault_plan(getattr(cluster, "_disk_prev_plan", None))
    dg.set_sleeper(None)


DISK_VICTIM = 1  # the node whose disk the disk-* scenarios break


def _disk_full(s: Scenario) -> list[Action]:
    """ENOSPC on one node's whole disk at t=5: its WAL (fail-stop) halts
    it before its next vote — no equivocation, ever — while its blackbox
    journal (degradable) degrades to counted drops.  The survivors keep
    agreement and reach the target without it."""

    def fill(c: SimCluster) -> None:
        import errno as _errno

        from cometbft_tpu_torch.libs import diskguard as dg

        plan = dg.get_fault_plan()
        c._log(
            "scenario: node%d disk full (ENOSPC, wal fail-stop + "
            "blackbox degrade)" % DISK_VICTIM
        )
        node_tag = "node%d/" % DISK_VICTIM
        plan.add(
            surface="wal", path_substr=node_tag, err=_errno.ENOSPC
        )
        plan.add(
            surface="blackbox", path_substr=node_tag, err=_errno.ENOSPC
        )

    return [Action(5.0, "disk full on node%d" % DISK_VICTIM, fill)]


def _disk_brownout(s: Scenario) -> list[Action]:
    """Transient EIO bursts against the degradable blackbox surface:
    short bursts (shorter than the retry budget) recover via bounded
    exponential backoff with ZERO drops; one long burst exhausts the
    budget and degrades to counted drops.  Consensus never notices."""

    def burst(c: SimCluster, n: int) -> None:
        import errno as _errno

        from cometbft_tpu_torch.libs import diskguard as dg

        dg.get_fault_plan().add(
            surface="blackbox", err=_errno.EIO, count=n
        )
        c._log("scenario: blackbox EIO burst len=%d" % n)

    return [
        Action(4.0, "EIO burst (retries recover)", lambda c: burst(c, 2)),
        Action(6.0, "EIO burst (retries recover)", lambda c: burst(c, 2)),
        Action(8.0, "EIO burst (retries recover)", lambda c: burst(c, 2)),
        Action(10.0, "EIO burst (exhausts retries)", lambda c: burst(c, 8)),
    ]


def _torn_wal_restart(s: Scenario) -> list[Action]:
    """Kill a node mid-frame: crash it, then cut its WAL head mid-way
    through the final frame — the torn tail a power cut leaves.  On
    restart the boot-time scrub truncates to the last CRC-valid frame
    (``wal_repair`` journaled, dropped bytes counted), the node replays
    to the repaired tail and rejoins the fleet."""

    def kill_mid_frame(c: SimCluster) -> None:
        import io as _io

        from cometbft_tpu_torch.consensus.wal import read_frame

        c.crash(DISK_VICTIM)
        wal_path = c.root / ("node%d" % DISK_VICTIM) / "cs.wal"
        try:
            data = wal_path.read_bytes()
        except OSError:
            data = b""
        # walk the valid frames (the WAL's own parser); cut halfway into
        # the final one
        f = _io.BytesIO(data)
        pos, last_start = 0, None
        while True:
            _kind, _payload, reason = read_frame(f)
            if reason is not None:
                break
            last_start = pos
            pos = f.tell()
        if last_start is not None:
            cut = last_start + 8 + max((pos - last_start - 8) // 2, 1)
        else:
            cut = max(len(data) - 1, 0)
        os.truncate(wal_path, cut)
        c._log(
            "scenario: tore node%d WAL mid-frame at byte %d (was %d)"
            % (DISK_VICTIM, cut, len(data))
        )

    return [
        Action(6.0, "kill node%d mid-frame" % DISK_VICTIM, kill_mid_frame),
        Action(
            20.0,
            "restart node%d (scrub + replay)" % DISK_VICTIM,
            lambda c: c.restart(DISK_VICTIM),
        ),
    ]


SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario(
            "baseline",
            "clean 4-validator run, default delay/jitter links",
        ),
        Scenario(
            "partition-minority",
            "cut off f nodes for 22 virtual seconds, heal, require full "
            "recovery with no fork",
            max_time=180.0,
            actions=_partition_minority,
        ),
        Scenario(
            "partition-leader",
            "cut off the current proposer, forcing round changes; heal and "
            "require it to catch back up",
            max_time=180.0,
            actions=_partition_leader,
        ),
        Scenario(
            "crash-restart",
            "kill f nodes mid-run; restart them from their stores (WAL + "
            "Handshaker replay) and require rejoin",
            max_time=180.0,
            actions=_crash_restart,
        ),
        Scenario(
            "asymmetric-loss",
            "30% one-directional message loss on node0's outbound links",
            max_time=240.0,
            actions=_asymmetric_loss,
        ),
        Scenario(
            "message-storm",
            "duplicate and aggressively reorder every link while txs flow",
            max_time=240.0,
            actions=_message_storm,
        ),
        Scenario(
            "gossip-burst",
            "vote storm (dup/reorder links) plus scripted 256-item bulk "
            "bursts against a 48-slot verify-scheduler queue: admission "
            "control must shed only bulk-class items, never consensus "
            "votes; agreement holds and traces stay byte-identical per "
            "seed.  Runs on the host-oracle device-runner seam so tier-1 "
            "never pays real XLA dispatches",
            target_height=6,
            max_time=180.0,
            actions=_gossip_burst,
            setup=_backend_faults_setup(
                {
                    "COMETBFT_TPU_VERIFY_SCHED": "1",
                    "COMETBFT_TPU_SCHED_QUEUE": "48",
                    "COMETBFT_TPU_SCHED_FLUSH_US": "500",
                }
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "pipeline-burst",
            "in-flight verify pipeline: back-to-back paused bulk rounds "
            "with the completion pool gated, so two fused flushes must "
            "genuinely overlap (in-flight depth 2) while consensus keeps "
            "committing; every future resolves with the definitive "
            "verdict and traces stay byte-identical per seed with the "
            "completion pool in the loop.  Runs on the host-oracle "
            "device-runner seam so tier-1 never pays real XLA dispatches",
            target_height=6,
            max_time=180.0,
            actions=_pipeline_burst,
            setup=_backend_faults_setup(
                {
                    "COMETBFT_TPU_VERIFY_SCHED": "1",
                    "COMETBFT_TPU_SCHED_PIPELINE": "1",
                    "COMETBFT_TPU_SCHED_INFLIGHT": "2",
                    "COMETBFT_TPU_SCHED_FLUSH_US": "500",
                }
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "light-stampede",
            "light-client read stampede: scripted 1500-query proof "
            "bursts (tx/header/valset mixes) against a 512-slot proof "
            "queue mid-consensus, on the host-oracle tree-runner seam: "
            "coalescing must collapse each burst into a handful of tree "
            "builds, shed only proof queries (consensus-class verify "
            "shed stays 0 by construction), answer every admitted "
            "future, and keep the response digest byte-identical per "
            "seed.  Runs on the host-oracle seam so tier-1 never pays "
            "real XLA dispatches",
            target_height=6,
            max_time=180.0,
            actions=_light_stampede,
            setup=_light_stampede_setup(),
            teardown=_light_stampede_teardown,
        ),
        Scenario(
            "dial-storm",
            "inbound-connection storm against the encrypted transport "
            "plane: scripted 600-dial handshake waves against a 256-slot "
            "pool queue mid-consensus plus coalesced AEAD frame batches "
            "with a tampered frame, on the host-oracle ladder/AEAD "
            "runner seams: shed dials fall to the sync ladder (never a "
            "dropped connection), consensus-class verify shed stays 0 "
            "by construction, the tampered batch delivers exactly the "
            "prefix before the bad tag, traces stay byte-identical per "
            "seed, and a final wave proves COMETBFT_TPU_AEAD=0 / "
            "COMETBFT_TPU_HANDSHAKE=0 kill-switch byte parity.  Runs on "
            "the host-oracle seams so tier-1 never pays real XLA "
            "dispatches",
            target_height=6,
            max_time=180.0,
            actions=_dial_storm,
            setup=_dial_storm_setup(),
            teardown=_dial_storm_teardown,
        ),
        Scenario(
            "tx-flood",
            "sustained scripted signed-tx bursts (valid/forged/malformed/"
            "oversize/duplicate mixes) from every peer against a 32-slot "
            "ingest queue: batched admission must produce the same "
            "verdicts as the per-tx path, shed only to the sync path, "
            "keep consensus-class verify shed at 0 and agreement intact.  "
            "Runs on the host-oracle device-runner seam so tier-1 never "
            "pays real XLA dispatches",
            target_height=6,
            max_time=240.0,
            actions=_tx_flood,
            setup=_tx_flood_setup,
            teardown=_tx_flood_teardown,
            app_factory=_txflood_app,
            # recheck=True so every commit exercises the batched recheck
            # round trip; the small max_tx_bytes makes oversize txs cheap
            mempool_config=MempoolConfig(recheck=True, max_tx_bytes=2048),
        ),
        Scenario(
            "backend-brownout",
            "device crypto backend raises on every dispatch on f+1 nodes "
            "from t=5 to t=10; supervisor degrades to host verify, keeps "
            "agreement, re-promotes after restore.  Breaker threshold 1: "
            "the registry is cluster-shared in-process, so healthy nodes' "
            "successes would otherwise keep resetting the victims' "
            "consecutive-failure count",
            target_height=14,
            max_time=180.0,
            actions=_backend_brownout,
            setup=_backend_faults_setup(
                {"COMETBFT_TPU_BREAKER_THRESHOLD": "1"}
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "backend-wedge",
            "device dispatches hang past the watchdog deadline on f+1 "
            "nodes from t=4 to t=9; the watchdog abandons them and the "
            "chain degrades without blocking consensus",
            target_height=14,
            max_time=180.0,
            actions=_backend_wedge,
            setup=_backend_faults_setup(
                {
                    "COMETBFT_TPU_DISPATCH_TIMEOUT_MS": "80",
                    "COMETBFT_TPU_BREAKER_THRESHOLD": "1",
                }
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "validator-rotation",
            "a standby full node spawns at genesis, is voted into the "
            "validator set via a val: tx (validate_validator_updates "
            "path), then a genesis validator is voted out; the invariant "
            "checker authenticates every header's validator hashes "
            "against its own replay of the rotation and verifies commits "
            "against the height-correct set",
            n_spares=1,
            target_height=12,
            max_time=180.0,
            actions=_validator_rotation,
        ),
        Scenario(
            "fleet-churn",
            "the fleet acceptance script: rotation + churn in one run — a "
            "spare is voted in and statesync-joins as a fresh machine "
            "(snapshot offer -> chunk fetch over the faulty fabric -> "
            "catchup tail), the last genesis validator is voted out and "
            "leaves gracefully, another validator crash-restarts from its "
            "stores.  Scales with --validators: the nightly soak runs it "
            "at 100 validators, tier-1 at 8",
            n_spares=1,
            target_height=14,
            max_time=300.0,
            actions=_fleet_churn,
        ),
        Scenario(
            "statesync-storm",
            "two fresh nodes statesync-join through 25%-lossy links while "
            "a chunk-serving peer crashes mid-sync: chunk re-requests must "
            "back off exponentially (statesync/syncer.py retry seam), "
            "rotate to surviving peers, and both joins must complete with "
            "invariants green",
            n_spares=2,
            target_height=16,
            max_time=300.0,
            actions=_statesync_storm,
        ),
        Scenario(
            "dup-vote-flood",
            "waves of duplicate-vote evidence (fresh equivocations + "
            "byte-identical repeats + signature forgeries) flood every "
            "node's evidence pool against a scenario-shrunk 8-entry "
            "bound: dedup before signature work, verified overflow "
            "degrades to counted drops (never memory), forgeries are "
            "rejected, and real evidence still reaches committed blocks "
            "through the verifysched evidence class with consensus shed "
            "0.  Runs on the host-oracle device-runner seam",
            target_height=12,
            max_time=240.0,
            actions=_dup_vote_flood,
            setup=_evidence_setup(pool_max=8),
            teardown=_evidence_teardown,
        ),
        Scenario(
            "light-attack",
            "a real lunatic light-client attack (2 of 4 validators "
            "double-sign a conflicting app_hash at a committed height) "
            "must verify through the evidence seam and land in a block; a "
            "signature-broken variant must be rejected — both on the "
            "verifysched evidence class, consensus never shed.  Runs on "
            "the host-oracle device-runner seam",
            target_height=12,
            max_time=240.0,
            actions=_light_attack,
            setup=_evidence_setup(),
            teardown=_evidence_teardown,
        ),
        Scenario(
            "chip-death",
            "one chip of the 4-wide elastic mesh dies mid-dispatch at "
            "t=5 and stays dead: the failed dispatch (alone) re-runs on "
            "the shrunken 3-device mesh, the mesh_dev2 breaker opens and "
            "keeps the corpse out of membership (each elapsed backoff "
            "costs one failed one-bucket probe, never a production "
            "batch), and at t=8 a chip-watcher probe marks ordinal 1 "
            "down — PROACTIVE exclusion before any dispatch fails; since "
            "that chip actually dispatches fine, its next half-open "
            "probe re-admits it (mesh_restore) while the dead chip stays "
            "out.  The fleet keeps committing throughout, verdicts never "
            "change, traces byte-identical per seed.  Runs on the "
            "per-shard host-oracle runner seam",
            target_height=14,
            max_time=240.0,
            actions=_chip_death,
            setup=_mesh_setup(),
            teardown=_mesh_teardown,
        ),
        Scenario(
            "mesh-brownout",
            "a flapping chip: mesh ordinal 1 fails in deterministic "
            "bursts (fail 2 / pass 4) from t=4 to t=12 — the mesh must "
            "shrink on failing bursts, the mesh_dev1 breaker must cycle "
            "open -> half-open -> closed on the virtual-clock backoff "
            "with a pass-phase probe re-admitting the chip "
            "(mesh_restore), and the mesh settles back at full width "
            "after the brownout.  Runs on the per-shard host-oracle "
            "runner seam",
            target_height=14,
            max_time=240.0,
            actions=_mesh_brownout,
            setup=_mesh_setup(),
            teardown=_mesh_teardown,
        ),
        Scenario(
            "byzantine-voter",
            "one LIVE validator double-signs every non-nil prevote and "
            "precommit from t=2 to t=8 (a second vote for a fabricated "
            "block id, signed with its real key, through the production "
            "gossip fabric — no crafted evidence): honest nodes must "
            "detect the equivocation in their vote sets, convert it to "
            "DuplicateVoteEvidence at finalize, commit it, and hold "
            "agreement + validator-set invariants, byte-deterministic "
            "per seed",
            target_height=12,
            max_time=240.0,
            actions=_byzantine_voter,
        ),
        Scenario(
            "combined-storm",
            "the composition layer's proof: minority partition + device "
            "backend brownout on f+1 nodes + scripted bulk verify bursts "
            "+ a mesh blackout (3 of 4 ordinals die t=5..10.5, so the "
            "mesh collapses below width 2 and the single-chip brownout "
            "REALLY fires underneath it) composed in ONE script "
            "(compose()).  Agreement must hold, only bulk-class verify "
            "work may shed, the full ladder mesh(4)->...->xla->host must "
            "degrade and every layer must re-promote after the storm",
            target_height=14,
            max_time=300.0,
            actions=compose(
                _partition_minority,
                _backend_brownout,
                _gossip_burst,
                _mesh_blackout,
            ),
            setup=_mesh_setup(
                {
                    "COMETBFT_TPU_VERIFY_SCHED": "1",
                    "COMETBFT_TPU_SCHED_QUEUE": "48",
                    "COMETBFT_TPU_SCHED_FLUSH_US": "500",
                    # failed probes during the blackout double each dead
                    # chip's backoff; cap it low so re-admission probes
                    # recur fast enough to restore full width before the
                    # run ends (deterministic: virtual clock)
                    "COMETBFT_TPU_BREAKER_BACKOFF_MAX_MS": "2000",
                }
            ),
            teardown=_mesh_teardown,
        ),
        Scenario(
            "disk-full",
            "node1's disk fills at t=5 (injected ENOSPC): the next WAL "
            "append fail-stops it with a typed StorageFatal BEFORE it "
            "can vote on unpersisted state (journaled disk_fatal with "
            "surface/errno attribution), its blackbox degrades to "
            "counted drops, and the survivors keep agreement and reach "
            "the target without it — byte-deterministic per seed",
            target_height=10,
            max_time=180.0,
            actions=_disk_full,
            setup=_disk_setup,
            teardown=_disk_teardown,
        ),
        Scenario(
            "disk-brownout",
            "transient EIO bursts on the degradable blackbox surface "
            "(t=4..10): bursts shorter than the retry budget recover "
            "via bounded exponential backoff with zero drops; one long "
            "burst degrades to counted drops + a disk_fault anomaly.  "
            "No node halts, consensus never notices, agreement holds",
            target_height=12,
            max_time=180.0,
            actions=_disk_brownout,
            setup=_disk_setup,
            teardown=_disk_teardown,
        ),
        Scenario(
            "torn-wal-restart",
            "node1 is killed mid-frame at t=6 (its WAL head cut halfway "
            "through the final frame, the torn tail a power cut "
            "leaves); on restart at t=20 the boot-time scrub truncates "
            "to the last CRC-valid frame (wal_repair journaled, dropped "
            "bytes counted), the node replays to the repaired tail and "
            "rejoins — byte-deterministic per seed",
            target_height=12,
            max_time=240.0,
            actions=_torn_wal_restart,
            setup=_disk_setup,
            teardown=_disk_teardown,
        ),
        Scenario(
            "backend-flap",
            "device backend fails in bursts of 4 with 2 clean dispatches "
            "between (t=3..14): breaker cycles open/half-open/closed on "
            "the virtual-clock backoff schedule.  Bisection is disabled — "
            "a flapping backend would let the bisector spuriously 'solve' "
            "each burst and mask the breaker cycling under test",
            target_height=12,
            max_time=240.0,
            actions=_backend_flap,
            setup=_backend_faults_setup(
                {"COMETBFT_TPU_SUPERVISOR_BISECT": "0"}
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "blocksync-storm",
            "a late joiner blocksyncs 40+ heights through lossy "
            "high-latency links while the helper set misbehaves: node1 "
            "goes mute mid-window (adaptive RTT timeouts fire and its "
            "requests re-assign), node2 serves forged block bodies "
            "(validate_block redo + exponential ban, half-open probe "
            "re-admits it once clean), and the joiner crash-restarts "
            "mid-catchup and resumes from its surviving stores.  Commit "
            "verification rides the fused-prefetch dispatch windows; "
            "the whole dance is byte-deterministic per seed",
            target_height=75,
            max_time=420.0,
            n_spares=1,
            actions=_blocksync_storm,
            setup=_backend_faults_setup(
                {
                    "COMETBFT_TPU_SIGCACHE": "1",
                    # short ban base + stall window + tight timeout mult
                    # so the exponential ban -> half-open probe ->
                    # re-admission cycle and a stall-switch all land
                    # INSIDE the catchup window (at mult 4 a dropped
                    # frontier response costs ~5 s — two in a row and the
                    # frontier never reaches the forged heights)
                    "COMETBFT_TPU_BSYNC_BAN_BASE": "2.0",
                    "COMETBFT_TPU_BSYNC_STALL_SECS": "3.0",
                    "COMETBFT_TPU_BSYNC_TIMEOUT_MULT": "2.0",
                }
            ),
            teardown=_backend_faults_teardown,
        ),
        Scenario(
            "wan-catchup",
            "3-region geo topology (intra 2-10ms, inter 60-180ms "
            "one-way, bandwidth-shaped links): a joiner in region 2 "
            "blocksyncs 40+ heights cross-region while consensus "
            "continues; mid-sync its whole region is geo-partitioned "
            "off — the 5-of-7 majority keeps committing, the joiner "
            "drains its frozen intra-region helpers and stalls — and "
            "after heal it catches the head and promotes.  Per-round "
            "quorum timelines land in the flight-recorder rounds report",
            n_vals=7,
            target_height=60,
            max_time=420.0,
            n_spares=1,
            actions=_wan_catchup,
            setup=_backend_faults_setup(
                {
                    "COMETBFT_TPU_SIGCACHE": "1",
                    "COMETBFT_TPU_BSYNC_BAN_BASE": "2.0",
                }
            ),
            teardown=_backend_faults_teardown,
        ),
    ]
}


def run_scenario(
    name: str,
    seed: int,
    root=None,
    n_vals: Optional[int] = None,
    target_height: Optional[int] = None,
    max_time: Optional[float] = None,
    raise_on_violation: bool = False,
    keep_cluster: bool = False,
    device=None,
) -> ScenarioResult:
    """Build a cluster on ``device`` (None: the card), script the
    scenario's actions onto its virtual clock, and drive it to the target
    height (or the time budget)."""
    scenario = SCENARIOS.get(name) or SCENARIOS[name.replace("_", "-")]
    name = scenario.name
    # overrides flow into the scenario the action generators see, so e.g.
    # _partition_minority picks its victims from the real cluster size
    scenario = replace(
        scenario,
        n_vals=n_vals or scenario.n_vals,
        target_height=target_height or scenario.target_height,
        max_time=max_time or scenario.max_time,
    )
    created_root = root is None
    if created_root:
        root = Path(tempfile.mkdtemp(prefix=f"sim-{name}-{seed}-"))
    cluster = SimCluster(
        scenario.n_vals,
        root,
        seed=seed,
        raise_on_violation=raise_on_violation,
        app_factory=scenario.app_factory,
        mempool_config=scenario.mempool_config,
        n_spares=scenario.n_spares,
        device=device,
    )
    for src_dst, overrides in scenario.link_overrides.items():
        cluster.net.set_link(*src_dst, **overrides)
    for action in scenario.actions(scenario):
        cluster.clock.call_at(
            action.at,
            lambda a=action: a.fn(cluster),
            label=f"scenario {action.name}",
        )
    backend_stats: dict = {}
    sched_stats: dict = {}
    ingest_counters: dict = {}
    evidence_counters: dict = {}
    spans_capture: dict = {}
    blackbox_capture: dict = {}
    postmortem_capture: list = []
    # per-run evidence counters: the process-wide stats must not bleed one
    # run's flood into the next run's ScenarioResult
    from cometbft_tpu_torch.evidence import stats as _evstats

    _evstats.reset()
    # flight recorder on the virtual clock: reset per run (span ids and
    # therefore anomaly-dump bytes become a pure function of the seed),
    # dumps land under the run root unless the caller pinned a dir
    from cometbft_tpu_torch.libs import tracing as _tracing

    _tracer = _tracing.get_tracer()
    _saved_trace_dir = os.environ.get("COMETBFT_TPU_TRACE_DIR")
    _trace_dir = Path(root) / "flight"
    os.environ["COMETBFT_TPU_TRACE_DIR"] = str(_trace_dir)
    _tracer.reset()
    _tracer.set_clock(cluster.clock.now)
    # the dispatch ordinal in verify.dispatch spans comes from the
    # process-wide dispatch counter — zero it so dump bytes are a pure
    # function of the seed (tests only ever use dispatch-count DELTAS)
    from cometbft_tpu_torch.ops import dispatch_stats as _dstats

    _dstats.reset()
    # journal HEALTH records snapshot the sched/ingest counters, so those
    # must be per-run too or the black-box bytes of two same-seed runs in
    # one process would differ (the backend scenarios already reset them
    # in setup; plain scenarios need the same hygiene)
    from cometbft_tpu_torch.txingest import stats as _istats
    from cometbft_tpu_torch.verifysched import stats as _sstats

    _sstats.reset()
    _istats.reset()
    # proof-plane counters are per-run too: every scenario's commits hash
    # through the plane, and a soak row must reflect ITS run alone
    from cometbft_tpu_torch.proofserve import stats as _pstats

    _pstats.reset()
    proofs_counters: dict = {}
    # transport-plane counters are per-run too (dial-storm): a soak row
    # must reflect ITS run's frames and handshakes alone
    from cometbft_tpu_torch.p2p import transport_stats as _tpstats

    _tpstats.reset()
    transport_counters: dict = {}
    # blocksync catchup counters are per-run too (blocksync-storm /
    # wan-catchup): a soak row must reflect ITS run's catchup alone
    from cometbft_tpu_torch.blocksync import stats as _bstats

    _bstats.reset()
    bsync_counters: dict = {}
    # disk-fault counters are per-run too: every scenario writes WALs
    # through the guard, and a soak row must reflect ITS run's IO alone
    from cometbft_tpu_torch.libs import storage_stats as _ss

    _ss.reset()
    storage_capture: dict = {}
    fail_stopped_capture: list = []
    try:
        if scenario.setup is not None:
            scenario.setup(cluster)
        reached = cluster.run(
            until_height=scenario.target_height, max_time=scenario.max_time
        )
        if scenario.setup is not None:
            # capture BEFORE teardown resets the registry
            from cometbft_tpu_torch.crypto import backend_health

            snap = backend_health.snapshot()
            backend_stats = {
                "demotions": snap["demotions"],
                "repromotions": snap["repromotions"],
                "watchdog_fires": snap["watchdog_fires"],
                "fallback_signatures": snap["fallback_signatures"],
                "quarantined": snap["quarantined"],
                "breaker_opens": sum(
                    b["opens"] for b in snap["breakers"].values()
                ),
                "breakers": {
                    n: b["state"] for n, b in snap["breakers"].items()
                },
            }
            # elastic-mesh shape of the run (chip-death / mesh-brownout /
            # combined-storm): width at end of run + shrink/restore
            # counts, only when the mesh actually ran
            msnap = _dstats.snapshot()
            if msnap["mesh_width"] or msnap["mesh_shrinks"]:
                backend_stats["mesh_width"] = msnap["mesh_width"]
                backend_stats["mesh_shrinks"] = msnap["mesh_shrinks"]
                backend_stats["mesh_restores"] = msnap["mesh_restores"]
            # only when the scenario ran with the scheduler enabled —
            # backend-* scenarios pin it off, and an all-zero sched block
            # in their soak rows would read as "scheduler ran, idle"
            if os.environ.get("COMETBFT_TPU_VERIFY_SCHED", "1") != "0":
                from cometbft_tpu_torch.verifysched import stats as sstats

                sched_stats = sstats.snapshot()
            # tx-ingestion counters (tx-flood): only when the pipeline
            # actually ran — an all-zero block would read as "ran, idle"
            from cometbft_tpu_torch.txingest import stats as istats

            isnap = istats.snapshot()
            if isnap["enqueued"] or isnap["shed_to_sync"] or isnap["flushes"]:
                ingest_counters = isnap
        # proof-plane counters (light-stampede): only when the proof
        # server / tree plane actually saw traffic this run
        psnap = _pstats.snapshot()
        if psnap["queries_total"] or psnap["trees_device"] or psnap[
            "trees_host"
        ]:
            proofs_counters = psnap
        # transport-plane counters (dial-storm): only when the plane or
        # the handshake pool actually saw traffic this run
        tpsnap = _tpstats.snapshot()
        if tpsnap["frames_total"] or tpsnap["handshakes_total"]:
            transport_counters = tpsnap
        # blocksync catchup counters (blocksync-storm / wan-catchup):
        # only when a joiner actually catch-up-synced this run
        bsnap = _bstats.snapshot()
        if bsnap["requests"] or bsnap["blocks_received"]:
            bsync_counters = bsnap
        # evidence-pool counters (dup-vote-flood / light-attack): only
        # when the pool actually saw traffic this run
        from cometbft_tpu_torch.evidence import stats as evstats

        esnap = evstats.snapshot()
        if esnap["added"] or esnap["dedup"] or esnap["rejected"]:
            evidence_counters = esnap
        # flight-recorder capture — dumps hashed NOW, before the run root
        # (and the dump files under it) are deleted below
        tsnap = _tracer.snapshot()
        dumps = []
        for dump_name in tsnap["dumps"]:
            try:
                blob = (_trace_dir / dump_name).read_bytes()
            except OSError:
                continue
            import hashlib as _hashlib

            dumps.append(
                {
                    "file": dump_name,
                    "bytes": len(blob),
                    "sha256": _hashlib.sha256(blob).hexdigest(),
                }
            )
        # black-box capture — journal counters + crashed nodes' restart
        # postmortems, read NOW, before the run root (and the journal
        # files under it) are deleted below
        blackbox_capture = (
            cluster.blackbox_stats() if cluster.blackbox else {}
        )
        postmortem_capture = list(cluster.postmortems)
        # disk-fault capture: attached only when something actually went
        # wrong on the storage plane (faults, retries, drops, repairs) —
        # clean rows must not grow dead all-zero columns
        if _ss.faulted():
            storage_capture = _ss.snapshot()
        fail_stopped_capture = sorted(cluster.fail_stopped)
        spans_capture = {
            "recorded": tsnap["spans_recorded"],
            "dropped": tsnap["spans_dropped"],
            "anomalies": tsnap["anomalies"],
            "stages": _tracer.stage_summary(),
            "dumps": dumps,
            # merged cross-node round timelines (the whole ring window):
            # per-(height, round) causal trees rooted at the originating
            # proposal, per-step p50/p99, quorum-arrival percentiles and
            # the commit-to-proposal trace linkage counts.  A pure
            # function of the seed — determinism tests byte-compare its
            # sort_keys JSON across same-seed runs.
            "rounds": _tracer.rounds_report(),
        }
    finally:
        _tracer.set_clock(None)
        _tracer.reset()
        if _saved_trace_dir is None:
            os.environ.pop("COMETBFT_TPU_TRACE_DIR", None)
        else:
            os.environ["COMETBFT_TPU_TRACE_DIR"] = _saved_trace_dir
        if scenario.teardown is not None:
            scenario.teardown(cluster)
        cluster.stop()
        if created_root and not keep_cluster:
            shutil.rmtree(root, ignore_errors=True)
    return ScenarioResult(
        scenario=name,
        seed=seed,
        n_vals=scenario.n_vals,
        target_height=scenario.target_height,
        reached=reached,
        heights=cluster.heights(),
        virtual_time=cluster.clock.now(),
        events=cluster.events_fired,
        commits_verified=cluster.checker.commits_verified,
        violations=[str(v) for v in cluster.checker.violations],
        trace=cluster.trace,
        cluster=cluster if keep_cluster else None,
        backend=backend_stats,
        sched=sched_stats,
        ingest=ingest_counters,
        evidence=evidence_counters,
        rotations=cluster.checker.rotations_seen,
        spans=spans_capture,
        blackbox=blackbox_capture,
        postmortems=postmortem_capture,
        storage=storage_capture,
        fail_stopped=fail_stopped_capture,
        proofs=proofs_counters,
        transport=transport_counters,
        bsync=bsync_counters,
    )
