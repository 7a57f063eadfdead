"""In-memory message fabric with seeded fault injection.

Every consensus message a node broadcasts is scheduled for delivery to each
connected peer through a per-link ``LinkConfig``: uniform delay in
``[delay_min, delay_max]``, independent drop / duplicate probabilities, and
a reorder knob that adds extra jitter to a fraction of messages (enough to
invert arrival order against the send order).  All randomness comes from the
single ``random.Random`` the cluster seeds, so the full delivery schedule is
a pure function of (seed, scenario).

Partitions are scripted as node groups: a message crosses the fabric only if
sender and receiver are in the same group *both* when it is sent and when it
would arrive — cutting a link also kills traffic already in flight, like
yanking a cable.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from cometbft_tpu_torch.sim.clock import VirtualClock


@dataclass
class LinkConfig:
    delay_min: float = 0.01
    delay_max: float = 0.05
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    reorder_rate: float = 0.0
    reorder_jitter: float = 0.25  # extra delay ceiling for reordered msgs
    # Serialization rate: a payload of size_bytes adds size/bandwidth to
    # the propagation delay (0 = infinite pipe, the pre-WAN behavior).
    # Only senders that declare a payload size pay it — consensus gossip
    # is small and modeled latency-only; blocksync block responses and
    # statesync chunks are the big-payload callers (docs/sim-design.md).
    bandwidth_bytes_per_s: float = 0.0

    def update(self, **overrides) -> None:
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise AttributeError(f"LinkConfig has no knob {k!r}")
            setattr(self, k, v)

    def transfer_delay(self, size_bytes: int) -> float:
        """Extra serialization delay for a payload of ``size_bytes``."""
        if self.bandwidth_bytes_per_s <= 0.0 or size_bytes <= 0:
            return 0.0
        return size_bytes / self.bandwidth_bytes_per_s


# Geo-cluster latency classes (one-way, seconds): intra-region links stay
# LAN-ish; inter-region links get intercontinental spreads.  Values echo
# the committee-consensus measurement regime (PAPERS.md, arXiv:2302.00418)
# where geo-distribution, not crypto, dominates tail behavior.
GEO_INTRA = {"delay_min": 0.002, "delay_max": 0.010}
GEO_INTER = {"delay_min": 0.060, "delay_max": 0.180}


@dataclass
class NetStats:
    sent: int = 0
    delivered: int = 0
    dropped_rate: int = 0  # lost to drop_rate
    dropped_partition: int = 0
    duplicated: int = 0


class SimNetwork:
    """Fabric between ``n`` nodes; delivery goes through ``deliver_fn(dst,
    src, msg, ctx)`` which the cluster installs (``ctx`` is the optional
    trace context the gossip envelope carried)."""

    def __init__(self, clock: VirtualClock, rng: random.Random, n: int):
        self.clock = clock
        self.rng = rng
        self.n = n
        self.links: dict[tuple[int, int], LinkConfig] = {
            (i, j): LinkConfig()
            for i in range(n)
            for j in range(n)
            if i != j
        }
        self._group_of: Optional[dict[int, int]] = None  # node -> group id
        self._regions: list[list[int]] = []  # set by set_geo_clusters
        self.deliver_fn: Optional[
            Callable[[int, int, object, object], None]
        ] = None
        self.alive_fn: Callable[[int], bool] = lambda _i: True
        self.stats = NetStats()

    # -- topology scripting ------------------------------------------------

    def set_link(self, src: int, dst: int, **overrides) -> None:
        self.links[(src, dst)].update(**overrides)

    def set_all_links(self, **overrides) -> None:
        for cfg in self.links.values():
            cfg.update(**overrides)

    def set_node_links(self, i: int, **overrides) -> None:
        """Apply overrides to every link touching node ``i`` (both
        directions) — the statesync-storm scenario degrades a joiner's
        connectivity without touching the rest of the fabric."""
        for (src, dst), cfg in self.links.items():
            if src == i or dst == i:
                cfg.update(**overrides)

    def set_geo_clusters(
        self,
        regions: "list[list[int]]",
        intra: Optional[dict] = None,
        inter: Optional[dict] = None,
        **extra,
    ) -> None:
        """Shape the fabric as geo-clusters: every link inside one region
        gets the ``intra`` latency class (default ``GEO_INTRA``), every
        cross-region link the ``inter`` class (default ``GEO_INTER``).
        ``extra`` knobs (drop/bandwidth/...) apply to ALL links on top.
        Nodes not named in any region form one implicit remainder region.
        Composes with ``partition``/``geo_partition``: latency classes
        shape live links, partitions cut them."""
        self._regions = [list(r) for r in regions]
        region_of: dict[int, int] = {}
        for rid, region in enumerate(self._regions):
            for i in region:
                region_of[i] = rid
        for i in range(self.n):
            region_of.setdefault(i, len(self._regions))
        intra = dict(GEO_INTRA if intra is None else intra)
        inter = dict(GEO_INTER if inter is None else inter)
        for (src, dst), cfg in self.links.items():
            cls = intra if region_of[src] == region_of[dst] else inter
            cfg.update(**cls)
            if extra:
                cfg.update(**extra)

    def geo_partition(self, *cut_regions: int) -> None:
        """Cut the named regions (indices into the ``set_geo_clusters``
        list) off from the rest of the world — each cut region becomes its
        own partition group; everything else stays one group."""
        if not getattr(self, "_regions", None):
            raise RuntimeError("geo_partition requires set_geo_clusters first")
        self.partition(*[self._regions[r] for r in cut_regions])

    def partition(self, *groups: list[int]) -> None:
        """Split the cluster into the given groups; nodes not named form one
        implicit remainder group.  Replaces any existing partition."""
        group_of: dict[int, int] = {}
        for gid, group in enumerate(groups):
            for i in group:
                group_of[i] = gid
        for i in range(self.n):
            group_of.setdefault(i, len(groups))
        self._group_of = group_of

    def heal(self) -> None:
        self._group_of = None

    def connected(self, i: int, j: int) -> bool:
        if self._group_of is None:
            return True
        return self._group_of[i] == self._group_of[j]

    # -- traffic -----------------------------------------------------------

    def send(self, src: int, msg: object, ctx=None) -> None:
        """Broadcast from ``src`` to every other live node (push gossip,
        mirroring the loopback harness this package grew out of).  ``ctx``
        is an optional encoded trace context riding the envelope
        (docs/observability.md "Cross-node tracing") — delivered to
        ``deliver_fn`` alongside the message, dropped with it."""
        for dst in range(self.n):
            if dst == src:
                continue
            self._schedule(src, dst, msg, ctx)

    def unicast(
        self, src: int, dst: int, msg: object, ctx=None, size_bytes: int = 0
    ) -> None:
        """Point-to-point send through the same faulty link (catchup).
        ``size_bytes`` > 0 adds serialization delay on bandwidth-shaped
        links (``LinkConfig.bandwidth_bytes_per_s``)."""
        self._schedule(src, dst, msg, ctx, size_bytes=size_bytes)

    def _schedule(
        self, src: int, dst: int, msg: object, ctx=None, size_bytes: int = 0
    ) -> None:
        cfg = self.links[(src, dst)]
        self.stats.sent += 1
        if not self.connected(src, dst):
            self.stats.dropped_partition += 1
            return
        if cfg.drop_rate > 0.0 and self.rng.random() < cfg.drop_rate:
            self.stats.dropped_rate += 1
            return
        copies = 1
        if cfg.dup_rate > 0.0 and self.rng.random() < cfg.dup_rate:
            copies = 2
            self.stats.duplicated += 1
        xfer = cfg.transfer_delay(size_bytes)
        for _ in range(copies):
            delay = self.rng.uniform(cfg.delay_min, cfg.delay_max) + xfer
            if cfg.reorder_rate > 0.0 and self.rng.random() < cfg.reorder_rate:
                delay += self.rng.uniform(0.0, cfg.reorder_jitter)
            self.clock.call_later(
                delay,
                lambda s=src, d=dst, m=msg, c=ctx: self._deliver(s, d, m, c),
                label=f"net {src}->{dst}",
            )

    def schedule_transfer(
        self,
        src: int,
        dst: int,
        fn: Callable[[], None],
        label: str = "xfer",
        size_bytes: int = 0,
    ) -> bool:
        """Schedule an arbitrary point-to-point delivery callback through
        the same faulty link as consensus traffic (delay/drop/partition;
        duplication is meaningless for idempotent transfers and skipped).
        Statesync snapshot/chunk responses ride this, so a lossy or
        partitioned link starves a bootstrapping joiner exactly like it
        starves gossip.  Returns False when the transfer was dropped.

        Unlike ``_schedule`` the delivery does NOT consult ``alive_fn`` —
        a joiner mid-bootstrap is not in the cluster's node table yet."""
        cfg = self.links[(src, dst)]
        self.stats.sent += 1
        if not self.connected(src, dst):
            self.stats.dropped_partition += 1
            return False
        if cfg.drop_rate > 0.0 and self.rng.random() < cfg.drop_rate:
            self.stats.dropped_rate += 1
            return False
        delay = self.rng.uniform(cfg.delay_min, cfg.delay_max) + cfg.transfer_delay(
            size_bytes
        )
        if cfg.reorder_rate > 0.0 and self.rng.random() < cfg.reorder_rate:
            delay += self.rng.uniform(0.0, cfg.reorder_jitter)

        def deliver() -> None:
            if not self.connected(src, dst):
                self.stats.dropped_partition += 1
                return
            self.stats.delivered += 1
            fn()

        self.clock.call_later(delay, deliver, label=f"net {label} {src}->{dst}")
        return True

    def _deliver(self, src: int, dst: int, msg: object, ctx=None) -> None:
        if not self.connected(src, dst):
            self.stats.dropped_partition += 1
            return
        if not self.alive_fn(dst) or not self.alive_fn(src):
            return  # crashed endpoints: traffic dies with the process
        self.stats.delivered += 1
        if self.deliver_fn is not None:
            self.deliver_fn(dst, src, msg, ctx)
