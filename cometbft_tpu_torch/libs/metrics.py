"""Metrics: Counter/Gauge/Histogram with Prometheus text exposition.

Reference: libs/metrics + per-package ``metrics.go`` (generated by
scripts/metricsgen).  Here metric structs declare their fields inline
(``MetricsGroup``) — the declarative role metricsgen plays in the
reference — and a process-wide registry renders the ``/metrics`` page
served when instrumentation.prometheus is on (reference:
node/node.go:597 startPrometheusServer).
"""

from __future__ import annotations

import threading
import time
from typing import Optional


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._values: dict[tuple, float] = {}

    def add(self, n: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def collect(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        return [
            f"{self.name}{_fmt_labels(dict(k))} {v:g}" for k, v in items
        ] or [f"{self.name} 0"]


class Gauge(_Metric):
    TYPE = "gauge"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(v)

    def add(self, n: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def collect(self) -> list[str]:
        with self._lock:
            items = list(self._values.items())
        return [
            f"{self.name}{_fmt_labels(dict(k))} {v:g}" for k, v in items
        ] or [f"{self.name} 0"]


class Histogram(_Metric):
    TYPE = "histogram"

    DEFAULT_BUCKETS = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
    )

    def __init__(self, name, help_="", buckets=None, registry=None):
        super().__init__(name, help_, registry)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def collect(self) -> list[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._n, self._sum
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {s:g}")
        out.append(f"{self.name}_count {total}")
        return out

    def time(self):
        """Context manager observing elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0)

        return _Timer()


class CallbackGauge(_Metric):
    """A gauge whose value is read at scrape time — for values that live
    in other modules (signature cache, dispatch stats) without making those
    modules depend on a metrics registry.  The callback must be cheap and
    must not initialize heavy backends (a /metrics scrape should never be
    what first touches the card)."""

    TYPE = "gauge"

    def __init__(self, name, fn, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._fn = fn

    def collect(self) -> list[str]:
        try:
            v = float(self._fn())
        except Exception:  # noqa: BLE001 — a scrape must never raise
            v = 0.0
        return [f"{self.name} {v:g}"]


class CallbackCounter(CallbackGauge):
    """Scrape-time-read MONOTONIC cumulative value: exposed with TYPE
    counter so rate()/increase() get counter-reset handling across process
    restarts (a _total-suffixed gauge also fails OpenMetrics linting).  The
    callback must never decrease within a process."""

    TYPE = "counter"


class CallbackHistogram(_Metric):
    """Scrape-time histogram over EXTERNALLY-kept bucket counts: the
    callback returns the ``libs/histo.Histo.to_dict`` wire shape
    (``bounds`` / non-cumulative ``counts`` / ``sum`` / ``count``) and the
    collector renders cumulative ``_bucket{le=}`` series.  Same contract
    as ``CallbackGauge``: cheap, never raises into a scrape, never
    initializes heavy backends — which is why the hot-path stats modules
    keep the observations and this class only renders them."""

    TYPE = "histogram"

    def __init__(self, name, fn, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._fn = fn

    @staticmethod
    def _render(name: str, h: dict, label: str = "") -> list:
        sep = "," if label else ""
        out, cum = [], 0
        for b, c in zip(h.get("bounds", ()), h.get("counts", ())):
            cum += c
            out.append(f'{name}_bucket{{{label}{sep}le="{b:g}"}} {cum}')
        total = h.get("count", 0)
        out.append(f'{name}_bucket{{{label}{sep}le="+Inf"}} {total}')
        if label:
            out.append(f'{name}_sum{{{label}}} {h.get("sum", 0.0):g}')
            out.append(f'{name}_count{{{label}}} {total}')
        else:
            out.append(f'{name}_sum {h.get("sum", 0.0):g}')
            out.append(f'{name}_count {total}')
        return out

    def collect(self) -> list[str]:
        try:
            h = dict(self._fn())
        except Exception:  # noqa: BLE001 — a scrape must never raise
            h = {}
        return self._render(self.name, h)


class LabeledCallbackHistogram(CallbackHistogram):
    """Scrape-time histogram over a DICT of histograms: the callback
    returns ``{label_value: histo_dict}`` and each entry renders as one
    labeled histogram series (e.g. submit->verdict latency per priority
    class, dispatch wall time per tier-bucket)."""

    def __init__(self, name, label: str, fn, help_="", registry=None):
        super().__init__(name, fn, help_, registry)
        self._label = label

    def collect(self) -> list[str]:
        try:
            values = dict(self._fn())
        except Exception:  # noqa: BLE001 — a scrape must never raise
            values = {}
        out = []
        for k, h in sorted(values.items()):
            out.extend(
                self._render(self.name, dict(h), f'{self._label}="{k}"')
            )
        return out or [f"{self.name}_count 0"]


class LabeledCallbackGauge(_Metric):
    """Scrape-time gauge over a DICT of values: the callback returns
    ``{label_value: number}`` and each entry renders as one labeled sample
    (e.g. per-backend circuit-breaker state).  Same contract as
    ``CallbackGauge``: cheap, never raises into a scrape, never initializes
    heavy backends."""

    TYPE = "gauge"

    def __init__(self, name, label: str, fn, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._label = label
        self._fn = fn

    def collect(self) -> list[str]:
        try:
            values = dict(self._fn())
        except Exception:  # noqa: BLE001 — a scrape must never raise
            values = {}
        if not values:
            return [f"{self.name} 0"]
        return [
            f'{self.name}{{{self._label}="{k}"}} {float(v):g}'
            for k, v in sorted(values.items())
        ]


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, m: _Metric) -> None:
        with self._lock:
            self._metrics.append(m)

    def counter(self, subsystem: str, name: str, help_: str = "") -> Counter:
        return Counter(f"{self.namespace}_{subsystem}_{name}", help_, self)

    def gauge(self, subsystem: str, name: str, help_: str = "") -> Gauge:
        return Gauge(f"{self.namespace}_{subsystem}_{name}", help_, self)

    def histogram(
        self, subsystem: str, name: str, help_: str = "", buckets=None
    ) -> Histogram:
        return Histogram(
            f"{self.namespace}_{subsystem}_{name}", help_, buckets, self
        )

    def callback_gauge(
        self, subsystem: str, name: str, fn, help_: str = ""
    ) -> CallbackGauge:
        return CallbackGauge(
            f"{self.namespace}_{subsystem}_{name}", fn, help_, self
        )

    def callback_counter(
        self, subsystem: str, name: str, fn, help_: str = ""
    ) -> CallbackCounter:
        return CallbackCounter(
            f"{self.namespace}_{subsystem}_{name}", fn, help_, self
        )

    def labeled_callback_gauge(
        self, subsystem: str, name: str, label: str, fn, help_: str = ""
    ) -> LabeledCallbackGauge:
        return LabeledCallbackGauge(
            f"{self.namespace}_{subsystem}_{name}", label, fn, help_, self
        )

    def callback_histogram(
        self, subsystem: str, name: str, fn, help_: str = ""
    ) -> CallbackHistogram:
        return CallbackHistogram(
            f"{self.namespace}_{subsystem}_{name}", fn, help_, self
        )

    def labeled_callback_histogram(
        self, subsystem: str, name: str, label: str, fn, help_: str = ""
    ) -> LabeledCallbackHistogram:
        return LabeledCallbackHistogram(
            f"{self.namespace}_{subsystem}_{name}", label, fn, help_, self
        )

    def expose(self) -> str:
        """Prometheus text format v0.0.4."""
        lines = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


class NodeMetrics:
    """The node's metric groups (reference: per-package Metrics structs —
    internal/consensus/metrics.go, mempool/metrics.go, p2p/metrics.go)."""

    def __init__(self, namespace: str = "cometbft"):
        self.registry = Registry(namespace)
        r = self.registry
        # consensus (reference: internal/consensus/metrics.go)
        self.height = r.gauge("consensus", "height", "Current height")
        self.rounds = r.gauge("consensus", "rounds", "Round of the current height")
        self.validators = r.gauge("consensus", "validators", "Validator count")
        self.validators_power = r.gauge(
            "consensus", "validators_power", "Total voting power"
        )
        self.num_txs = r.gauge("consensus", "num_txs", "Txs in the latest block")
        self.block_interval = r.histogram(
            "consensus",
            "block_interval_seconds",
            "Time between blocks",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
        )
        self.block_size = r.gauge(
            "consensus", "block_size_bytes", "Latest block size"
        )
        # mempool (reference: mempool/metrics.go) + tx-ingestion pipeline
        # (docs/tx-ingest.md).  txingest/stats is torch-free by design, so
        # these callback reads are always scrape-safe.
        self.mempool_size = r.gauge("mempool", "size", "Txs in the mempool")
        self.mempool_size_bytes = r.gauge(
            "mempool", "size_bytes", "Total bytes of txs in the mempool"
        )

        def _ingest(key):
            def read():
                from cometbft_tpu_torch.txingest import stats as istats

                return istats.snapshot()[key]

            return read

        self.mempool_cache_hits = r.callback_counter(
            "mempool", "cache_hits", _ingest("cache_hits"),
            "Tx LRU cache hits at admission (gossip duplicates)",
        )
        self.mempool_cache_misses = r.callback_counter(
            "mempool", "cache_misses", _ingest("cache_misses"),
            "Tx LRU cache misses at admission",
        )
        self.mempool_ingest_queue_depth = r.callback_gauge(
            "mempool", "ingest_queue_depth", _ingest("queue_depth"),
            "Gossiped txs waiting in the ingest coalescer queue",
        )
        self.mempool_ingest_batch_occupancy = r.callback_gauge(
            "mempool", "ingest_batch_occupancy", _ingest("batch_occupancy"),
            "Tx fraction of ingest batch capacity across flushes (0-1)",
        )
        self.mempool_ingest_shed_to_sync = r.callback_counter(
            "mempool", "ingest_shed_to_sync", _ingest("shed_to_sync"),
            "Txs that found the ingest queue full and degraded to the "
            "per-tx synchronous CheckTx path",
        )
        self.mempool_app_batches = r.callback_counter(
            "mempool", "checktx_batches", _ingest("app_batches"),
            "Batched CheckTx round trips (admission + recheck)",
        )
        self.mempool_app_batch_txs = r.callback_counter(
            "mempool", "checktx_batch_txs", _ingest("app_batch_txs"),
            "CheckTx requests carried by batched round trips",
        )
        self.mempool_sig_prechecked = r.callback_counter(
            "mempool", "sig_prechecked", _ingest("sig_prechecked"),
            "Envelope signatures verified node-side before any app "
            "round trip",
        )
        self.mempool_admitted = r.callback_counter(
            "mempool", "admitted_txs", _ingest("admitted"),
            "Txs admitted into the mempool",
        )
        self.mempool_rejected = r.labeled_callback_gauge(
            "mempool", "rejected_txs", "code", _ingest("rejected"),
            "CheckTx rejections by response code (txingest envelope codes "
            "included)",
        )
        self.mempool_errors = r.labeled_callback_gauge(
            "mempool", "admission_errors", "kind", _ingest("errors"),
            "Admission errors by kind (duplicate/full/too_large/pre_check)",
        )
        # p2p (reference: p2p/metrics.go)
        self.peers = r.gauge("p2p", "peers", "Connected peers")

        # verification stream (docs/verify-stream.md): signature-cache
        # efficiency + fused-dispatch occupancy + commit-verify latency.
        # Callback gauges read the process-wide counters at scrape time;
        # the lazy imports keep a scrape from touching the card.
        def _sig(key):
            def read():
                from cometbft_tpu_torch.crypto import sigcache

                return sigcache.get_cache().stats()[key]

            return read

        def _disp(key):
            def read():
                from cometbft_tpu_torch.ops import dispatch_stats

                return dispatch_stats.snapshot()[key]

            return read

        self.sigcache_hits = r.callback_counter(
            "crypto", "sigcache_hits", _sig("hits"),
            "Signature cache hits",
        )
        self.sigcache_misses = r.callback_counter(
            "crypto", "sigcache_misses", _sig("misses"),
            "Signature cache misses",
        )
        self.sigcache_hit_rate = r.callback_gauge(
            "crypto", "sigcache_hit_rate", _sig("hit_rate"),
            "Signature cache hit rate (0-1)",
        )
        self.sigcache_size = r.callback_gauge(
            "crypto", "sigcache_size", _sig("size"),
            "Signature cache entries",
        )
        self.verify_dispatches = r.callback_counter(
            "crypto", "verify_dispatches", _disp("dispatches"),
            "Batched-verify device kernel launches",
        )
        self.verify_fused_batches = r.callback_counter(
            "crypto", "verify_fused_batches", _disp("fused_batches"),
            "Fused multi-commit dispatches",
        )
        self.verify_fused_segments = r.callback_counter(
            "crypto", "verify_fused_segments", _disp("fused_segments"),
            "Commits that rode in fused dispatches",
        )
        self.verify_occupancy = r.callback_gauge(
            "crypto", "verify_batch_occupancy", _disp("occupancy"),
            "Real-signature fraction of bucket-padded lanes (0-1)",
        )
        self.verify_seconds = r.callback_counter(
            "crypto", "verify_commit_seconds_total", _disp("verify_seconds"),
            "Cumulative commit-verification seconds",
        )
        self.verify_calls = r.callback_counter(
            "crypto", "verify_commit_total", _disp("verify_calls"),
            "Commit verifications",
        )
        self.verify_hist = r.callback_histogram(
            "crypto", "verify_commit_seconds", _disp("verify_hist"),
            "Commit verification latency distribution (the paper's <5 ms "
            "10k-validator claim is a p99 over this series)",
        )
        self.dispatch_hist = r.labeled_callback_histogram(
            "crypto", "dispatch_seconds", "shape", _disp("dispatch_hist"),
            "Device dispatch wall time per supervisor-tier-and-padding-"
            "bucket shape",
        )
        self.dispatch_buckets = r.labeled_callback_gauge(
            "crypto", "dispatch_bucket_total", "lanes", _disp("buckets"),
            "Dispatches per padding bucket (the bucket-ladder pruning "
            "evidence)",
        )
        self.shard_dispatch_hist = r.labeled_callback_histogram(
            "crypto", "shard_dispatch_seconds", "device",
            _disp("shard_hist"),
            "Per-device shard fetch wall time on the mesh-sharded verify "
            "path (one sick chip = one outlier series)",
        )
        self.mesh_width = r.callback_gauge(
            "crypto", "mesh_width", _disp("mesh_width"),
            "Devices the elastic mesh's last dispatch targeted (0 = mesh "
            "inactive; a drop below the fleet size means a chip was "
            "excluded — see cometbft_crypto_backend_breaker_state"
            "{backend=mesh_dev*})",
        )
        self.mesh_shrinks = r.callback_counter(
            "crypto", "mesh_shrinks", _disp("mesh_shrinks"),
            "Mesh shrink events (a shard failure or a proactive "
            "probe-down removed a device from membership)",
        )
        self.mesh_restores = r.callback_counter(
            "crypto", "mesh_restores", _disp("mesh_restores"),
            "Devices re-admitted to the mesh by a passing half-open "
            "probe dispatch",
        )
        self.lane_occupancy = r.labeled_callback_gauge(
            "crypto", "lane_occupancy", "lane", _disp("lane_occupancy"),
            "Real-signature fraction of padded lanes per in-flight "
            "pipeline lane (mesh ordinal or supervisor backend; "
            "docs/verify-scheduler.md \"In-flight pipeline\")",
        )
        self.lane_dispatches = r.labeled_callback_gauge(
            "crypto", "lane_dispatches", "lane", _disp("lane_dispatches"),
            "Pipelined dispatches routed per lane",
        )

        # disk-fault supervisor (docs/storage-robustness.md): per-surface
        # durable-IO counters from the diskguard seam.  libs/storage_stats
        # is torch-free by design, so these reads are always scrape-safe.
        def _storage(key):
            def read():
                from cometbft_tpu_torch.libs import storage_stats

                return storage_stats.per_surface(key)

            return read

        self.storage_writes = r.labeled_callback_gauge(
            "storage", "writes_total", "surface", _storage("writes"),
            "Guarded durable write/replace/batch operations per surface",
        )
        self.storage_fsyncs = r.labeled_callback_gauge(
            "storage", "fsyncs_total", "surface", _storage("fsyncs"),
            "Guarded fsync/flush operations per surface",
        )
        self.storage_retries = r.labeled_callback_gauge(
            "storage", "retries_total", "surface", _storage("retries"),
            "Degradable-surface retry attempts after transient IO errors",
        )
        self.storage_drops = r.labeled_callback_gauge(
            "storage", "drops_total", "surface", _storage("drops"),
            "Degradable-surface operations abandoned after the retry "
            "budget (counted drops — consensus untouched)",
        )
        self.storage_repairs = r.labeled_callback_gauge(
            "storage", "repairs_total", "surface", _storage("repairs"),
            "Boot-time crash-consistency repairs (WAL corrupt-tail "
            "truncations)",
        )

        def _storage_fatal():
            from cometbft_tpu_torch.libs import storage_stats

            return 1 if storage_stats.snapshot()["totals"]["fatal"] else 0

        self.storage_fatal = r.callback_gauge(
            "storage", "fatal", _storage_fatal,
            "1 when a fail-stop surface (wal/privval/state) hit an IO "
            "failure — the node halted rather than risk equivocation",
        )

        # flight recorder (docs/observability.md): span volume + anomaly
        # counts.  libs/tracing is torch-free by design.
        def _trace(key):
            def read():
                from cometbft_tpu_torch.libs import tracing

                return tracing.get_tracer().snapshot()[key]

            return read

        self.trace_spans = r.callback_counter(
            "trace", "spans_total", _trace("spans_recorded"),
            "Spans recorded by the verify-pipeline flight recorder",
        )
        self.trace_dropped = r.callback_counter(
            "trace", "spans_dropped_total", _trace("spans_dropped"),
            "Spans that pushed an older span out of the bounded ring",
        )
        self.trace_anomalies = r.labeled_callback_gauge(
            "trace", "anomalies", "kind", _trace("anomalies"),
            "Flight-recorder anomalies by kind (watchdog_fire, "
            "breaker_open, queue_shed, ingest_shed, quarantine, "
            "exec_cache_stale)",
        )
        self.trace_dumps = r.callback_counter(
            "trace", "dumps_total", _trace("dump_count"),
            "Anomaly dump files written to COMETBFT_TPU_TRACE_DIR",
        )

        # the card's availability (ops/device_health): probe results folded
        # from a watcher's status file — an outage becomes one gauge flip.
        # torch-free by design.
        def _device(key):
            def read():
                from cometbft_tpu_torch.ops import device_health

                return device_health.snapshot()[key]

            return read

        self.device_up = r.callback_gauge(
            "device", "up", _device("up_code"),
            "Accelerator availability from the last probe "
            "(1 up, 0 down, -1 never probed)",
        )
        self.device_transitions = r.callback_counter(
            "device", "transitions", _device("transitions"),
            "Chip availability flips (up->down / down->up) observed",
        )

        # backend supervisor (docs/backend-supervisor.md): circuit-breaker
        # state and degradation counters.  backend_health is jax-free by
        # design, so these reads are always scrape-safe.
        def _health(key):
            def read():
                from cometbft_tpu_torch.crypto import backend_health

                return backend_health.snapshot()[key]

            return read

        def _breaker_states():
            from cometbft_tpu_torch.crypto import backend_health

            return backend_health.registry().breaker_states()

        self.backend_breaker_state = r.labeled_callback_gauge(
            "crypto", "backend_breaker_state", "backend", _breaker_states,
            "Per-backend circuit breaker state (0=closed 1=half-open 2=open)",
        )
        self.backend_demotions = r.callback_counter(
            "crypto", "backend_demotions", _health("demotions"),
            "Verify batches that fell through to a lower backend tier",
        )
        self.backend_repromotions = r.callback_counter(
            "crypto", "backend_repromotions", _health("repromotions"),
            "Half-open probes that passed and restored a backend",
        )
        self.backend_watchdog_fires = r.callback_counter(
            "crypto", "backend_watchdog_fires", _health("watchdog_fires"),
            "Device dispatches abandoned past the watchdog deadline",
        )
        self.backend_fallback_signatures = r.callback_counter(
            "crypto", "backend_fallback_verifies", _health("fallback_signatures"),
            "Signatures verified on the host reference due to degradation",
        )
        self.backend_quarantined = r.callback_counter(
            "crypto", "backend_quarantined_inputs", _health("quarantined"),
            "Poisoned inputs isolated by batch bisection",
        )
        self.backend_open_breakers = r.callback_gauge(
            "crypto", "backend_open_breakers", _health("open_breakers"),
            "Backends currently demoted (breaker open)",
        )

        # warm-boot / AOT executable cache (docs/warm-boot.md): how much
        # compile tax the node paid vs amortized.  ops/warm_stats is
        # torch-free by design, so these reads are always scrape-safe.
        def _warm(key):
            def read():
                from cometbft_tpu_torch.ops import warm_stats

                return warm_stats.snapshot()[key]

            return read

        self.warmboot_compiles = r.callback_counter(
            "crypto", "warmboot_compiles", _warm("compiles"),
            "Kernel libraries built by nvcc (misses of the build cache)",
        )
        self.warmboot_compile_seconds = r.callback_counter(
            "crypto", "warmboot_compile_seconds_total",
            _warm("compile_seconds"),
            "Cumulative seconds spent tracing/compiling kernels",
        )
        self.warmboot_exec_hits = r.callback_counter(
            "crypto", "warmboot_exec_cache_hits", _warm("exec_hits"),
            "Executables deserialized from the on-disk cache (no tracing, "
            "no compilation)",
        )
        self.warmboot_exec_load_seconds = r.callback_counter(
            "crypto", "warmboot_exec_load_seconds_total",
            _warm("exec_load_seconds"),
            "Cumulative seconds spent loading cached executables",
        )
        self.warmboot_exec_misses = r.callback_counter(
            "crypto", "warmboot_exec_cache_misses", _warm("exec_misses"),
            "Executable cache probes that found nothing",
        )
        self.warmboot_exec_stale = r.callback_counter(
            "crypto", "warmboot_exec_cache_stale", _warm("exec_stale"),
            "Cache entries rejected as corrupt/truncated/wrong-format",
        )
        self.warmboot_exec_writes = r.callback_counter(
            "crypto", "warmboot_exec_cache_writes", _warm("exec_writes"),
            "Executables persisted to the on-disk cache",
        )
        self.warmboot_exec_evicted = r.callback_counter(
            "crypto", "warmboot_exec_cache_evicted", _warm("exec_evicted"),
            "Stale-fingerprint entries removed by the cache-dir bound",
        )
        self.warmboot_runs = r.callback_counter(
            "crypto", "warmboot_runs", _warm("warm_runs"),
            "Warm-boot passes over the bucket x backend matrix",
        )
        self.warmboot_seconds = r.callback_counter(
            "crypto", "warmboot_seconds_total", _warm("warm_seconds"),
            "Cumulative warm-boot pass wall seconds",
        )
        self.warmboot_shapes_warmed = r.callback_counter(
            "crypto", "warmboot_shapes_warmed", _warm("shapes_warmed"),
            "Bucket x backend shapes resolved by warm-boot passes",
        )
        self.warmboot_shapes_pruned = r.callback_counter(
            "crypto", "warmboot_shapes_pruned", _warm("shapes_pruned"),
            "Shapes the collapsed bucket matrix no longer compiles",
        )
        self.warmboot_failures = r.callback_counter(
            "crypto", "warmboot_failures", _warm("warm_failures"),
            "Warm-boot compile failures (tier demoted via its breaker)",
        )

        # verification scheduler (docs/verify-scheduler.md): queue health,
        # flush triggers, coalescing quality and submit->verdict latency.
        # verifysched/stats is torch-free by design, so these reads are
        # always scrape-safe.
        def _sched(key):
            def read():
                from cometbft_tpu_torch.verifysched import stats as sstats

                return sstats.snapshot()[key]

            return read

        self.sched_queue_depth = r.callback_gauge(
            "sched", "queue_depth", _sched("queue_depth"),
            "Verification requests currently queued",
        )
        self.sched_submitted = r.labeled_callback_gauge(
            "sched", "submitted", "class", _sched("submitted"),
            "Verification requests admitted, per priority class",
        )
        self.sched_shed = r.labeled_callback_gauge(
            "sched", "shed", "class", _sched("shed"),
            "Requests shed by admission control, per priority class "
            "(consensus is exempt by design)",
        )
        self.sched_flushes = r.labeled_callback_gauge(
            "sched", "flushes", "reason", _sched("flushes"),
            "Dispatcher flushes by trigger (deadline/full/shutdown)",
        )
        self.sched_flush_occupancy = r.callback_gauge(
            "sched", "flush_occupancy", _sched("flush_occupancy"),
            "Unique-miss fraction of padded lanes across flushes (0-1)",
        )
        self.sched_dedup_hits = r.callback_counter(
            "sched", "dedup_hits", _sched("dedup_hits"),
            "Duplicate in-flight triples collapsed into one lane",
        )
        self.sched_verdicts = r.callback_counter(
            "sched", "verdicts", _sched("verdicts_total"),
            "Futures resolved by the scheduler",
        )
        self.sched_latency_seconds = r.callback_counter(
            "sched", "latency_seconds_total", _sched("latency_seconds_total"),
            "Cumulative submit->verdict latency seconds",
        )
        # hot-path latency HISTOGRAMS (docs/observability.md): real
        # distributions per priority class, not just cumulative sums —
        # p50/p99 submit->verdict is the paper's actual latency claim
        self.sched_latency_hist = r.labeled_callback_histogram(
            "sched", "latency_seconds", "class", _sched("latency_hist"),
            "Submit->verdict latency per priority class (includes shed "
            "fallbacks, so shedding cannot hide from the record)",
        )
        self.sched_queue_wait_hist = r.labeled_callback_histogram(
            "sched", "queue_wait_seconds", "class", _sched("queue_wait_hist"),
            "Submit->drain queue wait per priority class (recorded "
            "separately from device time)",
        )
        self.sched_device_hist = r.labeled_callback_histogram(
            "sched", "device_seconds", "class", _sched("device_hist"),
            "Drain->verdict (flush execution) share per priority class",
        )
        self.sched_flush_interval_hist = r.callback_histogram(
            "sched", "flush_interval_seconds", _sched("flush_interval_hist"),
            "Time between consecutive dispatcher flush starts",
        )
        self.sched_shed_fallback = r.labeled_callback_gauge(
            "sched", "shed_fallback", "class", _sched("shed_fallback"),
            "Sync fallback verifies recorded after an admission shed",
        )
        self.sched_inflight_depth = r.callback_gauge(
            "sched", "inflight_depth", _sched("inflight_depth"),
            "Flushes currently dispatched but not yet fetched by the "
            "completion pool (docs/verify-scheduler.md \"In-flight "
            "pipeline\"; bounded by COMETBFT_TPU_SCHED_INFLIGHT)",
        )
        self.sched_inflight_hwm = r.callback_gauge(
            "sched", "inflight_hwm", _sched("inflight_hwm"),
            "In-flight flush depth high-water mark since reset",
        )

        # Merkle/hash plane + proof server (docs/proof-serving.md):
        # coalescing quality, cache efficiency and device tree-pass
        # health.  proofserve/stats is torch-free by design, so these
        # reads are always scrape-safe.
        def _mkl(key):
            def read():
                from cometbft_tpu_torch.proofserve import stats as pstats

                return pstats.snapshot()[key]

            return read

        self.merkle_queries = r.labeled_callback_gauge(
            "merkle", "proof_queries", "kind", _mkl("queries"),
            "Proof queries admitted to the coalescer, per kind",
        )
        self.merkle_cache_hits = r.labeled_callback_gauge(
            "merkle", "proof_cache_hits", "kind", _mkl("cache_hits"),
            "Queries answered from the LRU root/proof cache, per kind",
        )
        self.merkle_cache_hit_rate = r.callback_gauge(
            "merkle", "proof_cache_hit_rate", _mkl("proof_cache_hit_rate"),
            "LRU hit fraction across cache lookups (0-1)",
        )
        self.merkle_shed = r.labeled_callback_gauge(
            "merkle", "proof_shed", "kind", _mkl("shed"),
            "Proof queries shed by admission control (serial fallback "
            "answers them — shed costs coalescing, never the response)",
        )
        self.merkle_serial_fallbacks = r.callback_counter(
            "merkle", "serial_fallbacks", _mkl("serial_fallbacks"),
            "Queries answered by the caller's serial build after a "
            "shed/timeout",
        )
        self.merkle_queue_depth = r.callback_gauge(
            "merkle", "queue_depth", _mkl("queue_depth"),
            "Proof queries currently queued",
        )
        self.merkle_flushes = r.labeled_callback_gauge(
            "merkle", "flushes", "reason", _mkl("flushes"),
            "Proof dispatcher flushes by trigger (deadline/full/shutdown)",
        )
        self.merkle_queries_per_flush = r.callback_gauge(
            "merkle", "queries_per_flush", _mkl("queries_per_flush"),
            "Mean queries coalesced per dispatcher flush",
        )
        self.merkle_tree_builds = r.labeled_callback_gauge(
            "merkle", "tree_builds", "kind", _mkl("tree_builds"),
            "Root/proof-set builds (one per coalesced group miss — the "
            "dispatches-per-1k-proofs numerator)",
        )
        self.merkle_trees_device = r.callback_counter(
            "merkle", "trees_device", _mkl("trees_device"),
            "Whole-tree passes on the device kernel / runner seam",
        )
        self.merkle_trees_host = r.callback_counter(
            "merkle", "trees_host", _mkl("trees_host"),
            "Whole-tree passes on the serial host oracle",
        )
        self.merkle_lanes_occupancy = r.callback_gauge(
            "merkle", "lanes_occupancy", _mkl("lanes_occupancy"),
            "Leaf fraction of bucket-padded device lanes (0-1)",
        )
        self.merkle_device_fallbacks = r.callback_counter(
            "merkle", "device_fallbacks", _mkl("device_fallbacks"),
            "Device tree passes degraded to the host oracle (breaker "
            "recorded the failure; the root is never wrong, only slower)",
        )
        self.merkle_oversize_host = r.callback_counter(
            "merkle", "oversize_host", _mkl("oversize_host"),
            "Trees sent straight to the host (leaf or lane budget "
            "exceeded the kernel's bucket ladder)",
        )

        # encrypted transport data plane (docs/transport-plane.md):
        # frame coalescing quality, AEAD tier health and handshake-pool
        # admission.  p2p/transport_stats is torch-free by design.
        def _tps(key):
            def read():
                from cometbft_tpu_torch.p2p import transport_stats as tpstats

                return tpstats.snapshot()[key]

            return read

        self.transport_frames = r.labeled_callback_gauge(
            "transport", "frames", "path", _tps("frames"),
            "AEAD frames by route: batched (coalesced plane pass) vs "
            "serial (below min batch or plane disabled)",
        )
        self.transport_batches = r.labeled_callback_gauge(
            "transport", "batches", "op", _tps("batches"),
            "Coalesced transport-plane calls by op (seal/open)",
        )
        self.transport_dispatches = r.labeled_callback_gauge(
            "transport", "aead_dispatches", "tier", _tps("dispatches"),
            "AEAD passes by execution tier (device/numpy/pure — the "
            "dispatches-per-1k-frames numerator counts every tier)",
        )
        self.transport_frames_per_batch = r.callback_gauge(
            "transport", "frames_per_batch", _tps("frames_per_batch"),
            "Mean frames coalesced per transport-plane call",
        )
        self.transport_aead_lanes_occupancy = r.callback_gauge(
            "transport", "aead_lanes_occupancy",
            _tps("aead_lanes_occupancy"),
            "Frame fraction of bucket-padded device AEAD lanes (0-1)",
        )
        self.transport_device_fallbacks = r.callback_counter(
            "transport", "aead_device_fallbacks", _tps("device_fallbacks"),
            "Device AEAD passes degraded to a host tier (breaker recorded "
            "the failure; the tier below re-encrypts/re-verifies — never "
            "a wrong byte or verdict)",
        )
        self.transport_bad_tags = r.callback_counter(
            "transport", "bad_tags", _tps("bad_tags"),
            "Frames that failed authentication (REAL rejects, confirmed "
            "on the pure reference tier)",
        )
        self.transport_reject_confirms = r.callback_counter(
            "transport", "reject_confirms", _tps("reject_confirms"),
            "Device-tier tag mismatches re-verified on the reference "
            "tier before the verdict was allowed out",
        )
        self.transport_handshakes = r.labeled_callback_gauge(
            "transport", "handshakes", "path", _tps("handshakes"),
            "X25519 exchanges by route: pool (coalesced ladder) vs sync "
            "(direct host fallback)",
        )
        self.transport_hs_shed = r.callback_counter(
            "transport", "handshake_shed", _tps("hs_shed"),
            "Pool submissions shed by admission control or timeout (the "
            "sync dial answers them — never a dropped connection)",
        )
        self.transport_hs_flushes = r.labeled_callback_gauge(
            "transport", "handshake_flushes", "reason", _tps("hs_flushes"),
            "Handshake-pool dispatcher flushes by trigger "
            "(deadline/full/shutdown)",
        )
        self.transport_hs_per_flush = r.callback_gauge(
            "transport", "handshakes_per_flush",
            _tps("handshakes_per_flush"),
            "Mean exchanges coalesced per pool flush",
        )
        self.transport_hs_queue_depth = r.callback_gauge(
            "transport", "handshake_queue_depth", _tps("hs_queue_depth"),
            "Exchanges currently queued in the handshake pool",
        )
        self.transport_hs_lanes_occupancy = r.callback_gauge(
            "transport", "handshake_lanes_occupancy",
            _tps("hs_lanes_occupancy"),
            "Exchange fraction of bucket-padded device ladder lanes (0-1)",
        )

        # blocksync catchup plane (docs/sim-design.md "WAN-grade
        # blocksync"): adaptive request scheduling health — RTT-scaled
        # timeouts, exponential peer bans, half-open re-admission probes
        # and frontier stall switches.  blocksync/stats is torch-free.
        def _bsy(key):
            def read():
                from cometbft_tpu_torch.blocksync import stats as bstats

                return bstats.snapshot()[key]

            return read

        self.blocksync_requests = r.callback_counter(
            "blocksync", "requests", _bsy("requests"),
            "Block requests sent to peers (probes included)",
        )
        self.blocksync_send_failures = r.callback_counter(
            "blocksync", "send_failures", _bsy("send_failures"),
            "Requests whose send failed at the transport and were "
            "unwound for reassignment",
        )
        self.blocksync_timeouts = r.callback_counter(
            "blocksync", "timeouts", _bsy("timeouts"),
            "Requests expired by the per-peer adaptive (RTT-EWMA) or "
            "fixed timeout and reassigned",
        )
        self.blocksync_bans = r.callback_counter(
            "blocksync", "bans", _bsy("bans"),
            "Peer bans (exponential backoff per repeat offender)",
        )
        self.blocksync_probes = r.callback_counter(
            "blocksync", "probes", _bsy("probes"),
            "Half-open re-admission probes sent to banned peers (one "
            "request wide)",
        )
        self.blocksync_probe_passes = r.callback_counter(
            "blocksync", "probe_passes", _bsy("probe_passes"),
            "Probes answered with a block — the peer is re-admitted and "
            "its ban backoff reset",
        )
        self.blocksync_redos = r.callback_counter(
            "blocksync", "redos", _bsy("redos"),
            "Frontier heights re-requested after an invalid block "
            "(the serving peer is banned)",
        )
        self.blocksync_no_blocks = r.callback_counter(
            "blocksync", "no_blocks", _bsy("no_blocks"),
            "Peers that answered a request with no-block",
        )
        self.blocksync_stall_switches = r.callback_counter(
            "blocksync", "stall_switches", _bsy("stall_switches"),
            "Frontier requests re-assigned to the fastest advertising "
            "peer after a no-progress stall window",
        )
        self.blocksync_blocks_received = r.callback_counter(
            "blocksync", "blocks_received", _bsy("blocks_received"),
            "Block responses accepted into the pool",
        )
        self.blocksync_heights_synced = r.callback_counter(
            "blocksync", "heights_synced", _bsy("heights_synced"),
            "Heights verified and applied via catchup",
        )
        self.blocksync_window_depth = r.callback_gauge(
            "blocksync", "window_depth", _bsy("window_depth"),
            "Outstanding requests in the sliding window",
        )
        self.blocksync_peers = r.callback_gauge(
            "blocksync", "peers", _bsy("peers"),
            "Peers known to the block pool",
        )
        self.blocksync_heights_per_second = r.callback_gauge(
            "blocksync", "heights_per_second", _bsy("heights_per_second"),
            "Catchup rate over the sync so far (heights/s on the pool's "
            "clock — virtual in the sim)",
        )

        # evidence pool: ingest outcomes and pending-pool occupancy, so a
        # duplicate-vote flood shows up as dedup/dropped counters instead
        # of silent memory growth.  evidence/stats is torch-free by design.
        def _evd(key):
            def read():
                from cometbft_tpu_torch.evidence import stats as evstats

                return evstats.snapshot()[key]

            return read

        self.evidence_pool_depth = r.callback_gauge(
            "evidence", "pool_depth", _evd("pool_depth"),
            "Pending evidence entries in the pool",
        )
        self.evidence_pool_bytes = r.callback_gauge(
            "evidence", "pool_bytes", _evd("pool_bytes"),
            "Pending evidence bytes in the pool",
        )
        self.evidence_added = r.callback_counter(
            "evidence", "added", _evd("added"),
            "Evidence verified and admitted to the pending pool",
        )
        self.evidence_dedup = r.callback_counter(
            "evidence", "dedup", _evd("dedup"),
            "Ingest attempts dropped as already pending/committed",
        )
        self.evidence_dropped = r.callback_counter(
            "evidence", "dropped", _evd("dropped"),
            "Verified evidence dropped by the pool size bound",
        )
        self.evidence_rejected = r.callback_counter(
            "evidence", "rejected", _evd("rejected"),
            "Evidence that failed verification at ingest",
        )
        self.evidence_committed = r.callback_counter(
            "evidence", "committed", _evd("committed"),
            "Evidence included in committed blocks",
        )
        self.evidence_pruned = r.callback_counter(
            "evidence", "pruned", _evd("pruned"),
            "Pending evidence expired by the age bound",
        )


class MetricsServer:
    """Serves /metrics (reference: startPrometheusServer, node/node.go:597)."""

    def __init__(self, registry: Registry, laddr: str):
        import http.server
        import socketserver

        host, _, port = laddr.replace("tcp://", "").rpartition(":")
        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = reg.expose().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._httpd = Server((host or "0.0.0.0", int(port)), Handler)
        self.bound_port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
