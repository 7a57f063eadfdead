"""Verify-pipeline flight recorder: span tracing + anomaly forensics.

The paper's headline claim is a LATENCY claim (<5 ms for a 10k-validator
commit), but counters can only say that something was slow on average —
not WHICH dispatch, at WHAT shape, on WHICH supervisor tier.  This module
is the torch-free tracing half of the observability layer
(docs/observability.md): a thread-safe span tracer over a bounded
in-memory ring buffer (the *flight recorder*), threaded through the whole
verify journey — txingest admission → sigcache probe → verifysched
submit/queue-wait/flush → ``ops/verify`` bucket dispatch → supervisor tier
(watchdog fires, degradations, bisect quarantines) → verdict resolution —
plus the consensus/blocksync/light spans above it.

Span model: ``(trace_id, span_id, parent_id, stage, t_start, t_end,
attrs)``.  Trace propagation is ambient (a thread-local stack): a span
opened while another is live becomes its child and inherits its trace id,
so a commit verification's device dispatches attribute to the commit
without any API threading.  The clock is injectable (``set_clock``) so
the deterministic simulator traces on its VirtualClock and two same-seed
runs produce byte-identical span streams.

Stage taxonomy (dotted, coarse on the hot path — one span per batch or
per dispatch, never per signature):

  * ``txingest.flush`` / ``txingest.shed_sync``  — batched tx admission
  * ``sched.flush`` / ``sched.shed_fallback``    — verify scheduler
  * ``verify.commit``                            — commit verification
    (consensus apply, blocksync frontier, light client)
  * ``verify.batch`` / ``verify.dispatch``       — bucket dispatch (the
    dispatch span carries bucket lanes + tier + dispatch seq: the triple
    an anomaly dump attributes a watchdog fire to)
  * ``supervisor.host_fallback`` / ``supervisor.bisect``
  * ``consensus.vote`` / ``consensus.proposal`` / ``consensus.vote_ext``
    (per height-round)
  * ``blocksync.prefetch`` / ``light.chain``     — speculative windows
  * ``warmboot.shape`` / ``warmboot.run``        — warm-boot progress

Anomaly forensics: ``record_anomaly(kind, **attrs)`` counts every anomaly
(watchdog_fire, breaker_open, queue_shed, ingest_shed, quarantine,
exec_cache_stale) and — on the FIRST occurrence of each kind since the
last reset (``COMETBFT_TPU_TRACE_DUMP_ALL=1`` dumps every occurrence) —
writes the last ``COMETBFT_TPU_TRACE_DUMP_SPANS`` (256) spans as JSONL to
``COMETBFT_TPU_TRACE_DIR`` for postmortem.  The dump's first line names
the anomaly and its attributes; dump bytes are a pure function of the
span stream, so a sim scenario's dump replays byte-identically per seed.

Kill switch: ``COMETBFT_TPU_TRACE=0`` compiles spans down to no-ops (a
shared null context manager; one env read per span site).

Cross-node correlation (docs/observability.md "Cross-node tracing"): a
``TraceContext`` is the compact (trace_id, span_id, origin-node) triple a
gossip envelope carries so consensus-round spans on different nodes form
ONE causal tree per (height, round) — the proposer's ``consensus.round``
span is the root, every receiver's round span adopts its trace id, and a
commit's verify spans on node B link back to the proposal that originated
on node A through nothing but the shared trace id.  Event-driven stages
that outlive any ``with`` block (a consensus round spans many receive-loop
events) use the explicit ``begin``/``finish`` API; ``under`` temporarily
makes such an unfinished span the ambient parent so the verify pipeline
underneath it inherits the round's trace.  ``COMETBFT_TPU_TRACE_XNODE=0``
turns off context propagation (spans still record, per-node only).
``rounds_report`` merges the ring into per-(height, round) timelines —
tolerant of orphan parents (a crashed proposer's root span never records;
the group still renders with ``origin=None``) and of ring-bound drops.

Deliberately free of torch and of every CUDA call, like
``ops/dispatch_stats``: the ``/metrics`` scrape, the
``/debug/verify_trace`` RPC and the ``cmd trace`` CLI all read this
module, and none of them may be the thing that initializes (or waits on)
the card.  A span never synchronizes a stream or queries an event: a
kernel launch is asynchronous, and the span around it records the
enqueue, as the in-flight seam keeps two batches on the verify stream.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

logger = logging.getLogger("cometbft_tpu_torch.tracing")

DEFAULT_RING = 4096
DEFAULT_DUMP_SPANS = 256
# anomaly kinds with a dump trigger (docs/observability.md).  Breaker
# opens are per-taxonomy-kind: the ed25519 device tiers share
# "breaker_open", while the single-tier secp256k1/BLS breakers get their
# own kinds — each kind's FIRST open dumps, so an ed25519 brownout can no
# longer eat the one dump a simultaneous secp_device failure deserved.
ANOMALY_KINDS = (
    "watchdog_fire",
    "breaker_open",
    "breaker_open_secp_device",
    "breaker_open_bls_g1",
    "queue_shed",
    "ingest_shed",
    "quarantine",
    # the XLA executable cache's stale-entry kind: the port builds its
    # kernels with nvcc into ops/_build's cache, which has no stale state,
    # so nothing in the port records it; kept so both packages share one
    # taxonomy (and one dump-kind order)
    "exec_cache_stale",
    # elastic mesh supervision: a shard abandoned past the watchdog, a
    # device removed from mesh membership, and a device re-admitted by a
    # passing half-open probe (parallel/elastic).
    "shard_watchdog_fire",
    "mesh_shrink",
    "mesh_restore",
)


def enabled() -> bool:
    """``COMETBFT_TPU_TRACE=0`` is the kill switch; default on.  One dict
    lookup — the only cost a disabled span site pays besides the null
    context manager."""
    return os.environ.get("COMETBFT_TPU_TRACE", "1") != "0"


# -- durable sinks (libs/blackbox.py) -----------------------------------------
#
# The black-box journal subscribes here; with no sink installed (the
# default, and always under COMETBFT_TPU_BLACKBOX=0) every hook is a
# single None check — the RAM-only recorder is bit-for-bit unchanged.
#   span(sp)              — every COMPLETED span, as it lands in the ring
#   open(sp)              — every explicit begin() span (round anchors)
#   anomaly(kind, attrs, t) — EVERY anomaly occurrence (the RAM dump
#                           latch stays first-per-kind; the journal does not)
#   event(kind, attrs)    — low-rate journal-only events (breaker
#                           transitions, quorum arrivals, device probes)

_SINKS: dict = {"span": None, "open": None, "anomaly": None, "event": None}


def set_sink(kind: str, fn):
    """Install (or, with None, remove) a durable sink; returns the sink
    it replaced so callers can restore it.  Sink errors are swallowed at
    the call sites — forensics must never become a second failure."""
    prev = _SINKS[kind]
    _SINKS[kind] = fn
    return prev


def get_sink(kind: str):
    return _SINKS[kind]


def note_event(kind: str, **attrs) -> None:
    """Journal-only event: recorded by the black box when one is
    installed, invisible to the RAM ring.  For low-rate state transitions
    (breaker close, device probe flips, quorum arrivals on the in-flight
    round) whose loss at crash time would blind a postmortem."""
    fn = _SINKS["event"]
    if fn is None:
        return
    try:
        fn(kind, attrs)
    except Exception:  # noqa: BLE001
        pass


def trace_dir() -> Optional[str]:
    return os.environ.get("COMETBFT_TPU_TRACE_DIR") or None


def xnode_enabled() -> bool:
    """Whether gossip envelopes carry trace contexts
    (``COMETBFT_TPU_TRACE_XNODE=0`` disables propagation while keeping
    per-node spans).  Implies the recorder itself being on."""
    return (
        enabled()
        and os.environ.get("COMETBFT_TPU_TRACE_XNODE", "1") != "0"
    )


class TraceContext:
    """The compact trace context a gossip envelope propagates: the
    sender's round-trace id, the span to parent under, and the origin
    node.  Encodes to a short ASCII token so any transport (sim fabric
    today, a p2p envelope field tomorrow) can carry it opaquely."""

    __slots__ = ("trace_id", "span_id", "origin")

    def __init__(self, trace_id: int, span_id: int, origin=None):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)
        self.origin = origin

    def encode(self) -> str:
        o = "" if self.origin is None else str(int(self.origin))
        return f"{self.trace_id:x}.{self.span_id:x}.{o}"

    @classmethod
    def decode(cls, token) -> "Optional[TraceContext]":
        """Tolerant decode: garbage, truncation or a foreign format yield
        None (a malformed context must never fail message handling)."""
        if isinstance(token, TraceContext):
            return token
        if not isinstance(token, str):
            return None
        parts = token.split(".")
        if len(parts) != 3:
            return None
        try:
            trace_id = int(parts[0], 16)
            span_id = int(parts[1], 16)
            origin = int(parts[2]) if parts[2] else None
        except ValueError:
            return None
        if trace_id <= 0 or span_id <= 0:
            return None
        return cls(trace_id, span_id, origin)

    def __repr__(self) -> str:  # debugging/trace logs
        return f"TraceContext({self.encode()!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.origin == other.origin
        )


class Span:
    """One recorded stage interval.  ``attrs`` values must be
    JSON-serializable (dump files are byte-compared across sim runs)."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "stage", "t_start", "t_end",
        "attrs",
    )

    def __init__(self, trace_id, span_id, parent_id, stage, t_start, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.stage = stage
        self.t_start = t_start
        self.t_end = None
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (e.g. the outcome, known at exit)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return (self.t_end or self.t_start) - self.t_start

    def to_dict(self) -> dict:
        # fixed rounding so float formatting can never vary a dump byte
        d = {
            "trace": self.trace_id,
            "span": self.span_id,
            "stage": self.stage,
            "t0": round(self.t_start, 9),
            "t1": round(self.t_end, 9) if self.t_end is not None else None,
            "dur_ms": (
                round((self.t_end - self.t_start) * 1e3, 6)
                if self.t_end is not None
                else None
            ),
        }
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullSpan:
    """The disabled-tracer span: a shared, allocation-free no-op that
    still satisfies the ``with tracer.span(...) as sp: sp.set(...)``
    calling convention."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: "Tracer", sp: Span):
        self.tracer = tracer
        self.sp = sp

    def __enter__(self) -> Span:
        stack = self.tracer._stack()
        stack.append(self.sp)
        return self.sp

    def __exit__(self, etype, evalue, tb) -> bool:
        sp = self.sp
        sp.t_end = self.tracer._clock()
        if etype is not None:
            sp.attrs.setdefault("error", etype.__name__)
        stack = self.tracer._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # mis-nested exit (exception unwound past us)
            stack.remove(sp)
        self.tracer._append(sp)
        return False


class _UnderCtx:
    """Pushes an unfinished explicit span as the ambient parent for the
    duration of a block; pops by identity so nested/rotated anchors can
    never unbalance the stack."""

    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: "Tracer", sp: Span):
        self.tracer = tracer
        self.sp = sp

    def __enter__(self) -> Span:
        self.tracer._stack().append(self.sp)
        return self.sp

    def __exit__(self, *exc) -> bool:
        stack = self.tracer._stack()
        if stack and stack[-1] is self.sp:
            stack.pop()
        elif self.sp in stack:
            stack.remove(self.sp)
        return False

    def set(self, **attrs):  # parity with _NullSpan for disabled callers
        self.sp.set(**attrs)
        return self


class Tracer:
    """Bounded flight recorder; all methods are thread-safe.

    Spans land in the ring ON COMPLETION (the append is the caller
    thread's, so a worker abandoned by the dispatch watchdog never races
    a span into a deterministic sim's record)."""

    def __init__(
        self,
        ring_size: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if ring_size is None:
            try:
                ring_size = int(
                    os.environ.get("COMETBFT_TPU_TRACE_RING", "")
                    or DEFAULT_RING
                )
            except ValueError:
                ring_size = DEFAULT_RING
        self._lock = threading.Lock()
        self._ring: "deque[Span]" = deque(maxlen=max(int(ring_size), 16))
        self._clock: Callable[[], float] = clock or time.perf_counter
        self._tls = threading.local()
        self._next_id = 1
        self._recorded = 0
        self._dropped = 0
        self._anomalies: dict = {}
        self._dumped_kinds: set = set()
        self._dump_seq = 0
        self._dumps: "list[str]" = []
        self._overhead_s = 0.0
        # process-LIFETIME aggregates: reset() (sim per-run hygiene) does
        # not clear these, so the tier1-trace summary line still reports
        # the whole test run's span volume and recorder overhead
        self._life_recorded = 0
        self._life_dropped = 0
        self._life_anomalies = 0
        self._life_dumps = 0
        self._life_overhead_s = 0.0

    # -- span API ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, stage: str, **attrs):
        """Context manager recording one stage interval.  Nested spans
        (same thread) become children; the root span's id is the trace id.
        Disabled tracer → the shared no-op span."""
        if not enabled():
            return _NULL_SPAN
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(
            trace_id=parent.trace_id if parent is not None else sid,
            span_id=sid,
            parent_id=parent.span_id if parent is not None else None,
            stage=stage,
            t_start=self._clock(),
            attrs=attrs,
        )
        return _SpanCtx(self, sp)

    def current_trace(self) -> Optional[int]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1].trace_id if stack else None

    def time(self) -> float:
        """The tracer's clock (virtual in sim).  Event-driven callers use
        it for retroactive ``record_span`` timestamps so span times always
        share one time base with the rest of the ring."""
        return self._clock()

    # -- explicit span API (event-driven stages) ---------------------------
    #
    # A consensus round outlives any single receive-loop event, so no
    # ``with`` block can bracket it: ``begin`` allocates an UNFINISHED span
    # (id + start time), the state machine mutates/adopts it across events,
    # and ``finish`` stamps the end time and lands it in the ring — still
    # on completion, still from the owning thread.

    def begin(
        self,
        stage: str,
        parent: Optional[Span] = None,
        ctx: Optional[TraceContext] = None,
        **attrs,
    ) -> Optional[Span]:
        """Allocate an unfinished span.  ``parent`` (a local span) or
        ``ctx`` (a remote trace context) seed the trace; with neither the
        span is a trace root.  Returns None when tracing is disabled —
        every other explicit-API call accepts None as a no-op."""
        if not enabled():
            return None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
            if ctx.origin is not None:
                attrs.setdefault("xnode", ctx.origin)
        else:
            trace_id, parent_id = sid, None
        sp = Span(trace_id, sid, parent_id, stage, self._clock(), attrs)
        sink = _SINKS["open"]
        if sink is not None:
            # the journal's OPEN record: an explicit span (a consensus
            # round anchor) exists from this moment, so a crash before
            # finish() still leaves the in-flight round reconstructable
            try:
                sink(sp)
            except Exception:  # noqa: BLE001
                pass
        return sp

    def finish(self, sp: Optional[Span], **attrs) -> None:
        """Stamp the end time and record an explicit span.  Idempotent on
        an already-finished span; None is a no-op."""
        if sp is None or sp.t_end is not None:
            return
        if attrs:
            sp.attrs.update(attrs)
        sp.t_end = self._clock()
        self._append(sp)

    def adopt(self, sp: Optional[Span], ctx: Optional[TraceContext]) -> bool:
        """Re-parent a still-rootless unfinished span under a remote
        context — how a receiver's ``consensus.round`` span joins the
        originating proposal's trace.  No-op (False) once the span has a
        parent or has finished: first adoption wins."""
        if (
            sp is None
            or ctx is None
            or sp.parent_id is not None
            or sp.t_end is not None
        ):
            return False
        sp.trace_id = ctx.trace_id
        sp.parent_id = ctx.span_id
        if ctx.origin is not None:
            sp.attrs.setdefault("xnode", ctx.origin)
        return True

    def record_span(
        self,
        stage: str,
        t_start: float,
        t_end: float,
        parent: Optional[Span] = None,
        **attrs,
    ) -> Optional[Span]:
        """Manufacture a COMPLETED span with explicit timestamps (taken
        from ``time()``) — retroactive step timing: the consensus state
        machine only knows a step's duration once the next step begins."""
        if not enabled():
            return None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = sid, None
        sp = Span(trace_id, sid, parent_id, stage, t_start, attrs)
        sp.t_end = t_end
        self._append(sp)
        return sp

    def under(self, sp: Optional[Span]):
        """Context manager making an UNFINISHED explicit span the ambient
        parent, so ``span()`` sites underneath (verify.commit, dispatches)
        inherit its trace — the linkage that lets a commit's verify spans
        resolve to the originating proposal.  ``under(None)`` is a shared
        no-op."""
        if sp is None or not enabled():
            return _NULL_SPAN
        return _UnderCtx(self, sp)

    def ctx_for(self, sp: Optional[Span], origin=None) -> Optional[TraceContext]:
        """A propagatable context pointing at an explicit span."""
        if sp is None:
            return None
        return TraceContext(sp.trace_id, sp.span_id, origin)

    def _append(self, sp: Span) -> None:
        t0 = time.perf_counter()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                self._life_dropped += 1
            self._ring.append(sp)
            self._recorded += 1
            self._life_recorded += 1
            # exit-path cost only (the enter path is of the same order):
            # an approximate but honestly *measured* recorder overhead the
            # tier1-trace summary line reports as a share of wall time
            dt = time.perf_counter() - t0
            self._overhead_s += dt
            self._life_overhead_s += dt
        sink = _SINKS["span"]
        if sink is not None:
            # outside the ring lock: the journal enqueue has its own lock
            # and never blocks on IO (bounded queue, counted drops)
            try:
                sink(sp)
            except Exception:  # noqa: BLE001
                pass

    # -- anomaly forensics -------------------------------------------------

    def record_anomaly(self, kind: str, **attrs) -> Optional[str]:
        """Count an anomaly; dump the ring tail as JSONL on the first
        occurrence of ``kind`` since the last reset (all occurrences with
        ``COMETBFT_TPU_TRACE_DUMP_ALL=1``).  Returns the dump path, or
        None when no dump was written.  Never raises — forensics must not
        become a second failure."""
        dump_all = os.environ.get("COMETBFT_TPU_TRACE_DUMP_ALL") == "1"
        sink = _SINKS["anomaly"]
        if sink is not None:
            # the durable journal records EVERY occurrence (and fsyncs);
            # the RAM dump below stays latched first-per-kind
            try:
                sink(kind, attrs, self._clock())
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._anomalies[kind] = self._anomalies.get(kind, 0) + 1
            self._life_anomalies += 1
            want_dump = (
                enabled()
                and trace_dir() is not None
                and (dump_all or kind not in self._dumped_kinds)
            )
            if not want_dump:
                return None
            self._dumped_kinds.add(kind)
            self._dump_seq += 1
            seq = self._dump_seq
            tail = self._dump_tail_locked()
            now = self._clock()
        try:
            return self._write_dump(kind, seq, now, attrs, tail)
        except Exception as e:  # noqa: BLE001 — forensics is best-effort
            logger.warning("flight-recorder dump failed: %r", e)
            return None

    def _dump_tail_locked(self) -> "list[Span]":
        try:
            n = int(
                os.environ.get("COMETBFT_TPU_TRACE_DUMP_SPANS", "")
                or DEFAULT_DUMP_SPANS
            )
        except ValueError:
            n = DEFAULT_DUMP_SPANS
        ring = list(self._ring)
        return ring[-n:] if n > 0 else ring

    def _write_dump(self, kind, seq, now, attrs, tail) -> str:
        d = trace_dir()
        os.makedirs(d, exist_ok=True)
        name = f"trace-{seq:03d}-{kind}.jsonl"
        path = os.path.join(d, name)
        lines = [
            json.dumps(
                {
                    "anomaly": kind,
                    "seq": seq,
                    "t": round(now, 9),
                    "attrs": attrs,
                    "spans": len(tail),
                },
                sort_keys=True,
            )
        ]
        lines.extend(json.dumps(sp.to_dict(), sort_keys=True) for sp in tail)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with self._lock:
            self._dumps.append(name)
            del self._dumps[:-32]  # keep the last 32 names
            self._life_dumps += 1
        logger.warning(
            "flight recorder: anomaly %s -> dumped %d spans to %s",
            kind,
            len(tail),
            path,
        )
        return path

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled(),
                "ring_size": self._ring.maxlen,
                "ring_len": len(self._ring),
                "spans_recorded": self._recorded,
                "spans_dropped": self._dropped,
                "anomalies": dict(self._anomalies),
                "anomalies_total": sum(self._anomalies.values()),
                "dumps": list(self._dumps),
                "dump_count": self._dump_seq,
                "overhead_seconds": self._overhead_s,
                "lifetime": {
                    "spans_recorded": self._life_recorded,
                    "spans_dropped": self._life_dropped,
                    "anomalies": self._life_anomalies,
                    "dumps": self._life_dumps,
                    "overhead_seconds": self._life_overhead_s,
                },
            }

    def tail(self, n: int = DEFAULT_DUMP_SPANS) -> "list[dict]":
        with self._lock:
            ring = list(self._ring)
        return [sp.to_dict() for sp in (ring[-n:] if n > 0 else ring)]

    def stage_summary(self) -> dict:
        """Per-stage count / total / p50 / p99 over the spans currently in
        the ring (bounded by the ring, so the percentiles describe the
        recent window — exactly what a regression hunt wants)."""
        with self._lock:
            ring = list(self._ring)
        by_stage: dict = {}
        for sp in ring:
            if sp.t_end is None:
                continue
            by_stage.setdefault(sp.stage, []).append(sp.t_end - sp.t_start)
        out = {}
        for stage, durs in sorted(by_stage.items()):
            durs.sort()
            n = len(durs)
            out[stage] = {
                "count": n,
                "total_ms": round(sum(durs) * 1e3, 3),
                "p50_ms": round(durs[n // 2] * 1e3, 3),
                "p99_ms": round(durs[min(n - 1, (n * 99) // 100)] * 1e3, 3),
                "max_ms": round(durs[-1] * 1e3, 3),
            }
        return out

    def rounds_report(self, last_k: Optional[int] = None) -> dict:
        """Merged cross-node round timelines over the spans currently in
        the ring: one group per (height, round), carrying every node's
        ``consensus.round`` span (duration, committed flag, quorum-arrival
        times, per-step durations) plus the count of ``verify.commit``
        spans that link to the group's trace — the proof that a commit's
        verification attributes to the proposal that originated it.

        Orphan tolerance by construction: a group whose root span never
        recorded (crashed proposer, ring-bound drop) still renders, with
        ``origin=None``; a step or commit span whose parent fell off the
        ring still aggregates by its own (h, r)/trace attrs.  The report
        is a pure function of the span stream, so two same-seed sim runs
        serialize byte-identically (sort_keys JSON)."""
        with self._lock:
            ring = list(self._ring)
        groups: dict = {}  # (h, r) -> group dict
        step_agg: dict = {}  # step name -> [durations]
        quorum_agg: dict = {"prevote_ms": [], "precommit_ms": []}
        commit_traces: dict = {}  # trace_id -> verify.commit span count
        commits_total = 0
        commits_standalone = 0

        def group(h, r) -> dict:
            g = groups.get((h, r))
            if g is None:
                g = groups[(h, r)] = {
                    "h": h,
                    "r": r,
                    "trace": None,
                    "origin": None,
                    "nodes": {},
                    "traces": set(),
                }
            return g

        def node_entry(g, node) -> dict:
            e = g["nodes"].get(node)
            if e is None:
                e = g["nodes"][node] = {"node": node, "steps": {}}
            return e

        for sp in ring:
            if sp.t_end is None:
                continue
            a = sp.attrs
            if sp.stage == "consensus.round":
                g = group(a.get("h"), a.get("r"))
                g["traces"].add(sp.trace_id)
                e = node_entry(g, a.get("node"))
                e["dur_ms"] = round(sp.duration * 1e3, 6)
                e["committed"] = bool(a.get("committed"))
                e["adopted"] = sp.parent_id is not None
                for k, agg in (
                    ("q_prevote_ms", "prevote_ms"),
                    ("q_precommit_ms", "precommit_ms"),
                ):
                    if k in a:
                        e[k] = a[k]
                        quorum_agg[agg].append(a[k])
                if sp.parent_id is None and a.get("proposer"):
                    # the trace root: the PROPOSER's round span.  A merely
                    # rootless span (a node that never adopted — partition,
                    # or propagation off) must not claim the round's origin
                    g["trace"] = sp.trace_id
                    g["origin"] = a.get("node")
            elif sp.stage == "consensus.step":
                g = group(a.get("h"), a.get("r"))
                e = node_entry(g, a.get("node"))
                dur = round(sp.duration * 1e3, 6)
                e["steps"][a.get("step", "?")] = dur
                step_agg.setdefault(a.get("step", "?"), []).append(
                    sp.duration
                )
            elif sp.stage == "verify.commit":
                if sp.parent_id is None:
                    # a standalone verification (light client, statesync
                    # trust check, the sim's invariant checker): its own
                    # trace root by construction — not a linkage failure
                    commits_standalone += 1
                    continue
                commits_total += 1
                commit_traces[sp.trace_id] = (
                    commit_traces.get(sp.trace_id, 0) + 1
                )

        all_traces: set = set()
        rounds = []
        for (h, r) in sorted(
            groups, key=lambda k: (k[0] is None, k[0] or 0, k[1] or 0)
        ):
            g = groups[(h, r)]
            all_traces |= g["traces"]
            n_commits = sum(
                commit_traces.get(t, 0) for t in sorted(g["traces"])
            )
            if g["trace"] is None and len(g["traces"]) == 1:
                # orphan root: the trace id is still known from the
                # adopted members, only the proposer's span is missing
                g["trace"] = next(iter(g["traces"]))
            rounds.append(
                {
                    "h": h,
                    "r": r,
                    "trace": g["trace"],
                    "origin": g["origin"],
                    "commits": n_commits,
                    "nodes": [
                        g["nodes"][k]
                        for k in sorted(
                            g["nodes"], key=lambda n: (n is None, n)
                        )
                    ],
                }
            )

        def pctls(durs: list) -> dict:
            if not durs:
                return {"count": 0}
            durs = sorted(durs)
            n = len(durs)
            return {
                "count": n,
                "p50_ms": round(durs[n // 2] * 1e3, 6),
                "p99_ms": round(
                    durs[min(n - 1, (n * 99) // 100)] * 1e3, 6
                ),
                "max_ms": round(durs[-1] * 1e3, 6),
            }

        linked = sum(commit_traces.get(t, 0) for t in all_traces)
        return {
            "rounds_seen": len(rounds),
            "rounds": rounds[-last_k:] if last_k else rounds,
            "steps": {k: pctls(v) for k, v in sorted(step_agg.items())},
            "quorum": {
                # already in ms — scale back for the shared helper
                k: pctls([x / 1e3 for x in v])
                for k, v in sorted(quorum_agg.items())
            },
            "commits_linked": linked,
            "commits_unlinked": commits_total - linked,
            "commits_standalone": commits_standalone,
        }

    # -- lifecycle ---------------------------------------------------------

    def set_clock(self, clock: Optional[Callable[[], float]]) -> None:
        """Swap the time source (the sim pins its VirtualClock here so
        span times are virtual and deterministic); None restores
        ``time.perf_counter``."""
        self._clock = clock or time.perf_counter

    def dump_state(self) -> dict:
        """Snapshot of the anomaly-dump latch (first-per-kind set, dump
        sequence, dump names).  Scenario setup hooks save this so their
        teardown can restore it — composed scenarios' setup/teardown must
        not leak dump-latch state into the run (or each other) any more
        than they leak env knobs."""
        with self._lock:
            return {
                "dumped_kinds": set(self._dumped_kinds),
                "dump_seq": self._dump_seq,
                "dumps": list(self._dumps),
            }

    def restore_dump_state(self, state: dict) -> None:
        with self._lock:
            self._dumped_kinds = set(state.get("dumped_kinds", ()))
            self._dump_seq = int(state.get("dump_seq", 0))
            self._dumps = list(state.get("dumps", ()))

    def reset(self) -> None:
        """Fresh recorder state: empty ring, zeroed counters/ids, dump
        latch cleared.  The sim calls this per scenario run so span ids
        (and therefore dump bytes) are a pure function of the seed."""
        with self._lock:
            self._ring.clear()
            self._next_id = 1
            self._recorded = 0
            self._dropped = 0
            self._anomalies = {}
            self._dumped_kinds = set()
            self._dump_seq = 0
            self._dumps = []
            self._overhead_s = 0.0


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide flight recorder (every pipeline stage writes to
    one ring — cross-stage attribution IS the feature)."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def reset_tracer() -> None:
    """Drop the process-wide tracer (tests/sim; re-reads the ring-size
    env on next use)."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = None


# module-level conveniences — the spelling the pipeline call sites use
def span(stage: str, **attrs):
    return get_tracer().span(stage, **attrs)


def record_anomaly(kind: str, **attrs) -> Optional[str]:
    return get_tracer().record_anomaly(kind, **attrs)


def summary_line() -> str:
    """One parseable line for test logs (scripts/check_tier1_budget.py
    reads the span count and recorder overhead share from it).  Reports
    the process-LIFETIME aggregates: per-run ``reset()`` calls (the sim)
    must not hide the suite's true recorder traffic."""
    life = get_tracer().snapshot()["lifetime"]
    return (
        "tier1-trace: spans=%d dropped=%d anomalies=%d dumps=%d "
        "overhead_s=%.3f"
        % (
            life["spans_recorded"],
            life["spans_dropped"],
            life["anomalies"],
            life["dumps"],
            life["overhead_seconds"],
        )
    )


DEFAULT_ROUND_K = 8


def trace_document(
    max_spans: int = DEFAULT_DUMP_SPANS, rounds: int = DEFAULT_ROUND_K
) -> dict:
    """The one-call forensic snapshot behind the ``/debug/verify_trace``
    RPC and the ``cmd trace`` CLI: ring tail + per-stage latency summary +
    pipeline health (breaker states, cache hit rates, scheduler queue,
    warm-boot progress) as a single JSON-serializable document.

    Every read is lazy, of host counters, and never touches CUDA; a
    section that fails to import reports its error instead of sinking the
    document."""
    tracer = get_tracer()
    doc = {
        "tracing": tracer.snapshot(),
        "stages": tracer.stage_summary(),
        # last-K merged consensus-round timelines (cross-node when the
        # fabric propagates contexts); rounds <= 0 skips the section body
        "rounds": tracer.rounds_report(last_k=max(0, int(rounds)) or None)
        if rounds > 0
        else {},
        # max_spans <= 0 really means "health only, no span payload" —
        # tail()'s 0-means-all convention is for the dump path, not here
        "spans": tracer.tail(max_spans) if max_spans > 0 else [],
    }

    def section(name, fn):
        try:
            doc[name] = fn()
        except Exception as e:  # noqa: BLE001 — one bad section must not
            # sink the whole forensic document
            doc[name] = {"error": repr(e)}

    def _backend():
        from cometbft_tpu_torch.crypto import backend_health

        return backend_health.snapshot()

    def _sigcache():
        from cometbft_tpu_torch.crypto import sigcache

        return sigcache.get_cache().stats()

    def _dispatch():
        from cometbft_tpu_torch.ops import dispatch_stats

        return dispatch_stats.snapshot()

    def _sched():
        from cometbft_tpu_torch.verifysched import stats as sstats

        return sstats.snapshot()

    def _warmboot():
        from cometbft_tpu_torch.ops import warm_stats

        return warm_stats.snapshot()

    def _ingest():
        from cometbft_tpu_torch.txingest import stats as istats

        return istats.snapshot()

    def _device():
        from cometbft_tpu_torch.ops import device_health

        return device_health.snapshot()

    def _blackbox():
        from cometbft_tpu_torch.libs import blackbox

        return blackbox.journal_stats() or {"enabled": blackbox.enabled()}

    def _storage():
        from cometbft_tpu_torch.libs import storage_stats

        return storage_stats.snapshot()

    def _proofserve():
        from cometbft_tpu_torch.proofserve import stats as pstats

        return pstats.snapshot()

    def _blocksync():
        from cometbft_tpu_torch.blocksync import stats as bstats

        return bstats.snapshot()

    section("backend", _backend)
    section("sigcache", _sigcache)
    section("dispatch", _dispatch)
    section("sched", _sched)
    section("warmboot", _warmboot)
    section("ingest", _ingest)
    section("device", _device)
    section("blackbox", _blackbox)
    section("storage", _storage)
    section("proofserve", _proofserve)
    section("blocksync", _blocksync)
    return doc
