"""Blocksync block pool: parallel block download from many peers.

Reference: internal/blocksync/pool.go:72 BlockPool — a sliding window of
in-flight height requests assigned to peers that advertise the height,
with per-request timeouts, peer banning on bad blocks, and a two-block
verification frontier (``peek_two_blocks``): block H is verified with the
LastCommit carried by block H+1.

Beyond the reference, the pool is deterministic-fault-envelope clean
(docs/sim-design.md): the clock and rng are injected seams (the sim pins
both; production defaults to ``time.monotonic``/a private ``Random``), and
scheduling is WAN-aware:

  * **adaptive per-peer timeouts** — each peer keeps an RTT EWMA from its
    answered requests; a request to that peer expires after
    ``clamp(ewma * MULT, FLOOR, CAP)`` instead of one flat constant, so a
    slow-but-honest intercontinental peer is no longer indistinguishable
    from a dead one.
  * **exponential ban backoff + half-open probes** — a timed-out request
    alone is re-assigned, not punished (WAN loss is normal weather); a
    peer is banned only after ``BAN_STRIKES`` consecutive timeout scans
    with nothing served, on a bad block, or on a failed probe.  Bans
    double ``BAN_BASE * 2^n`` up to ``BAN_CAP``; when a ban expires, the
    peer is *half-open* (the ``backend_health`` one-bucket idiom): it
    gets exactly one in-flight probe request.  A served block re-admits
    it at full window share; a timed-out probe re-bans it at the next
    backoff level.  A still-bad peer costs one probe, never a window
    stall.
  * **stall-switch** — when the frontier height makes no progress for
    ``STALL_SECS``, its request is force-moved to the fastest advertising
    peer (lowest EWMA) so one wedged assignee cannot freeze catchup.

``COMETBFT_TPU_BSYNC_ADAPTIVE=0`` kills all three and restores the fixed
15 s timeout / flat ban scheduling bit-for-bit.

The port departs from the JAX package in one place (ROADMAP §3): with
adaptive scheduling on, a peer that is delivering restarts the clocks of
its pending requests, both when a block lands and when bytes of one
arrive (the ``progress`` seam: the bytes received from the peer on the
blocksync channel), as the reference resets a peer's timer on each block
and judges a peer by its receive rate.  In the JAX package each
request's clock runs from its send alone: a ~3.7 MiB block at the
default 5,120,000 B/s takes 0.73 s at best, so a joiner whose process
moves it at under ~1.9 MB/s times its requests out at the 2 s floor while
they stream, re-requests (the server queues each block again), bans its
only peer, sends each half-open probe behind that queue, and never
syncs.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.blocksync import stats as bstats
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs import sync as libsync

REQUEST_WINDOW = 40  # max heights in flight (reference: maxPendingRequests=600, scaled down)
REQUEST_TIMEOUT = 15.0  # reassign a request after this long (pre-EWMA / kill switch)
PEER_PENDING_CAP = 20  # max in-flight requests per (fully admitted) peer

# Adaptive-scheduling defaults (all overridable via env, read per pool):
_TIMEOUT_MULT = 4.0  # adaptive timeout = clamp(ewma * mult, floor, cap)
_TIMEOUT_FLOOR = 2.0
_TIMEOUT_CAP = 30.0
_BAN_BASE = 5.0  # first ban; doubles per consecutive ban up to the cap
_BAN_CAP = 60.0
_BAN_STRIKES = 3  # consecutive timeout scans with nothing served -> ban
_STALL_SECS = 10.0  # frontier quiet this long -> switch to fastest peer
_EWMA_ALPHA = 0.3


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


@dataclass
class PoolConfig:
    """Scheduling knobs, snapshotted from the environment at pool
    construction (scenarios override via extra_env before the joiner's
    pool exists)."""

    adaptive: bool = True
    timeout_mult: float = _TIMEOUT_MULT
    timeout_floor: float = _TIMEOUT_FLOOR
    timeout_cap: float = _TIMEOUT_CAP
    ban_base: float = _BAN_BASE
    ban_cap: float = _BAN_CAP
    ban_strikes: int = _BAN_STRIKES
    stall_secs: float = _STALL_SECS

    @classmethod
    def from_env(cls) -> "PoolConfig":
        return cls(
            adaptive=os.environ.get("COMETBFT_TPU_BSYNC_ADAPTIVE", "1") != "0",
            timeout_mult=_env_f("COMETBFT_TPU_BSYNC_TIMEOUT_MULT", _TIMEOUT_MULT),
            timeout_floor=_env_f("COMETBFT_TPU_BSYNC_TIMEOUT_FLOOR", _TIMEOUT_FLOOR),
            timeout_cap=_env_f("COMETBFT_TPU_BSYNC_TIMEOUT_CAP", _TIMEOUT_CAP),
            ban_base=_env_f("COMETBFT_TPU_BSYNC_BAN_BASE", _BAN_BASE),
            ban_cap=_env_f("COMETBFT_TPU_BSYNC_BAN_CAP", _BAN_CAP),
            ban_strikes=int(
                _env_f("COMETBFT_TPU_BSYNC_BAN_STRIKES", _BAN_STRIKES)
            ),
            stall_secs=_env_f("COMETBFT_TPU_BSYNC_STALL_SECS", _STALL_SECS),
        )


@dataclass
class _PeerData:
    peer_id: str
    base: int = 0
    height: int = 0  # highest block the peer claims
    num_pending: int = 0
    banned_until: float = 0.0
    # adaptive scheduling state:
    rtt_ewma: Optional[float] = None  # None until the first answered request
    ban_count: int = 0  # consecutive bans (backoff exponent); 0 = admitted
    probe_inflight: bool = False  # half-open: the one probe is out
    timeout_strikes: int = 0  # consecutive timeout scans with nothing served


@dataclass
class _Request:
    height: int
    peer_id: str
    sent_at: float
    block: Optional[object] = None  # types.Block once received
    ext_commit: Optional[object] = None  # types.ExtendedCommit when served
    probe: bool = False  # this request is a half-open re-admission probe


class BlockPool:
    """Reference: pool.go BlockPool."""

    def __init__(
        self,
        start_height: int,
        send_request: Callable[[str, int], bool],
        logger: Optional[liblog.Logger] = None,
        clock: Optional[Callable[[], float]] = None,
        rng: Optional[random.Random] = None,
        config: Optional[PoolConfig] = None,
        progress: Optional[Callable[[str], Optional[int]]] = None,
    ):
        self.height = start_height  # next height to pop
        self.send_request = send_request
        self.logger = logger or liblog.nop_logger()
        # Injected seams: the sim pins both to its virtual clock / seeded
        # rng; production gets wall monotonic time and a private Random —
        # never the process-global ``random`` module, whose state any
        # library call can perturb.
        self._clock = clock if clock is not None else time.monotonic
        self._rng = rng if rng is not None else random.Random()
        # bytes received so far from a peer on the blocksync channel (None
        # when unknown); more than at the last scan means a block is
        # arriving (adaptive scheduling only)
        self._progress = progress
        self._progress_marks: dict[str, int] = {}  # peer -> bytes at the last scan
        self.config = config if config is not None else PoolConfig.from_env()
        self._lock = libsync.rlock("blocksync.pool")
        self.peers: dict[str, _PeerData] = {}
        self.requests: dict[int, _Request] = {}
        self.ever_had_peers = False
        self._started_at = self._clock()
        # stall-switch bookkeeping: last frontier height + when it moved
        self._progress_h = start_height
        self._progress_t = self._started_at

    # -- peers -------------------------------------------------------------

    def set_peer_range(
        self,
        peer_id: str,
        base: int,
        height: int,
        rtt: Optional[float] = None,
    ) -> None:
        """Reference: pool.go SetPeerRange (from StatusResponse).  When the
        reactor measured the status round trip, it seeds the RTT EWMA of a
        peer that has not served a block yet — otherwise that peer's first
        dropped response sits on the flat legacy REQUEST_TIMEOUT."""
        with self._lock:
            pd = self.peers.get(peer_id)
            if pd is None:
                pd = _PeerData(peer_id)
                self.peers[peer_id] = pd
            self.ever_had_peers = True
            pd.base = base
            pd.height = max(pd.height, height)
            if rtt is not None and rtt > 0.0 and pd.rtt_ewma is None:
                pd.rtt_ewma = rtt

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self.peers.pop(peer_id, None)
            self._progress_marks.pop(peer_id, None)
            for h, req in list(self.requests.items()):
                if req.peer_id == peer_id and req.block is None:
                    del self.requests[h]  # will be re-requested

    def ban_peer(self, peer_id: str, duration: Optional[float] = None) -> None:
        """Reference: peer banning on bad blocks / timeouts
        (pool.go:153,431).  Adaptive mode ignores ``duration`` and applies
        exponential backoff: ``BAN_BASE * 2^bans`` capped at ``BAN_CAP``;
        the legacy path keeps the caller-supplied flat duration."""
        with self._lock:
            pd = self.peers.get(peer_id)
            if pd is None:
                return
            now = self._clock()
            if self.config.adaptive:
                if pd.banned_until > now:
                    # already banned: cached bad blocks surfacing while
                    # the ban runs are the same incident — escalation
                    # needs post-ban evidence (a failed probe or a fresh
                    # offence after re-admission)
                    return
                dur = min(
                    self.config.ban_base * (2.0 ** pd.ban_count),
                    self.config.ban_cap,
                )
                pd.ban_count += 1
                pd.probe_inflight = False
            else:
                dur = 60.0 if duration is None else duration
            pd.banned_until = now + dur
            pd.timeout_strikes = 0
            bstats.record_ban()
            self.logger.info(
                "blocksync peer banned",
                peer=peer_id,
                duration=dur,
                bans=pd.ban_count,
            )

    def max_peer_height(self) -> int:
        with self._lock:
            return max((p.height for p in self.peers.values()), default=0)

    # -- blocks ------------------------------------------------------------

    def add_block(self, peer_id: str, block, ext_commit=None) -> bool:
        """Reference: pool.go:296 AddBlock — only accepted if this peer owns
        the outstanding request for that height.  ``ext_commit`` rides
        along when the serving peer stored one (vote extensions)."""
        height = block.header.height
        with self._lock:
            req = self.requests.get(height)
            if req is None or req.peer_id != peer_id or req.block is not None:
                return False
            req.block = block
            req.ext_commit = ext_commit
            pd = self.peers.get(peer_id)
            if pd is not None:
                pd.num_pending = max(pd.num_pending - 1, 0)
                pd.timeout_strikes = 0  # it IS serving, just lossy/slow
                rtt = max(self._clock() - req.sent_at, 0.0)
                pd.rtt_ewma = (
                    rtt
                    if pd.rtt_ewma is None
                    else _EWMA_ALPHA * rtt + (1.0 - _EWMA_ALPHA) * pd.rtt_ewma
                )
                if req.probe and pd.probe_inflight:
                    # half-open probe answered: full re-admission.  (A bad
                    # block still takes the redo path afterwards, which
                    # re-bans the peer — a fresh incident, fresh backoff.)
                    pd.probe_inflight = False
                    pd.ban_count = 0
                    bstats.record_probe_pass()
                    self.logger.info(
                        "blocksync probe passed, peer re-admitted",
                        peer=peer_id,
                        height=height,
                    )
                if self.config.adaptive:
                    # the peer is serving: the clocks of its other pending
                    # requests restart now, so a queue of large blocks
                    # served one after another is progress, not a string
                    # of timeouts, and each later answer's RTT is its own
                    # service time (reference: pool.go, a peer's timer
                    # reset in decrPending on every block it delivers)
                    now = self._clock()
                    for other in self.requests.values():
                        if other.peer_id == peer_id and other.block is None:
                            other.sent_at = now
            bstats.record_block_received()
            return True

    def no_block(self, peer_id: str, height: int) -> None:
        """Peer explicitly has no such block: re-request elsewhere."""
        with self._lock:
            req = self.requests.get(height)
            if req is not None and req.peer_id == peer_id and req.block is None:
                del self.requests[height]
                pd = self.peers.get(peer_id)
                if pd is not None:
                    pd.num_pending = max(pd.num_pending - 1, 0)
                    if req.probe:
                        # an honest "don't have it" is not a failed probe:
                        # stay half-open, the next pass may probe again
                        pd.probe_inflight = False
                bstats.record_no_block()

    def peek_two_blocks(self):
        """Reference: pool.go:218 PeekTwoBlocks — (first, second) or Nones."""
        with self._lock:
            first = self.requests.get(self.height)
            second = self.requests.get(self.height + 1)
            return (
                first.block if first else None,
                second.block if second else None,
                first.peer_id if first else "",
                second.peer_id if second else "",
                first.ext_commit if first else None,
            )

    def peek_window(self, k: int):
        """The consecutive run of received blocks at the frontier, up to
        ``k`` heights past it: [(height, block, peer_id, ext_commit), ...]
        starting at ``self.height``, stopping at the first gap.  Feeds the
        reactor's fused verification prefetch — block H's commit rides in
        block H+1, so a window of n blocks lets n-1 commits be verified in
        one device dispatch instead of n-1."""
        with self._lock:
            out = []
            for h in range(self.height, self.height + max(k, 0) + 1):
                req = self.requests.get(h)
                if req is None or req.block is None:
                    break
                out.append((h, req.block, req.peer_id, req.ext_commit))
            return out

    def pop_request(self) -> None:
        """First block verified + applied: advance the frontier."""
        with self._lock:
            self.requests.pop(self.height, None)
            bstats.record_height_synced(self.height, self._clock())
            self.height += 1

    def redo_request(self, height: int) -> str:
        """Bad block at ``height``: drop the block, ban the sender
        (reference: pool.go RedoRequest)."""
        with self._lock:
            req = self.requests.pop(height, None)
            if req is None:
                return ""
            bstats.record_redo()
            self.ban_peer(req.peer_id)
            return req.peer_id

    # -- request scheduling ------------------------------------------------

    def _peer_timeout(self, pd: Optional[_PeerData]) -> float:
        """Per-peer adaptive request timeout; the flat constant before any
        RTT sample exists or when adaptivity is off."""
        if (
            not self.config.adaptive
            or pd is None
            or pd.rtt_ewma is None
        ):
            return REQUEST_TIMEOUT
        return min(
            max(pd.rtt_ewma * self.config.timeout_mult, self.config.timeout_floor),
            self.config.timeout_cap,
        )

    def _peer_cap(self, pd: _PeerData) -> int:
        """Window share: full cap when admitted, one probe when half-open,
        zero while the probe is still out."""
        if not self.config.adaptive or pd.ban_count == 0:
            return PEER_PENDING_CAP
        return 0 if pd.probe_inflight else 1

    def _assign(self, pd: _PeerData, h: int, now: float, to_send: list) -> None:
        """Create the request entry under the lock; the actual send happens
        after release (see make_next_requests)."""
        probe = self.config.adaptive and pd.ban_count > 0
        self.requests[h] = _Request(h, pd.peer_id, now, probe=probe)
        pd.num_pending += 1
        if probe:
            pd.probe_inflight = True
            bstats.record_probe()
            self.logger.info(
                "blocksync half-open probe", peer=pd.peer_id, height=h
            )
        to_send.append((pd.peer_id, h))

    def _check_stall(self, now: float, to_send: list) -> None:
        """Frontier quiet for STALL_SECS with its request outstanding:
        force-move it to the fastest advertising peer (lowest EWMA)."""
        if self.height != self._progress_h:
            self._progress_h = self.height
            self._progress_t = now
            return
        if now - self._progress_t <= self.config.stall_secs:
            return
        self._progress_t = now  # rate-limit switches to one per window
        req = self.requests.get(self.height)
        if req is None or req.block is not None:
            return
        fastest = None
        for p in self.peers.values():
            if (
                p.peer_id == req.peer_id
                or not (p.banned_until <= now)
                or not (p.base <= self.height <= p.height)
                or p.num_pending >= self._peer_cap(p)
            ):
                continue
            key = (
                p.rtt_ewma if p.rtt_ewma is not None else float("inf"),
                p.peer_id,
            )
            if fastest is None or key < fastest[0]:
                fastest = (key, p)
        if fastest is None:
            return
        old = self.peers.get(req.peer_id)
        if old is not None:
            old.num_pending = max(old.num_pending - 1, 0)
            if req.probe:
                old.probe_inflight = False
        del self.requests[self.height]
        bstats.record_stall_switch()
        self.logger.info(
            "blocksync stall: frontier switched",
            height=self.height,
            slow=req.peer_id,
            fast=fastest[1].peer_id,
        )
        self._assign(fastest[1], self.height, now, to_send)

    def make_next_requests(self) -> None:
        """Fill the sliding window [height, height+WINDOW) with requests
        (reference: makeRequestersRoutine, pool.go:116).  Requests are
        recorded under the lock but SENT after it is released — try_send
        may call back into reactor/switch locks, and holding the pool lock
        across that is a latent lock inversion."""
        to_send: list[tuple[str, int]] = []
        now = self._clock()
        marks = {}
        if self._progress is not None and self.config.adaptive:
            # read outside the lock: the seam may take the switch's
            marks = {pid: self._progress(pid) for pid in list(self.peers)}
        with self._lock:
            for peer_id, mark in marks.items():
                pd = self.peers.get(peer_id)
                if pd is None or mark is None:
                    continue
                last = self._progress_marks.get(peer_id)
                if last is not None and mark > last:
                    # bytes of a block arrived since the last scan: the
                    # peer is serving, its pending requests' clocks restart
                    pd.timeout_strikes = 0
                    for req in self.requests.values():
                        if req.peer_id == peer_id and req.block is None:
                            req.sent_at = now
                self._progress_marks[peer_id] = mark
            max_h = self.max_peer_height()
            wanted = [
                h
                for h in range(self.height, min(self.height + REQUEST_WINDOW, max_h + 1))
                if h not in self.requests
            ]
            # expire timed-out requests (per-peer adaptive timeout); a
            # burst of losses expires many requests in one scan, but the
            # incident is at most ONE strike/ban — punishing per request
            # would escalate a single loss burst straight to the cap
            expired_peers: set = set()
            probe_expired: set = set()
            for h, req in list(self.requests.items()):
                pd = self.peers.get(req.peer_id)
                if req.block is None and now - req.sent_at > self._peer_timeout(pd):
                    bstats.record_timeout()
                    if pd is not None:
                        pd.num_pending = max(pd.num_pending - 1, 0)
                    if req.probe:
                        probe_expired.add(req.peer_id)
                    expired_peers.add(req.peer_id)
                    del self.requests[h]
                    if h not in wanted:
                        wanted.append(h)
            for peer_id in sorted(expired_peers):
                pd = self.peers.get(peer_id)
                if not self.config.adaptive:
                    self.ban_peer(peer_id, 30.0)
                    continue
                if peer_id in probe_expired:
                    # a timed-out half-open probe is the failed
                    # re-admission test: re-ban at the next backoff level
                    self.ban_peer(peer_id, 30.0)
                    continue
                if pd is None or pd.banned_until > now:
                    # escalation needs post-ban evidence — leftover
                    # in-flight requests expiring after the ban landed
                    # are the same incident
                    continue
                # ordinary loss re-assigns without punishment; only a
                # peer that times out BAN_STRIKES scans in a row without
                # serving anything (a mute/stalled peer, not a lossy
                # link) earns a ban
                pd.timeout_strikes += 1
                if pd.timeout_strikes >= self.config.ban_strikes:
                    self.ban_peer(peer_id, 30.0)
            if self.config.adaptive:
                self._check_stall(now, to_send)
            candidates = [
                p
                for p in self.peers.values()
                if p.banned_until <= now
            ]
            if self.config.adaptive:
                # deliberate half-open probes first: every ban-expired
                # peer gets its one probe at the HIGHEST wanted height it
                # can serve — the re-admission test runs promptly, and a
                # still-bad peer never holds the frontier hostage
                for pd in sorted(
                    (
                        p
                        for p in candidates
                        if p.ban_count > 0 and not p.probe_inflight
                    ),
                    key=lambda p: p.peer_id,
                ):
                    for h in sorted(wanted, reverse=True):
                        if pd.base <= h <= pd.height:
                            self._assign(pd, h, now, to_send)
                            wanted.remove(h)
                            break
            for h in sorted(wanted):
                peers = [
                    p
                    for p in candidates
                    if p.base <= h <= p.height
                    and p.num_pending < self._peer_cap(p)
                ]
                if not peers:
                    continue
                pd = self._rng.choice(peers)
                self._assign(pd, h, now, to_send)
            bstats.record_gauges(len(self.requests), len(self.peers))
        # send OUTSIDE the lock; unwind entries whose send failed
        failed: list[int] = []
        for peer_id, h in to_send:
            bstats.record_request()
            if not self.send_request(peer_id, h):
                failed.append(h)
        if failed:
            with self._lock:
                for h in failed:
                    req = self.requests.get(h)
                    if req is None or req.block is not None:
                        continue  # answered or reassigned meanwhile
                    del self.requests[h]
                    bstats.record_send_failure()
                    pd = self.peers.get(req.peer_id)
                    if pd is not None:
                        pd.num_pending = max(pd.num_pending - 1, 0)
                        if req.probe:
                            pd.probe_inflight = False

    # -- progress ----------------------------------------------------------

    def is_caught_up(self) -> bool:
        """Reference: pool.go IsCaughtUp — at (or past) the best peer
        height, with at least one peer heard from."""
        with self._lock:
            if not self.peers:
                return False
            return self.height >= self.max_peer_height()
