"""Evidence pool (reference: internal/evidence/pool.go).

Holds verified-but-uncommitted evidence for proposal inclusion and gossip,
and remembers committed evidence so duplicates are rejected.  Conflicting
votes reported by consensus are buffered and converted to
``DuplicateVoteEvidence`` once the block for that height is finalized, when
the pool has the state to attribute voting powers (reference:
pool.go processConsensusBuffer).

``device`` is where the pool's signature checks run: ``None`` means the
card (a pool built with no card raises, unless
``COMETBFT_TPU_CRYPTO_BACKEND=cpu``), ``"cpu"`` the host.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Optional

from cometbft_tpu_torch.evidence import stats as evstats
from cometbft_tpu_torch.evidence import verify as everify
from cometbft_tpu_torch.evidence.verify import EvidenceInvalidError
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
)
from cometbft_tpu_torch.types.vote import Vote

_PENDING = b"evp/"
_COMMITTED = b"evc/"

# Pending-pool size bounds: a duplicate-vote flood must degrade to drops,
# never to unbounded memory.  The age bound (consensus evidence params) is
# enforced by _prune_expired on every committed block, as before.
DEFAULT_MAX_PENDING = 1024
DEFAULT_MAX_PENDING_BYTES = 2 * 1024 * 1024


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _key(prefix: bytes, height: int, hash_: bytes) -> bytes:
    return prefix + struct.pack(">q", height) + hash_


class EvidencePool:
    """Reference: internal/evidence/pool.go:24 Pool."""

    def __init__(
        self,
        db,
        state_store,
        block_store,
        logger=None,
        max_pending: Optional[int] = None,
        max_pending_bytes: Optional[int] = None,
        device=None,
    ):
        self.device = validation.require_device(device)
        self._db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger or liblog.nop_logger()
        self.max_pending = (
            max_pending
            if max_pending is not None
            else _env_int("COMETBFT_TPU_EVIDENCE_POOL_MAX", DEFAULT_MAX_PENDING)
        )
        self.max_pending_bytes = (
            max_pending_bytes
            if max_pending_bytes is not None
            else _env_int(
                "COMETBFT_TPU_EVIDENCE_POOL_MAX_BYTES",
                DEFAULT_MAX_PENDING_BYTES,
            )
        )
        self._mtx = threading.Lock()
        self.state = state_store.load()
        # pending occupancy, maintained incrementally (seeded by one scan so
        # a restart against a persisted db starts from the truth)
        self._pending_count = 0
        self._pending_bytes = 0
        for _k, raw in self._db.iterate(_PENDING, _PENDING + b"\xff"):
            self._pending_count += 1
            self._pending_bytes += len(raw)
        # consensus-reported vote pairs awaiting state to attribute power
        self._consensus_buffer: list[tuple[Vote, Vote]] = []
        # evidence added since last query, for the gossip reactor
        self.evidence_waiter = threading.Event()

    # -- ingest ------------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """Verify and admit evidence from a peer or RPC (reference:
        pool.go:190 AddEvidence).  Identical evidence dedups before any
        signature work; a verified piece arriving at a full pool is
        DROPPED (counted, logged) rather than growing the pool without
        bound — a flood costs drops, never memory."""
        with self._mtx:
            if self._is_pending(ev) or self._is_committed(ev):
                evstats.record("dedup")
                return  # already have it
            if self.state is None:
                raise EvidenceError("pool has no state yet")
            try:
                everify.verify(
                    ev, self.state, self.state_store, self.block_store,
                    self.device,
                )
            except EvidenceError:
                evstats.record("rejected")
                raise
            self._admit_locked(ev)

    def _admit_locked(self, ev) -> bool:
        """Bound-checked admission of VERIFIED evidence (mtx held): a full
        pool drops (counted, logged) instead of growing without bound."""
        if (
            self._pending_count >= self.max_pending
            or self._pending_bytes >= self.max_pending_bytes
        ):
            evstats.record("dropped")
            self.logger.info(
                "evidence pool full, dropping",
                evidence=str(ev),
                depth=self._pending_count,
            )
            return False
        self._add_pending(ev)
        evstats.record("added")
        self.logger.info("added evidence", evidence=str(ev))
        self.evidence_waiter.set()
        return True

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """Called by consensus on equivocation (reference: pool.go:145
        ReportConflictingVotes) — buffered until the height is committed."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    # -- block-validation hooks (reference: pool.go:248 CheckEvidence) -----

    def check_evidence(self, state, evidence: list) -> None:
        """Verify every piece of evidence in a proposed block; duplicates
        within the block or against committed evidence are invalid."""
        hashes = set()
        for ev in evidence:
            h = ev.hash()
            if h in hashes:
                raise EvidenceInvalidError("duplicate evidence in block")
            hashes.add(h)
            with self._mtx:
                if self._is_committed(ev):
                    raise EvidenceInvalidError("evidence was already committed")
                if not self._is_pending(ev):
                    everify.verify(
                        ev, state, self.state_store, self.block_store,
                        self.device,
                    )

    # -- proposal supply ---------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """Reference: pool.go PendingEvidence — pending evidence up to
        max_bytes, oldest first."""
        out, size = [], 0
        with self._mtx:
            for _k, raw in self._db.iterate(_PENDING, _PENDING + b"\xff"):
                ev = codec.decode_evidence(raw)
                n = len(raw)
                if max_bytes >= 0 and size + n > max_bytes:
                    break
                out.append(ev)
                size += n
        return out, size

    # -- post-commit update (reference: pool.go Update) --------------------

    def update(self, state, block_evidence: list) -> None:
        with self._mtx:
            self.state = state
            for ev in block_evidence:
                self._mark_committed(ev)
            if block_evidence:
                evstats.record("committed", len(block_evidence))
            self._process_consensus_buffer(state)
            self._prune_expired(state)

    def _process_consensus_buffer(self, state) -> None:
        """Convert buffered conflicting votes into evidence (reference:
        pool.go processConsensusBuffer)."""
        buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            vals = self.state_store.load_validators(vote_a.height)
            if vals is None:
                continue
            found = vals.get_by_address(vote_a.validator_address)
            if found is None:
                continue
            _, val = found
            meta = self.block_store.load_block_meta(vote_a.height)
            block_time = meta.header.time if meta else state.last_block_time
            ev = DuplicateVoteEvidence.from_votes(
                vote_a,
                vote_b,
                block_time,
                val.voting_power,
                vals.total_voting_power(),
            )
            if self._is_pending(ev) or self._is_committed(ev):
                continue
            try:
                everify.verify(
                    ev, state, self.state_store, self.block_store, self.device
                )
            except EvidenceError as e:
                self.logger.error(
                    "failed to verify consensus-reported evidence", err=str(e)
                )
                continue
            if self._admit_locked(ev):
                self.logger.info(
                    "equivocation evidence created", evidence=str(ev)
                )

    def _prune_expired(self, state) -> None:
        params = state.consensus_params.evidence
        dels = []
        pruned = 0
        for k, raw in self._db.iterate(_PENDING, _PENDING + b"\xff"):
            height = struct.unpack(">q", k[len(_PENDING) : len(_PENDING) + 8])[0]
            ev = codec.decode_evidence(raw)
            age_blocks = state.last_block_height - height
            age_ns = state.last_block_time.to_ns() - ev.time.to_ns()
            if (
                age_blocks > params.max_age_num_blocks
                and age_ns > params.max_age_duration_ns
            ):
                dels.append(k)
                pruned += 1
                self._pending_count -= 1
                self._pending_bytes -= len(raw)
        # committed markers only record height; once past the height-age
        # window no duplicate can be re-proposed, so the marker can go too
        for k, _raw in self._db.iterate(_COMMITTED, _COMMITTED + b"\xff"):
            height = struct.unpack(">q", k[len(_COMMITTED) : len(_COMMITTED) + 8])[0]
            if state.last_block_height - height > params.max_age_num_blocks:
                dels.append(k)
        for k in dels:
            self._db.delete(k)
        if pruned:
            evstats.record("pruned", pruned)
        self._publish_depth()

    # -- storage helpers ---------------------------------------------------

    def _publish_depth(self) -> None:
        evstats.set_depth(self._pending_count, self._pending_bytes)

    def _add_pending(self, ev) -> None:
        raw = codec.encode_evidence(ev)
        self._db.set(_key(_PENDING, ev.height, ev.hash()), raw)
        self._pending_count += 1
        self._pending_bytes += len(raw)
        self._publish_depth()

    def _is_pending(self, ev) -> bool:
        return self._db.get(_key(_PENDING, ev.height, ev.hash())) is not None

    def _is_committed(self, ev) -> bool:
        return self._db.get(_key(_COMMITTED, ev.height, ev.hash())) is not None

    def _mark_committed(self, ev) -> None:
        self._db.set(_key(_COMMITTED, ev.height, ev.hash()), b"\x01")
        key = _key(_PENDING, ev.height, ev.hash())
        raw = self._db.get(key)
        if raw is not None:
            self._pending_count -= 1
            self._pending_bytes -= len(raw)
            self._db.delete(key)
            self._publish_depth()

    # -- introspection -----------------------------------------------------

    def occupancy(self) -> tuple[int, int]:
        """(pending entries, pending bytes) — sim assertions and metrics."""
        with self._mtx:
            return self._pending_count, self._pending_bytes

    def all_pending(self) -> list:
        evs, _ = self.pending_evidence(-1)
        return evs
