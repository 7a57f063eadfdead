"""Blocksync reactor (reference: internal/blocksync/reactor.go).

Channel 0x40 (reference: reactor.go:20).  Serves stored blocks to
catching-up peers and drives the BlockPool: status exchange, parallel
block download, then the two-block verification pipeline —
``verify_commit_light`` on block H using block H+1's LastCommit routes
through the batch-verifier seam (the TPU path), making catchup the
biggest batch-verification consumer in the system (SURVEY.md §2.2).
On completion it hands off to consensus (SwitchToConsensus).

``device`` (None: the card) is where the reactor's verification runs: the
frontier's ``verify_commit_light``, the fused window prefetch
(``ops/verify.verify_segments``, gated by
``types/validation.fused_verify_eligible``) and the extended-commit
checks.  Built with no card the reactor raises unless ``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` names the CPU
(``types/validation.require_device``); on the card a batch the kernel did
not serve raises ``BackendError``.  A failed prefetch logs "fused verify
prefetch failed" and the authoritative per-height verify runs, as in the
JAX package; a failed tick logs "blocksync pool error" and the loop
retries.  A fused prefetch records a "blocksync.prefetch" span
(``libs/tracing``), as the JAX package's does.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Optional

from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.state.execution import InvalidBlockError
from cometbft_tpu_torch.types import codec, validation
from cometbft_tpu_torch.types.basic import BlockID

BLOCKSYNC_CHANNEL = 0x40

_MSG_BLOCK_REQUEST = 1
_MSG_BLOCK_RESPONSE = 2
_MSG_NO_BLOCK_RESPONSE = 3
_MSG_STATUS_REQUEST = 4
_MSG_STATUS_RESPONSE = 5

_STATUS_INTERVAL = 5.0
# Faster cadence for switch peers the pool has no range for yet: a lost
# StatusResponse otherwise blanks that peer's serving capacity for a full
# _STATUS_INTERVAL (painful when it is the fastest helper).
_STATUS_RETRY = 1.0
_SWITCH_TO_CONSENSUS_INTERVAL = 1.0
_POOL_TICK = 0.02

# Never heard from ANY peer for this long after starting: assume a solo
# chain / isolated node and run consensus (COMETBFT_TPU_BSYNC_SOLO_GRACE).
_SOLO_GRACE = 10.0

# Fused-verification window: how many frontier commits may share one device
# dispatch (COMETBFT_TPU_BLOCKSYNC_WINDOW; <2 disables the prefetch).
_DEFAULT_WINDOW = 8


def _window_k() -> int:
    try:
        return int(os.environ.get("COMETBFT_TPU_BLOCKSYNC_WINDOW", str(_DEFAULT_WINDOW)))
    except ValueError:
        return _DEFAULT_WINDOW


def _solo_grace() -> float:
    try:
        return float(
            os.environ.get("COMETBFT_TPU_BSYNC_SOLO_GRACE", str(_SOLO_GRACE))
        )
    except ValueError:
        return _SOLO_GRACE


def _enc(kind: int, body: bytes = b"") -> bytes:
    return bytes([kind]) + body


class BlocksyncReactor(Reactor):
    """Reference: internal/blocksync/reactor.go Reactor."""

    def __init__(
        self,
        state,  # sm.State at boot
        block_exec,
        block_store,
        consensus_reactor=None,  # for SwitchToConsensus
        enabled: bool = True,
        logger=None,
        clock=None,  # injected seam (sim: virtual clock); wall monotonic default
        rng=None,  # injected seam (sim: seeded Random) for the pool's choices
        device=None,
    ):
        super().__init__("BlocksyncReactor")
        self.device = validation.entry_device(device)  # the gate open for the first commit
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.consensus_reactor = consensus_reactor
        self.logger = logger or liblog.nop_logger()
        self.syncing = enabled
        self._clock = clock if clock is not None else time.monotonic
        self._solo_grace = _solo_grace()
        start = max(block_store.height() + 1, state.initial_height)
        self.pool = BlockPool(
            start, self._send_block_request, self.logger, clock=clock, rng=rng,
            progress=self._peer_progress,
        )
        self._thread: Optional[threading.Thread] = None
        self.synced_at: Optional[float] = None
        # tick() pacing state: -inf so the first tick broadcasts status and
        # runs the switch check immediately, as the wall-clock loop did
        self._last_status = float("-inf")
        self._last_status_retry = float("-inf")
        self._status_req_at: Optional[float] = None
        self._last_switch_check = float("-inf")
        # fused-prefetch memo: commit fingerprint -> height, so a window is
        # dispatched once and apply/redo ticks never re-dispatch it
        self._fused: dict[bytes, int] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                BLOCKSYNC_CHANNEL,
                priority=5,
                send_queue_capacity=1000,
                recv_message_capacity=64 * 1024 * 1024,
            )
        ]

    def on_start(self) -> None:
        if self.syncing:
            self._start_pool()

    def _start_pool(self) -> None:
        self._thread = threading.Thread(
            target=self._pool_routine, name="blocksync-pool", daemon=True
        )
        self._thread.start()

    def start_sync(self, state) -> None:
        """Hand-off from statesync (reference: bcReactor.SwitchToBlockSync,
        node/setup.go:587-601): resume block download from the snapshot
        height."""
        self.state = state
        self.pool.height = max(
            self.block_store.height() + 1, state.last_block_height + 1
        )
        self.pool._started_at = self._clock()
        self.syncing = True
        self._start_pool()

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer) -> None:
        # announce our range + ask for theirs
        peer.try_send(BLOCKSYNC_CHANNEL, self._status_response())
        self._status_req_at = self._clock()
        peer.try_send(BLOCKSYNC_CHANNEL, _enc(_MSG_STATUS_REQUEST))

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    def _status_response(self) -> bytes:
        body = pe.t_varint(1, self.block_store.height()) + pe.t_varint(
            2, self.block_store.base()
        )
        return _enc(_MSG_STATUS_RESPONSE, body)

    def _peer_progress(self, peer_id: str) -> Optional[int]:
        """The bytes received from ``peer_id`` on the blocksync channel so
        far, None without a connection: the pool's sign that a block is
        arriving."""
        get = getattr(self.switch, "get_peer", None)
        peer = get(peer_id) if get is not None else None
        conn = getattr(peer, "conn", None)
        ch = conn.channels.get(BLOCKSYNC_CHANNEL) if conn is not None else None
        return ch.recv_bytes if ch is not None else None

    def _send_block_request(self, peer_id: str, height: int) -> bool:
        sw = self.switch
        if sw is None:
            return False
        peer = sw.get_peer(peer_id)
        if peer is None:
            return False
        return peer.try_send(
            BLOCKSYNC_CHANNEL, _enc(_MSG_BLOCK_REQUEST, pe.t_varint(1, height))
        )

    # -- receive -----------------------------------------------------------

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, body = msg_bytes[0], msg_bytes[1:]
        if kind == _MSG_BLOCK_REQUEST:
            f = pe.fields_dict(body)
            height = pe.to_int64(f.get(1, [0])[-1])
            block = self.block_store.load_block(height)
            if block is not None:
                body = pe.t_message(1, codec.encode_block(block), always=True)
                # attach the extended commit when stored (vote extensions):
                # a catching-up validator needs it to propose (reference:
                # BlockResponse.ext_commit).  Gated on the enable height:
                # no store read on the serve path for extension-less chains.
                ext_h = (
                    self.state.consensus_params.feature.vote_extensions_enable_height
                )
                ec = (
                    self.block_store.load_extended_commit(height)
                    if 0 < ext_h <= height
                    else None
                )
                if ec is not None:
                    body += pe.t_message(
                        2, codec.encode_extended_commit(ec), always=True
                    )
                peer.try_send(
                    BLOCKSYNC_CHANNEL, _enc(_MSG_BLOCK_RESPONSE, body)
                )
            else:
                peer.try_send(
                    BLOCKSYNC_CHANNEL,
                    _enc(_MSG_NO_BLOCK_RESPONSE, pe.t_varint(1, height)),
                )
        elif kind == _MSG_BLOCK_RESPONSE:
            f = pe.fields_dict(body)
            block = codec.decode_block(f[1][-1])
            ec = (
                codec.decode_extended_commit(f[2][-1]) if 2 in f else None
            )
            self.pool.add_block(peer.id, block, ec)
        elif kind == _MSG_NO_BLOCK_RESPONSE:
            f = pe.fields_dict(body)
            self.pool.no_block(peer.id, pe.to_int64(f.get(1, [0])[-1]))
        elif kind == _MSG_STATUS_REQUEST:
            peer.try_send(BLOCKSYNC_CHANNEL, self._status_response())
        elif kind == _MSG_STATUS_RESPONSE:
            f = pe.fields_dict(body)
            height = pe.to_int64(f.get(1, [0])[-1])
            base = pe.to_int64(f.get(2, [0])[-1])
            # the status handshake doubles as the RTT bootstrap: without
            # it a new peer has no EWMA and falls back to the flat
            # 15 s REQUEST_TIMEOUT — one dropped first response would
            # wedge a frontier height for the full legacy timeout
            rtt = None
            if self._status_req_at is not None:
                rtt = self._clock() - self._status_req_at
            self.pool.set_peer_range(peer.id, base, height, rtt=rtt)

    # -- the sync loop (reference: reactor.go poolRoutine) -----------------

    def _check_ext_commit(
        self, block, block_id, ec, second_last_commit
    ) -> Optional[str]:
        return check_ext_commit(
            self.state.chain_id,
            self.state.validators,
            block,
            block_id,
            ec,
            second_last_commit,
            device=self.device,
        )


    def tick(self) -> bool:
        """One scheduler pass: periodic status broadcast, the
        switch-to-consensus check, window refill, then the verify/apply
        frontier.  Returns True when a block was processed (more frontier
        work may be immediately available).  The wall-clock thread loop
        wraps this; the deterministic sim drives it directly off the
        virtual clock (sim/blocksync.py)."""
        now = self._clock()
        if now - self._last_status > _STATUS_INTERVAL:
            self._last_status = now
            if self.switch is not None:
                self._status_req_at = now
                self.switch.broadcast(
                    BLOCKSYNC_CHANNEL, _enc(_MSG_STATUS_REQUEST)
                )
        elif now - self._last_status_retry > _STATUS_RETRY:
            # re-ask only the peers whose range we still don't know: their
            # StatusResponse (or our request) was lost in transit
            self._last_status_retry = now
            sw_peers = getattr(self.switch, "peers", None)
            if sw_peers:
                with self.pool._lock:
                    known = set(self.pool.peers)
                for p in list(sw_peers.values()):
                    if p.id not in known:
                        self._status_req_at = now
                        p.try_send(
                            BLOCKSYNC_CHANNEL, _enc(_MSG_STATUS_REQUEST)
                        )
        if now - self._last_switch_check > _SWITCH_TO_CONSENSUS_INTERVAL:
            self._last_switch_check = now
            if self._maybe_switch_to_consensus():
                return False
        self.pool.make_next_requests()
        return self._process_blocks()

    def _pool_routine(self) -> None:
        while self.is_running and self.syncing:
            try:
                if not self.tick():
                    time.sleep(_POOL_TICK)
            except Exception as e:  # noqa: BLE001
                self.logger.error("blocksync pool error", err=repr(e))
                time.sleep(0.5)

    # -- fused window prefetch --------------------------------------------

    @staticmethod
    def _commit_fingerprint(height: int, commit) -> bytes:
        """Cheap per-tick memo key: O(1) in validator count (hashing all
        10k signatures every 20 ms pool tick would be ~MBs of SHA-256 per
        tick once the window is already fused).  A redo replaces the whole
        served commit, so height + block id + round + size + the first and
        last signatures distinguish every case that matters; a collision
        merely skips a SPECULATIVE prefetch — the authoritative sequential
        verification is unaffected."""
        h = hashlib.sha256()
        h.update(height.to_bytes(8, "little", signed=True))
        h.update(commit.block_id.hash)
        h.update(commit.round_.to_bytes(4, "little", signed=True))
        h.update(len(commit.signatures).to_bytes(4, "little"))
        if commit.signatures:
            first, last = commit.signatures[0], commit.signatures[-1]
            h.update(bytes([first.block_id_flag]))
            h.update(first.signature)
            h.update(bytes([last.block_id_flag]))
            h.update(last.signature)
        return h.digest()

    def _prefetch_window(self) -> None:
        """Speculatively verify a window of frontier commits in ONE fused
        device dispatch (ops.verify.verify_segments), seeding the signature
        cache so the authoritative per-height ``verify_commit_light`` in
        ``_process_blocks`` resolves without re-dispatching.

        Safety: verdicts are keyed on the full (pub, msg, sig) triple.  A
        misprediction (validator set changed mid-window) caches triples the
        real verification never queries — it degrades to today's one-
        dispatch-per-height behavior, never to a wrong answer.  Block
        *application* stays strictly sequential in ``_process_blocks``;
        a bad block still takes the same redo/ban path there."""
        k = _window_k()
        if k < 2 or not sigcache.SigCache.enabled():
            return
        if not validation.fused_verify_eligible([self.state.validators], self.device):
            # no trusted accelerator, every device breaker open (catchup
            # then degrades to the authoritative per-commit host verify in
            # _process_blocks; prefetch resumes once a half-open probe
            # passes), or non-ed25519 validators — nothing to fuse
            return
        peek = getattr(self.pool, "peek_window", None)
        if peek is None:
            return
        window = peek(k)
        if len(window) < 3:
            return  # the two-block pipeline covers short runs
        to_fuse = []  # (fingerprint, height, prepared, bits, miss_indices)
        for i in range(len(window) - 1):
            h = window[i][0]
            commit = window[i + 1][1].last_commit
            fp = self._commit_fingerprint(h, commit)
            if fp in self._fused:
                continue
            # best-effort validator-set prediction past the frontier; a miss
            # is safe (see docstring)
            vals = self.state.validators if i == 0 else self.state.next_validators
            try:
                # count_all: cover the full-verification superset, so both
                # the frontier verify_commit_light AND validate_block's
                # apply-time verify_commit resolve from cache
                prepared = validation.prepare_commit_light(
                    self.state.chain_id,
                    vals,
                    commit.block_id,
                    h,
                    commit,
                    count_all=True,
                )
            except validation.CommitVerificationError:
                continue  # malformed: let the sequential path raise/redo/ban
            bits, miss = sigcache.partition_misses(
                prepared.pubs, prepared.msgs, prepared.sigs
            )
            if not miss:
                self._fused[fp] = h  # fully cached already
                continue
            to_fuse.append((fp, h, prepared, bits, miss))
        if not to_fuse:
            return
        from cometbft_tpu_torch.libs import tracing
        from cometbft_tpu_torch.ops import verify as ov

        try:
            with tracing.span(
                "blocksync.prefetch",
                commits=len(to_fuse),
                h0=to_fuse[0][1],
                sigs=sum(len(miss) for *_, miss in to_fuse),
            ):
                results = ov.verify_segments(
                    [
                        (
                            [p.pubs[j] for j in miss],
                            [p.msgs[j] for j in miss],
                            [p.sigs[j] for j in miss],
                        )
                        for _, _, p, _, miss in to_fuse
                    ],
                    self.device,
                )
        except Exception as e:  # noqa: BLE001 — prefetch must never stall sync
            self.logger.error("fused verify prefetch failed", err=repr(e))
            return
        for (fp, h, p, bits, miss), got in zip(to_fuse, results):
            sigcache.writeback(p.pubs, p.msgs, p.sigs, bits, miss, got)
            self._fused[fp] = h
        # trim memo entries behind the frontier
        frontier = self.pool.height
        if len(self._fused) > 4 * max(k, 1):
            self._fused = {
                fp: h for fp, h in self._fused.items() if h >= frontier
            }

    def _process_blocks(self) -> bool:
        """Verify + apply the frontier block using the NEXT block's
        LastCommit (reference: reactor.go:541)."""
        try:
            self._prefetch_window()
        except Exception as e:  # noqa: BLE001 — speculative only
            self.logger.error("blocksync prefetch error", err=repr(e))
        first, second, first_peer, second_peer, first_ext = (
            self.pool.peek_two_blocks()
        )
        if first is None or second is None:
            return False
        first_parts = first.make_part_set()
        first_id = BlockID(hash=first.hash(), part_set_header=first_parts.header)
        from cometbft_tpu_torch import verifysched

        try:
            # THE verification: batch Ed25519 through the pluggable seam,
            # tagged bulk-priority for the shared verify scheduler —
            # catchup signature batches must never delay (and are the
            # first to be shed behind) live consensus votes
            with verifysched.priority_class(verifysched.PRIO_BLOCKSYNC):
                validation.verify_commit_light(
                    self.state.chain_id,
                    self.state.validators,
                    first_id,
                    first.header.height,
                    second.last_commit,
                    device=self.device,
                )
                # The commit only signs the header hash; the block body
                # arrived from an untrusted peer and keeps its wire-carried
                # hashes (fill_header_hashes fills empty fields only).
                # Fully validate body-vs-header and header-vs-state before
                # applying, exactly as the reference does
                # (internal/blocksync/reactor.go:546 ValidateBlock) —
                # otherwise a peer could pair the legitimately signed
                # header with tampered txs/last_commit/evidence.
                self.block_exec.validate_block(self.state, first)
        except (validation.CommitVerificationError, InvalidBlockError) as e:
            self.logger.error(
                "invalid block in blocksync",
                height=first.header.height,
                err=str(e),
            )
            # ban both providers and retry (reference: reactor.go bad-block path)
            self.pool.redo_request(first.header.height)
            self.pool.redo_request(first.header.height + 1)
            for pid in (first_peer, second_peer):
                if self.switch is not None and pid:
                    p = self.switch.get_peer(pid)
                    if p is not None:
                        self.switch.stop_peer_for_error(p, e)
            return True
        ext_enabled = self.state.consensus_params.feature.vote_extensions_enable_height
        need_ext = 0 < ext_enabled <= first.header.height
        if need_ext:
            err = self._check_ext_commit(
                first, first_id, first_ext, second.last_commit
            )
            if err is not None:
                self.logger.error(
                    "bad extended commit in blocksync",
                    height=first.header.height,
                    err=err,
                )
                self.pool.redo_request(first.header.height)
                if self.switch is not None and first_peer:
                    p = self.switch.get_peer(first_peer)
                    if p is not None:
                        self.switch.stop_peer_for_error(p, ValueError(err))
                return True
        self.block_store.save_block(
            first,
            first_parts,
            second.last_commit,
            extended_commit=first_ext if need_ext else None,
        )
        self.state = self.block_exec.apply_verified_block(
            self.state, first_id, first
        )
        self.pool.pop_request()
        if self.block_store.height() % 100 == 0:
            self.logger.info(
                "blocksync progress",
                height=self.block_store.height(),
                target=self.pool.max_peer_height(),
            )
        return True

    def _maybe_switch_to_consensus(self) -> bool:
        """Reference: poolRoutine's switchToConsensusTicker."""
        if not self.pool.is_caught_up():
            # never heard from any peer after a grace period: we are alone
            # (solo chain / isolated) — run consensus.  A TEMPORARILY empty
            # peer set mid-sync must NOT trigger this: reconnect will refill
            if (
                not self.pool.ever_had_peers
                and self._clock() - self.pool._started_at > self._solo_grace
            ):
                return self._switch()
            return False
        return self._switch()

    def _switch(self) -> bool:
        self.syncing = False
        self.synced_at = self._clock()
        self.logger.info(
            "blocksync complete, switching to consensus",
            height=self.block_store.height(),
        )
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(self.state)
        return True



def check_ext_commit(
    chain_id, validators, block, block_id, ec, second_last_commit, device=None
) -> Optional[str]:
    """Validate a served extended commit.  The reference only checks
    structure (ExtendedCommit.EnsureExtensions; reactor.go:559 has a
    TODO about validating further) — we additionally verify +2/3 of
    the commit signatures (skipped when identical to the next block's
    already-verified LastCommit) AND every extension signature, both
    through the batch seam: extensions are NOT covered by the commit
    signatures, so a structural check alone would let one malicious
    peer serve real commit sigs with tampered extensions that later
    feed the app's ExtendedCommitInfo."""
    if ec is None:
        return "peer served no extended commit for an extension height"
    if ec.height != block.header.height:
        return f"extended commit height {ec.height} != block"
    if ec.block_id != block_id:
        return "extended commit is for a different block"
    for cs in ec.extended_signatures:
        if cs.for_block() and not cs.extension_signature:
            return "commit signature missing its extension signature"
    # bulk class for the whole check: ext-commit signature batches are
    # catchup traffic like the rest of blocksync — they must never ride
    # the shed-exempt consensus class ahead of live votes
    from cometbft_tpu_torch import verifysched

    with verifysched.priority_class(verifysched.PRIO_BLOCKSYNC):
        return _check_ext_commit_sigs(
            chain_id, validators, block, block_id, ec, second_last_commit, device
        )


def _check_ext_commit_sigs(
    chain_id, validators, block, block_id, ec, second_last_commit, device=None
) -> Optional[str]:
    base = ec.to_commit()
    if base.signatures != second_last_commit.signatures:
        # usually identical to the (already verified) next block's
        # LastCommit; only a genuinely different signature set pays a
        # second +2/3 verification
        try:
            validation.verify_commit_light(
                chain_id,
                validators,
                block_id,
                block.header.height,
                base,
                device=device,
            )
        except Exception as e:  # noqa: BLE001
            return f"extended commit fails +2/3 verification: {e}"
    # Extension signatures are NOT covered by the commit signatures, so
    # verify them against the validator keys through the batch seam —
    # otherwise one malicious peer could serve real commit sigs with
    # tampered extensions, poisoning the app's future ExtendedCommitInfo.
    from cometbft_tpu_torch.types.canonical import (
        canonical_vote_extension_sign_bytes,
    )

    vals = validators.validators
    entries = []
    for i, cs in enumerate(ec.extended_signatures):
        if not cs.for_block():
            continue
        if i >= len(vals):
            return "extended commit has more signatures than validators"
        msg = canonical_vote_extension_sign_bytes(
            chain_id, ec.height, ec.round_, cs.extension
        )
        entries.append((vals[i].pub_key, msg, cs.extension_signature))
    # batch when every key supports it AND the key type is homogeneous
    # (same discipline as validation._should_batch — one batch verifier
    # handles one key type); per-signature fallback otherwise, so mixed or
    # secp256k1 validator sets must not stall blocksync
    if (
        len(entries) >= 2
        and len({getattr(pk, "type_", None) for pk, _, _ in entries}) == 1
        and all(cbatch.supports_batch_verifier(pk) for pk, _, _ in entries)
    ):
        bv = cbatch.create_batch_verifier(entries[0][0], device=device)
        for pk, msg, sig in entries:
            bv.add(pk, msg, sig)
        ok, _bits = bv.verify()
        if not ok:
            return "extension signature verification failed"
    else:
        for pk, msg, sig in entries:
            if not pk.verify_signature(msg, sig):
                return "extension signature verification failed"
    return None
