"""Light client (reference: light/client.go:133 Client).

Header-sync client: initialize from trust options (height + hash inside
the trusting period), then verify target headers either sequentially
(``verifySequential``, :608) or by skipping with bisection
(``verifySkipping``, :701).  A witness ``detector`` (reference:
light/detector.go) cross-checks every newly verified header against
secondary providers; divergence yields light-client-attack evidence
reported to both sides.

``device`` (None: the card) is where the client verifies: its commits go
through ``verify_commit_light``, ``verify_adjacent_chain`` and
``verify_non_adjacent`` to the Ed25519 kernel, and its set hashes to the
tree kernel.  Built with no card the client raises unless the caller
names the CPU (``device="cpu"`` or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``;
``types/validation.entry_device``); on the card it resolves the batch
backend when it is built, as ``sim/node.build_node`` does.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Optional

from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.light import verifier as lv
from cometbft_tpu_torch.light.provider import (
    ErrLightBlockNotFound,
    Provider,
    ProviderError,
)
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import (
    ErrNewValSetCantBeTrusted,
    LightClientError,
    TrustOptions,
    VerificationError,
)
from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
from cometbft_tpu_torch.types.light import LightBlock

SEQUENTIAL = "sequential"
SKIPPING = "skipping"


class ErrLightClientDivergence(LightClientError):
    """A witness disagrees with the primary: possible attack."""


class LightClient:
    """Reference: light/client.go Client."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: list[Provider],
        store: LightStore,
        mode: str = SKIPPING,
        trust_level: Fraction = lv.DEFAULT_TRUST_LEVEL,
        max_clock_drift_s: float = 10.0,
        logger=None,
        now_fn=time.time,
        device=None,
    ):
        from cometbft_tpu_torch.types.validation import entry_device

        self.device = entry_device(device)
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.mode = mode
        self.trust_level = trust_level
        self.max_clock_drift_s = max_clock_drift_s
        self.logger = logger or liblog.nop_logger()
        self.now_fn = now_fn

        trust_options.validate()
        self._initialize()

    # -- initialization (reference: client.go initializeWithTrustOptions) --

    def _initialize(self) -> None:
        existing = self.store.latest()
        if existing is not None and existing.height >= self.trust_options.height:
            return  # already initialized at/after the trust height
        lb = self.primary.light_block(self.trust_options.height)
        if lb.hash() != self.trust_options.hash:
            raise LightClientError(
                f"trusted header hash mismatch at height "
                f"{self.trust_options.height}: expected "
                f"{self.trust_options.hash.hex()}, got {lb.hash().hex()}"
            )
        err = lb.validate_basic(self.chain_id, self.device)
        if err:
            raise LightClientError(f"invalid trusted block: {err}")
        # self-consistency: +2/3 of its own set signed it
        from cometbft_tpu_torch.types import validation

        validation.verify_commit_light(
            self.chain_id,
            lb.validator_set,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
            device=self.device,
        )
        self.store.save_light_block(lb)

    # -- public API --------------------------------------------------------

    def trusted_light_block(self, height: int = 0) -> Optional[LightBlock]:
        if height == 0:
            return self.store.latest()
        return self.store.light_block(height)

    def update(self, now: Optional[float] = None) -> Optional[LightBlock]:
        """Verify the primary's latest header (reference: client.go:431)."""
        latest = self.primary.light_block(0)
        trusted = self.store.latest()
        if trusted is not None and latest.height <= trusted.height:
            return trusted
        return self.verify_light_block_at_height(latest.height, now)

    def verify_light_block_at_height(
        self, height: int, now: Optional[float] = None
    ) -> LightBlock:
        """Reference: client.go:469 VerifyLightBlockAtHeight."""
        now = self.now_fn() if now is None else now
        got = self.store.light_block(height)
        if got is not None:
            return got
        trusted = self.store.light_block_before(height + 1)
        if trusted is None:
            raise LightClientError("store empty: client not initialized")
        if trusted.height > height:
            raise LightClientError(
                f"cannot verify height {height} below trusted root "
                f"{trusted.height} (use a store with earlier blocks)"
            )
        target = self.primary.light_block(height)
        # verify first (collecting the chain of newly trusted blocks), then
        # cross-check against witnesses, and only THEN persist: a header the
        # witnesses dispute must never enter the trusted store (reference:
        # detector runs before the store write, client.go:522-534)
        verified: list[LightBlock] = []
        if self.mode == SEQUENTIAL:
            self._verify_sequential(trusted, target, now, verified)
        else:
            self._verify_skipping(trusted, target, now, verified)
        self._detect_divergence(target, now)
        for lb in verified:
            self.store.save_light_block(lb)
        return target

    # -- sequential (reference: client.go:608) -----------------------------

    # headers per pipelined window: enough to amortize the per-dispatch
    # floor, small enough to bound wasted work past a bad header
    SEQ_WINDOW = 8

    def _verify_sequential(
        self,
        trusted: LightBlock,
        target: LightBlock,
        now: float,
        verified: list,
    ) -> None:
        """Windows of up to SEQ_WINDOW headers go through
        ``verify_adjacent_chain``: next-header host prep overlaps the
        in-flight commit dispatch (``ops.verify.verify_batches_overlapped``)
        instead of blocking on one height at a time.  Error behavior per
        header is that of ``verify_adjacent``; nothing from a failed window
        is appended to ``verified``."""
        current = trusted
        heights = list(range(trusted.height + 1, target.height + 1))
        for w in range(0, len(heights), self.SEQ_WINDOW):
            chunk = [
                target
                if h == target.height
                else self.primary.light_block(h)
                for h in heights[w : w + self.SEQ_WINDOW]
            ]
            lv.verify_adjacent_chain(
                self.chain_id,
                current,
                chunk,
                self.trust_options.period_s,
                now,
                self.max_clock_drift_s,
                device=self.device,
            )
            verified.extend(chunk)
            current = chunk[-1]

    # -- skipping / bisection (reference: client.go:701) -------------------

    def _verify_skipping(
        self,
        trusted: LightBlock,
        target: LightBlock,
        now: float,
        verified: list,
    ) -> None:
        current = trusted
        pending = [target]
        while pending:
            candidate = pending[-1]
            try:
                lv.verify_non_adjacent(
                    self.chain_id,
                    current,
                    candidate,
                    self.trust_options.period_s,
                    now,
                    self.trust_level,
                    self.max_clock_drift_s,
                    device=self.device,
                )
            except ErrNewValSetCantBeTrusted:
                # bisect: fetch the midpoint and try to trust that first
                mid = (current.height + candidate.height) // 2
                if mid in (current.height, candidate.height):
                    raise VerificationError(
                        "bisection exhausted without convergence"
                    )
                pending.append(self.primary.light_block(mid))
                continue
            verified.append(candidate)
            current = candidate
            pending.pop()

    # -- detector (reference: light/detector.go) ---------------------------

    def _detect_divergence(self, verified: LightBlock, now: float) -> None:
        """Cross-check the primary's header against every witness; on
        divergence, report attack evidence BOTH ways (either side could be
        the liar — reference: light/detector.go submits to primary and
        witness) and raise without trusting the header.  Neither provider is
        evicted here: the caller decides whom to keep."""
        if not self.witnesses:
            return
        diverged = 0
        common = self.store.light_block_before(verified.height)
        for w in self.witnesses:
            try:
                wlb = w.light_block(verified.height)
            except (ErrLightBlockNotFound, ProviderError):
                continue  # witness behind / unreachable: skip (ref: detector)
            if wlb.hash() == verified.hash():
                continue
            diverged += 1
            self.logger.error(
                "conflicting headers between primary and witness",
                height=verified.height,
                witness=w.id(),
            )
            for block, reporter in ((wlb, self.primary), (verified, w)):
                ev = LightClientAttackEvidence(
                    conflicting_block=block,
                    common_height=common.height if common else verified.height - 1,
                    total_voting_power=(
                        common.validator_set.total_voting_power() if common else 0
                    ),
                    timestamp=(
                        common.signed_header.header.time
                        if common
                        else verified.signed_header.header.time
                    ),
                )
                try:
                    reporter.report_evidence(ev)
                except Exception as e:  # noqa: BLE001 — must not mask detection
                    self.logger.debug("evidence report failed", err=repr(e))
        if diverged:
            raise ErrLightClientDivergence(
                f"{diverged} witness(es) diverged from the primary at height "
                f"{verified.height}; header NOT trusted"
            )

    # -- maintenance -------------------------------------------------------

    def prune(self, keep: int = 1000) -> int:
        return self.store.prune(keep)
