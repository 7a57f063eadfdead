"""Light client verification core (reference: light/verifier.go), the
port's counterpart of the JAX package's ``light/verifier.py``.

``verify_adjacent`` (:91) checks a height+1 header against the trusted
header's next-validators hash; ``verify_non_adjacent`` (:30) checks an
arbitrary later header by requiring >1/3 (trust level) of the TRUSTED
validator set to have signed it, then +2/3 of its own set.  Each header's
``LightBlock.validate_basic`` hashes its validator set through the
hashing plane (the SHA-256 tree kernel on the card), and the commit
checks go through the batch-verifier seam (the Ed25519 kernel).  Every
entry point takes ``backend`` and ``device`` for ``verify_commit*`` and
for the tree hashes of its header checks: by default the card;
``backend="cpu"`` or ``device="cpu"`` runs both on the CPU.
Errors, and the order in which they are raised, are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

from cometbft_tpu_torch import verifysched
from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.basic import Timestamp
from cometbft_tpu_torch.types.light import LightBlock

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class LightClientError(Exception):
    pass


class VerificationError(LightClientError):
    pass


class ErrOldHeaderExpired(VerificationError):
    pass


class ErrInvalidHeader(VerificationError):
    pass


class ErrNewValSetCantBeTrusted(VerificationError):
    """Not enough trusted power signed: bisect (reference:
    ErrNewValSetCantBeTrusted)."""


@dataclass
class TrustOptions:
    """Reference: light/client.go TrustOptions."""

    period_s: int  # trusting period
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_s <= 0:
            raise LightClientError("trusting period must be positive")
        if self.height <= 0:
            raise LightClientError("trust height must be positive")
        if len(self.hash) != 32:
            raise LightClientError("trust hash must be 32 bytes")


def header_expired(header_time: Timestamp, trusting_period_s: int, now: float) -> bool:
    """Reference: light/verifier.go HeaderExpired."""
    return header_time.to_ns() / 1e9 + trusting_period_s <= now


def _tree_device(backend, device):
    """Where the header checks hash their validator sets: the CPU when the
    caller asks for it; otherwise ``device``, or with neither named the
    card: ``default_backend`` runs its self-check first (and raises
    without a card), so that the trust gate is open before the first
    header's hash, unless ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` keeps it
    closed (the host)."""
    from cometbft_tpu_torch.ops.verify import resolve_device

    if backend == "cpu":
        return "cpu"
    if device is not None:
        return device
    if backend is None:
        cbatch.default_backend()
        return None
    return resolve_device(None)


def _validate_new_block(
    chain_id: str,
    trusted: LightBlock,
    new: LightBlock,
    now: float,
    max_clock_drift_s: float,
    tree_device=None,
) -> None:
    err = new.validate_basic(chain_id, tree_device)
    if err:
        raise ErrInvalidHeader(err)
    if new.height <= trusted.height:
        raise ErrInvalidHeader(
            f"new height {new.height} <= trusted {trusted.height}"
        )
    new_ns = new.signed_header.header.time.to_ns()
    if new_ns <= trusted.signed_header.header.time.to_ns():
        raise ErrInvalidHeader("new header time is not after trusted header time")
    if new_ns / 1e9 > now + max_clock_drift_s:
        raise ErrInvalidHeader("new header is from the future")


def _verify_own_commit(chain_id: str, new: LightBlock, backend, device) -> None:
    """+2/3 of the new header's own set signed it, at light priority."""
    commit = new.signed_header.commit
    with verifysched.priority_class(verifysched.PRIO_LIGHT):
        validation.verify_commit_light(
            chain_id, new.validator_set, commit.block_id, new.height, commit,
            backend, device,
        )


def verify_adjacent(
    chain_id: str,
    trusted: LightBlock,
    new: LightBlock,
    trusting_period_s: int,
    now: float,
    max_clock_drift_s: float = 10.0,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Reference: light/verifier.go:91 VerifyAdjacent.

    The commit check runs at light priority through the shared verify
    scheduler (via the batch-verifier seam): a syncing light client's
    signature batches coalesce with other callers' work without ever
    delaying consensus votes."""
    _check_adjacent_headers(
        chain_id, trusted, new, trusting_period_s, now, max_clock_drift_s,
        _tree_device(backend, device),
    )
    _verify_own_commit(chain_id, new, backend, device)


def _check_adjacent_headers(
    chain_id: str,
    trusted: LightBlock,
    new: LightBlock,
    trusting_period_s: int,
    now: float,
    max_clock_drift_s: float,
    tree_device=None,
) -> None:
    """Every check ``verify_adjacent`` performs EXCEPT the commit signature
    verification — the host half (the validator-set hash on
    ``tree_device``), ONE copy shared by the sequential path and the chain
    path."""
    if new.height != trusted.height + 1:
        raise ErrInvalidHeader("headers must be adjacent")
    if header_expired(trusted.signed_header.header.time, trusting_period_s, now):
        raise ErrOldHeaderExpired("trusted header expired")
    _validate_new_block(chain_id, trusted, new, now, max_clock_drift_s,
                        tree_device)
    if (
        new.signed_header.header.validators_hash
        != trusted.signed_header.header.next_validators_hash
    ):
        raise ErrInvalidHeader(
            "new validators hash does not match trusted next_validators_hash"
        )


def verify_adjacent_chain(
    chain_id: str,
    trusted: LightBlock,
    news: "list[LightBlock]",
    trusting_period_s: int,
    now: float,
    max_clock_drift_s: float = 10.0,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Verify a consecutive run of headers (trusted+1, trusted+2, ...) with
    host/device overlap: every header's host work (adjacency, the
    validator-hash link, sign bytes) runs up front, then the signature
    cache's misses of every header go through
    ``ops.verify.verify_batches_overlapped``, one batch per header, so that
    header i+1's host prep overlaps header i's launch.  Judgement stays
    strictly in order, so the error class raised for a bad header matches
    what sequential ``verify_adjacent`` raises for it (when several headers
    are independently bad, the chain may surface a later header's
    *structural* error before an earlier header's *signature* error —
    either way nothing is trusted).

    The sequential loop runs instead for fewer than 2 headers, for
    ``backend="cpu"``, and when ``validation.fused_verify_eligible`` is
    False (no trusted card, every device breaker open, or a validator set
    that is not uniformly Ed25519)."""
    from cometbft_tpu_torch.crypto import sigcache
    from cometbft_tpu_torch.ops import verify as ov

    if not news:
        return
    if (
        len(news) < 2
        or backend == "cpu"
        or not validation.fused_verify_eligible(
            [lb.validator_set for lb in news], device
        )
    ):
        current = trusted
        for lb in news:
            verify_adjacent(chain_id, current, lb, trusting_period_s, now,
                            max_clock_drift_s, backend, device)
            current = lb
        return

    # host pass: adjacency checks and sign bytes of every header
    prepared = []
    current = trusted
    tree_device = _tree_device(backend, device)
    for lb in news:
        _check_adjacent_headers(
            chain_id, current, lb, trusting_period_s, now, max_clock_drift_s,
            tree_device,
        )
        commit = lb.signed_header.commit
        prepared.append(
            validation.prepare_commit_light(
                chain_id, lb.validator_set, commit.block_id, lb.height, commit
            )
        )
        current = lb

    # device pass: only the cache's misses, one overlapped batch per header
    per_header = []  # (prepared, bits with None holes, miss indices)
    for p in prepared:
        bits, miss = sigcache.partition_misses(p.pubs, p.msgs, p.sigs)
        per_header.append((p, bits, miss))
    work = [
        ([p.pubs[j] for j in miss], [p.msgs[j] for j in miss],
         [p.sigs[j] for j in miss])
        for p, _, miss in per_header
        if miss
    ]
    from cometbft_tpu_torch.libs import tracing

    with tracing.span(
        "light.chain",
        headers=len(news),
        h0=news[0].height,
        sigs=sum(len(m) for _, _, m in per_header),
    ):
        fresh = iter(ov.verify_batches_overlapped(work, device) if work else [])

    # judge strictly in order
    for p, bits, miss in per_header:
        if miss:
            sigcache.writeback(p.pubs, p.msgs, p.sigs, bits, miss, next(fresh))
        validation.finish_commit_light(p, bits)


def verify_non_adjacent(
    chain_id: str,
    trusted: LightBlock,
    new: LightBlock,
    trusting_period_s: int,
    now: float,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    max_clock_drift_s: float = 10.0,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Reference: light/verifier.go:30 VerifyNonAdjacent."""
    if new.height == trusted.height + 1:
        return verify_adjacent(chain_id, trusted, new, trusting_period_s, now,
                               max_clock_drift_s, backend, device)
    if header_expired(trusted.signed_header.header.time, trusting_period_s, now):
        raise ErrOldHeaderExpired("trusted header expired")
    _validate_new_block(chain_id, trusted, new, now, max_clock_drift_s,
                        _tree_device(backend, device))
    # >trust_level of the TRUSTED set signed the new header
    try:
        with verifysched.priority_class(verifysched.PRIO_LIGHT):
            validation.verify_commit_light_trusting(
                chain_id, trusted.validator_set, new.signed_header.commit,
                trust_level, backend, device,
            )
    except validation.NotEnoughPowerError as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    # and +2/3 of the NEW set signed it
    _verify_own_commit(chain_id, new, backend, device)


def verify(
    chain_id: str,
    trusted: LightBlock,
    new: LightBlock,
    trusting_period_s: int,
    now: float,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Reference: light/verifier.go:128 Verify."""
    if new.height == trusted.height + 1:
        verify_adjacent(chain_id, trusted, new, trusting_period_s, now,
                        backend=backend, device=device)
    else:
        verify_non_adjacent(chain_id, trusted, new, trusting_period_s, now,
                            trust_level, backend=backend, device=device)
