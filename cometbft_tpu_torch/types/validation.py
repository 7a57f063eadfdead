"""Commit verification — the north-star hot path
(reference: types/validation.go:28,63,129,220-333).

``verify_commit`` / ``verify_commit_light`` / ``verify_commit_light_trusting``
route every signature through the pluggable batch-verifier seam
(``crypto.batch``), behind the signature cache.  On the GPU backend a
10k-validator commit is at most one kernel launch (none when every vote
was verified before); per-signature accept bits make failure attribution
free (the reference needs a second pass: types/validation.go:308-317).
``prepare_commit_light`` / ``finish_commit_light`` split the light path
around ``ops.verify.dispatch_segments`` / ``fetch_segments``, so that
many commits can be in flight at once.

Errors, and the order in which they are raised, are the JAX package's.
``backend``/``device`` pick the verifier: by default the CUDA card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional

from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import dispatch_stats
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.block import Commit
from cometbft_tpu_torch.types.validator import ValidatorSet


class CommitVerificationError(Exception):
    pass


class InvalidSignatureError(CommitVerificationError):
    def __init__(self, index: int):
        super().__init__(f"wrong signature at index {index}")
        self.index = index


class NotEnoughPowerError(CommitVerificationError):
    def __init__(self, got: int, needed: int):
        super().__init__(f"insufficient voting power: got {got}, needed > {needed}")
        self.got = got
        self.needed = needed


def _verify_basic(vals: ValidatorSet, commit: Commit, height: int, block_id: BlockID):
    if commit is None:
        raise CommitVerificationError("nil commit")
    err = commit.validate_basic()
    if err:
        raise CommitVerificationError(err)
    if vals is None or len(vals) == 0:
        raise CommitVerificationError("empty validator set")
    if height != commit.height:
        raise CommitVerificationError(
            f"commit height {commit.height} != expected {height}"
        )
    if commit.block_id != block_id:
        raise CommitVerificationError("commit is for a different block id")
    if len(vals) != commit.size():
        raise CommitVerificationError(
            f"commit size {commit.size()} != validator set size {len(vals)}"
        )


def _should_batch(vals: ValidatorSet, commit: Commit) -> bool:
    """Reference: types/validation.go:15 shouldBatchVerify — >=2 signatures
    and a batch-capable HOMOGENEOUS key type."""
    non_absent = sum(0 if cs.absent() else 1 for cs in commit.signatures)
    if non_absent < 2:
        return False
    types = {getattr(v.pub_key, "type_", None) for v in vals.validators}
    if len(types) != 1:
        return False
    return all(cbatch.supports_batch_verifier(v.pub_key) for v in vals.validators)


def _collect_entries(
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    count_all: bool,
    lookup_by_address: bool,
):
    """Which (idx, val, cs) triples get their signatures checked.  Returns
    (entries, tallied) — tallied is only meaningful for count_all=False,
    where collection stops at the power threshold."""
    entries = []  # (commit_idx, validator, commit_sig)
    tallied = 0
    seen_addrs: set[bytes] = set()  # trusting mode: count each validator once
    for idx, cs in enumerate(commit.signatures):
        if cs.absent():
            continue
        if lookup_by_address:
            found = vals.get_by_address(cs.validator_address)
            if found is None:
                continue
            val = found[1]
            if val.address in seen_addrs:
                raise CommitVerificationError(
                    f"duplicate validator {val.address.hex()} in commit"
                )
            seen_addrs.add(val.address)
        else:
            val = vals.get_by_index(idx)
            if val is None:
                continue
            if cs.validator_address and val.address != cs.validator_address:
                raise CommitVerificationError(
                    f"validator address mismatch at index {idx}"
                )
        entries.append((idx, val, cs))
        if not count_all:
            if cs.for_block():
                tallied += val.voting_power
            if tallied > voting_power_needed:
                break
    return entries, tallied


def _judge_entries(entries, bits) -> None:
    """First failed entry names the culprit index."""
    for (idx, _, _), bit in zip(entries, bits):
        if not bit:
            raise InvalidSignatureError(idx)


def _tally(entries, tallied: int, count_all: bool, voting_power_needed: int):
    if count_all:
        tallied = sum(
            val.voting_power for _, val, cs in entries if cs.for_block()
        )
    if tallied <= voting_power_needed:
        raise NotEnoughPowerError(tallied, voting_power_needed)


def _verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    count_all: bool,
    lookup_by_address: bool,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Shared engine for all three public variants.

    count_all=True  -> verify every non-absent signature (consensus safety).
    count_all=False -> stop as soon as tallied power exceeds the threshold
                       (light-client fast path; remaining sigs unverified).
    lookup_by_address -> trusting mode: commit indexes may not match the
                       validator set; match signatures by address.
    """
    t0 = time.perf_counter()
    with tracing.span(
        "verify.commit",
        height=commit.height,
        sigs=len(commit.signatures),
        count_all=count_all,
    ) as sp:
        entries, tallied = _collect_entries(
            vals, commit, voting_power_needed, count_all, lookup_by_address
        )
        sp.set(entries=len(entries))
        if entries:
            if _should_batch(vals, commit) and len(entries) >= 2:
                bv = cbatch.create_batch_verifier(
                    entries[0][1].pub_key, backend, device
                )
                sign_bytes = commit.all_vote_sign_bytes(
                    chain_id, [idx for idx, _, _ in entries]
                )
                for (idx, val, cs), sb in zip(entries, sign_bytes):
                    bv.add(val.pub_key, sb, cs.signature)
                ok, bits = bv.verify()
                if not ok:
                    _judge_entries(entries, bits)
                    raise CommitVerificationError("batch verification failed")
            else:
                for idx, val, cs in entries:
                    if not sigcache.verify_with_cache(
                        val.pub_key,
                        commit.vote_sign_bytes(chain_id, idx),
                        cs.signature,
                    ):
                        raise InvalidSignatureError(idx)
        _tally(entries, tallied, count_all, voting_power_needed)
    dispatch_stats.record_verify_latency(time.perf_counter() - t0)


@dataclass
class PreparedCommit:
    """The host half of a light commit verification, split out so pipelined
    consumers (light-client chain sync, blocksync window prefetch) can
    dispatch many commits' signature batches before judging any of them.
    ``pubs``/``msgs``/``sigs`` align 1:1 with ``entries``."""

    chain_id: str
    vals: ValidatorSet
    commit: Commit
    voting_power_needed: int
    tallied: int
    count_all: bool = False
    entries: list = field(default_factory=list)
    pubs: list = field(default_factory=list)
    msgs: list = field(default_factory=list)
    sigs: list = field(default_factory=list)


def prepare_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    count_all: bool = False,
) -> PreparedCommit:
    """Phase 1 of ``verify_commit_light``: basic checks + entry collection +
    sign-bytes construction.  Raises exactly what ``verify_commit_light``
    would raise for a malformed commit; does NOT touch any signature.

    ``count_all=True`` collects every non-absent entry (the superset the
    full ``verify_commit`` queries)."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    entries, tallied = _collect_entries(vals, commit, needed, count_all, False)
    msgs = commit.all_vote_sign_bytes(chain_id, [idx for idx, _, _ in entries])
    return PreparedCommit(
        chain_id=chain_id,
        vals=vals,
        commit=commit,
        voting_power_needed=needed,
        tallied=tallied,
        count_all=count_all,
        entries=entries,
        pubs=[val.pub_key.bytes() for _, val, _ in entries],
        msgs=list(msgs),
        sigs=[cs.signature for _, _, cs in entries],
    )


def fused_verify_eligible(validator_sets=(), device=None) -> bool:
    """The eligibility gate for speculative fused verification (the
    in-flight seam of ``ops.verify``): the default backend is ``gpu``
    (``default_backend`` raises without a card; ``device``, where given,
    names the device instead), the supervisor has a live device tier
    (with every breaker open, catch-up degrades to per-commit host
    verification instead of speculating), and every supplied validator
    set is uniformly ed25519 (the kernel's key type)."""
    from cometbft_tpu_torch.crypto import keys as ck
    from cometbft_tpu_torch.ops import supervisor

    if device is None and cbatch.default_backend() != "gpu":
        return False
    if supervisor.enabled() and supervisor.active_backend(device) is None:
        return False
    for vals in validator_sets:
        if not all(
            getattr(v.pub_key, "type_", None) == ck.ED25519_KEY_TYPE
            for v in vals.validators
        ):
            return False
    return True


def finish_commit_light(prepared: PreparedCommit, bits) -> None:
    """Phase 2: judge the accept bits (aligned with ``prepared.entries``)
    and tally power — same errors, same order, as the ``_verify_commit``
    mode ``prepared`` was collected under."""
    _judge_entries(prepared.entries, bits)
    _tally(
        prepared.entries,
        prepared.tallied,
        prepared.count_all,
        prepared.voting_power_needed,
    )


def require_device(device=None):
    """The device rule of the entry points that verify commits on a
    caller's behalf (``state/execution.BlockExecutor``,
    ``evidence/pool.EvidencePool``), checked when they are built: ``None``
    means the card, unless ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` asks for
    the CPU; a CUDA request with no card raises here rather than at the
    first commit.  Returns ``device``."""
    if device is not None or cbatch.env_backend() != "cpu":
        from cometbft_tpu_torch.ops.verify import resolve_device

        resolve_device(device)
    return device


def entry_device(device=None):
    """``require_device`` for an entry point that verifies, hashes or
    seals on its own threads, and on the card the batch backend resolved
    now (``crypto/batch.default_backend``: the kernel's known-answer
    self-check, once a process).  The verify scheduler's gate, which the
    hashing and transport planes read too, stays closed until then, and
    the entry point's first batches would go to the host with no counter
    showing it.  Returns ``device``."""
    device = require_device(device)
    if str(device or "cuda").startswith("cuda") and cbatch.env_backend() != "cpu":
        cbatch.default_backend()
    return device


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Full verification: every signature checked, +2/3 power required
    (reference: types/validation.go:28)."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_commit(chain_id, vals, commit, needed, True, False, backend, device)


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Light verification: stop at +2/3 (reference: types/validation.go:63)."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_commit(chain_id, vals, commit, needed, False, False, backend, device)


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Trusting-period verification against a possibly different validator
    set; needs > trust_level of this set's power
    (reference: types/validation.go:129)."""
    if commit is None or not commit.signatures:
        raise CommitVerificationError("nil or empty commit")
    if trust_level.numerator * 3 < trust_level.denominator:  # < 1/3
        raise CommitVerificationError("trust level must be >= 1/3")
    total = vals.total_voting_power()
    needed = total * trust_level.numerator // trust_level.denominator
    _verify_commit(chain_id, vals, commit, needed, False, True, backend, device)
