"""Evidence verification (reference: internal/evidence/verify.go).

``verify`` dispatches on evidence kind, checks age against the chain's
evidence params, then validates the byzantine claim cryptographically —
duplicate votes by checking both signatures in one flush of the verify
scheduler at ``PRIO_EVIDENCE``, light-client attacks by re-running commit
verification of the conflicting block against the common validator set
(the batch-verifier seam, i.e. the card's Ed25519 kernel, exactly like
live commit verification).

``device`` is the caller's (``EvidencePool``): ``None`` means the card,
``"cpu"`` the host (or, while a caller holds the gate open on the CPU,
``verifysched.open_gate``, the scheduler there).  On the card a flush or a batch the kernel did not
serve raises ``BackendError``, which is not a verdict on the evidence.
"""

from __future__ import annotations

from fractions import Fraction

from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    LightClientAttackEvidence,
)


class EvidenceInvalidError(EvidenceError):
    pass


def verify(ev, state, state_store, block_store, device=None) -> None:
    """Reference: internal/evidence/verify.go:29 verify."""
    height = ev.height
    params = state.consensus_params.evidence

    # The evidence timestamp must match the block time at its height
    # (reference: verify.go:73-81) — otherwise the time half of the expiry
    # test below would be attacker-controlled.  When the block meta is
    # unavailable (pruned / state-synced node) the timestamp cannot be
    # authenticated, so the evidence must be REJECTED, exactly as the
    # reference errors out: accepting it here while meta-holding nodes
    # reject on time mismatch would let the same proposed block be valid on
    # one class of nodes and invalid on another — a consensus split.
    meta = block_store.load_block_meta(height)
    age_blocks = state.last_block_height - height
    if meta is None:
        raise EvidenceInvalidError(
            f"no block meta at evidence height {height}; cannot verify "
            "evidence time"
        )
    if meta.header.time != ev.time:
        raise EvidenceInvalidError(
            "evidence timestamp does not match block time at its height"
        )
    age_ns = state.last_block_time.to_ns() - ev.time.to_ns()
    expired = (
        age_blocks > params.max_age_num_blocks
        and age_ns > params.max_age_duration_ns
    )
    if expired:
        raise EvidenceInvalidError(
            f"evidence from height {height} is too old ({age_blocks} blocks)"
        )

    if isinstance(ev, DuplicateVoteEvidence):
        vals = state_store.load_validators(height)
        if vals is None:
            raise EvidenceInvalidError(f"no validator set at height {height}")
        verify_duplicate_vote(ev, state.chain_id, vals, device)
    elif isinstance(ev, LightClientAttackEvidence):
        common_vals = state_store.load_validators(ev.common_height)
        if common_vals is None:
            raise EvidenceInvalidError(
                f"no validator set at common height {ev.common_height}"
            )
        trusted_meta = block_store.load_block_meta(
            ev.conflicting_block.height
        )
        trusted_header = trusted_meta.header if trusted_meta else None
        verify_light_client_attack(
            ev, state.chain_id, common_vals, trusted_header, device
        )
    else:
        raise EvidenceInvalidError(f"unknown evidence type {type(ev).__name__}")


def _on_host(device) -> bool:
    return device is not None and str(device).split(":")[0] == "cpu"


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence, chain_id: str, valset, device=None
) -> None:
    """Reference: internal/evidence/verify.go:164 VerifyDuplicateVote."""
    a, b = ev.vote_a, ev.vote_b
    if a.height != b.height or a.round_ != b.round_ or a.type_ != b.type_:
        raise EvidenceInvalidError("votes are for different height/round/type")
    if a.block_id == b.block_id:
        raise EvidenceInvalidError("votes are for the same block id")
    if a.validator_address != b.validator_address:
        raise EvidenceInvalidError("votes are from different validators")

    found = valset.get_by_address(a.validator_address)
    if found is None:
        raise EvidenceInvalidError(
            f"validator {a.validator_address.hex()} not in set at that height"
        )
    _, val = found
    if ev.validator_power != val.voting_power:
        raise EvidenceInvalidError(
            f"evidence validator power {ev.validator_power} != "
            f"actual {val.voting_power}"
        )
    if ev.total_voting_power != valset.total_voting_power():
        raise EvidenceInvalidError(
            f"evidence total power {ev.total_voting_power} != "
            f"actual {valset.total_voting_power()}"
        )

    # Both checks through the batch-verify seam + sigcache at evidence
    # priority: the two signatures are submitted together so they ride one
    # scheduler flush, one kernel launch (or resolve from verdicts cached
    # at gossip time — vote A usually IS the vote the node already
    # admitted).  On the card the gate is opened first (the batch seam's
    # self-check, once per process; it raises with no card), so the pair
    # never falls through to a host verify.
    from cometbft_tpu_torch import verifysched

    pubs = [val.pub_key, val.pub_key]
    msgs = [a.sign_bytes(chain_id), b.sign_bytes(chain_id)]
    sigs = [a.signature, b.signature]
    if _on_host(device) and not verifysched.on_gate_device(device):
        ok_a, ok_b = (verifysched.verify_now(*t) for t in zip(pubs, msgs, sigs))
    else:
        if not _on_host(device):
            from cometbft_tpu_torch.crypto import batch as cbatch

            cbatch.default_backend()
        ok_a, ok_b = verifysched.verify_many_cached(
            pubs, msgs, sigs, priority=verifysched.PRIO_EVIDENCE
        )
    if not ok_a:
        raise EvidenceInvalidError("invalid signature on vote A")
    if not ok_b:
        raise EvidenceInvalidError("invalid signature on vote B")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    chain_id: str,
    common_vals,
    trusted_header,
    device=None,
) -> None:
    """Reference: internal/evidence/verify.go:110 VerifyLightClientAttack.

    The conflicting block must be signed by >1/3 of the validator set at the
    common height (lunatic attack), or — when common height equals the
    conflicting height — by +2/3 of that height's set (equivocation /
    amnesia).  Commit verification routes through the batch seam.
    """
    err = ev.conflicting_block.validate_basic(chain_id)
    if err:
        raise EvidenceInvalidError(f"invalid conflicting block: {err}")

    sh = ev.conflicting_block.signed_header
    # evidence priority class: the conflicting commit's signature batch
    # goes through the shared verify scheduler (via the batch-verifier
    # seam) below consensus votes but above bulk catchup traffic
    from cometbft_tpu_torch import verifysched

    if ev.common_height < sh.header.height:
        # lunatic: >1/3 of common valset signed the conflicting header
        try:
            with verifysched.priority_class(verifysched.PRIO_EVIDENCE):
                validation.verify_commit_light_trusting(
                    chain_id,
                    common_vals,
                    sh.commit,
                    trust_level=Fraction(1, 3),
                    device=device,
                )
        except validation.CommitVerificationError as e:
            raise EvidenceInvalidError(
                f"conflicting block not signed by 1/3+ of common set: {e}"
            ) from e
    else:
        # equivocation at the same height: full commit check against the
        # conflicting block's own (claimed) validator set
        try:
            with verifysched.priority_class(verifysched.PRIO_EVIDENCE):
                validation.verify_commit_light(
                    chain_id,
                    ev.conflicting_block.validator_set,
                    sh.commit.block_id,
                    sh.header.height,
                    sh.commit,
                    device=device,
                )
        except validation.CommitVerificationError as e:
            raise EvidenceInvalidError(
                f"conflicting block commit invalid: {e}"
            ) from e

    if trusted_header is not None:
        if trusted_header.hash() == sh.header.hash():
            raise EvidenceInvalidError(
                "conflicting block is identical to the committed block"
            )
        if (
            trusted_header.height == sh.header.height
            and trusted_header.time.to_ns() < sh.header.time.to_ns()
        ):
            # invalid: conflicting header from the future of the real one
            raise EvidenceInvalidError(
                "conflicting block time is after the trusted block time"
            )

    expected = byzantine_validators(ev, common_vals, trusted_header)
    got = {v.address for v in ev.byzantine_validators}
    want = {v.address for v in expected}
    if got != want:
        raise EvidenceInvalidError(
            "evidence byzantine validators do not match computed set"
        )
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceInvalidError(
            f"evidence total power {ev.total_voting_power} != "
            f"common set {common_vals.total_voting_power()}"
        )


def byzantine_validators(
    ev: LightClientAttackEvidence, common_vals, trusted_header
):
    """Validators culpable for the attack (reference: types/evidence.go
    GetByzantineValidators): for a lunatic attack, members of the common set
    who signed the conflicting block; for equivocation, every signer of the
    conflicting commit (they double-signed at that height)."""
    sh = ev.conflicting_block.signed_header
    out = []
    if trusted_header is None or ev.conflicting_header_is_invalid(
        trusted_header
    ):
        # lunatic: blame common-set members who signed
        for idx, cs in enumerate(sh.commit.signatures):
            if not cs.for_block():
                continue
            found = common_vals.get_by_address(cs.validator_address)
            if found is not None:
                out.append(found[1])
    elif trusted_header.height == sh.header.height:
        # equivocation: every conflicting-commit signer double-signed
        for idx, cs in enumerate(sh.commit.signatures):
            if not cs.for_block():
                continue
            found = ev.conflicting_block.validator_set.get_by_address(
                cs.validator_address
            )
            if found is not None:
                out.append(found[1])
    # amnesia (same valset, different round): no individual attribution
    return out
