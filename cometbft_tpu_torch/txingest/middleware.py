"""``SigVerifyingApp`` — ABCI middleware hoisting tx signature checks
out of the application and onto the crypto seam (docs/tx-ingest.md).

Wrap any ``Application`` and the app stops caring about envelopes: the
middleware verifies signed-tx envelopes (``txingest/envelope.py``) on the
mempool and consensus connections and hands the *payload* to the inner
app, so a kvstore that understands ``key=value`` serves signed traffic
unchanged.  Verification rides the shared batch machinery —
``check_txs`` verifies a whole gossip burst's signatures in one pass
through the verifysched bulk class, and because every verdict goes
through the signature cache the apply-time re-checks (process-proposal,
finalize) resolve from cache instead of paying a second verification.

The middleware advertises itself via ``InfoResponse.envelope_sig_verified``
so the ingest coalescer knows it may pre-verify envelope signatures
node-side and reject forgeries with the SAME canonical codes before any
app round trip (the differential-parity contract both layers share).

``device=None`` means the card, as for every port entry point: built
with no card the middleware raises unless the caller names the CPU
(``device="cpu"`` or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``); on the card it
resolves the batch backend when it is built, so that ``verify_envelopes``
goes through the verify scheduler and the Ed25519 kernel.  A batch the
kernel did not serve raises ``BackendError`` out of the call.
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.abci.application import Application
from cometbft_tpu_torch.txingest import envelope as ev


class SigVerifyingApp(Application):
    """Envelope-verifying wrapper around an inner ``Application``.

    ``require_envelope=True`` additionally rejects plain (non-envelope)
    txs at CheckTx — for chains where every user tx must be signed;
    the default passes plain txs through untouched so the wrapper can be
    dropped in front of existing traffic.
    """

    def __init__(self, app: Application, require_envelope: bool = False,
                 device=None):
        from cometbft_tpu_torch.types.validation import entry_device

        self.device = entry_device(device)
        self.app = app
        self.require_envelope = require_envelope

    # -- classification -----------------------------------------------------

    @staticmethod
    def _classify(tx: bytes):
        """('plain', None) | ('env', Envelope) | ('bad', reason)."""
        if not ev.is_envelope(tx):
            return "plain", None
        try:
            return "env", ev.decode(tx)
        except ev.EnvelopeError as e:
            return "bad", str(e)

    def _payload_or_reject(
        self, tx: bytes, verified: Optional[bool] = None
    ) -> "tuple[Optional[bytes], Optional[at.CheckTxResponse]]":
        """The inner-app payload for ``tx``, or the canonical rejection.
        ``verified`` carries a batch-verification verdict when the caller
        already has one; ``None`` means verify here (cache-through)."""
        kind, parsed = self._classify(tx)
        if kind == "bad":
            return None, ev.reject_bad_envelope(parsed)
        if kind == "plain":
            if self.require_envelope:
                return None, ev.reject_bad_envelope("envelope required")
            return tx, None
        if verified is None:
            verified = ev.verify_envelopes([parsed])[0]
        if not verified:
            return None, ev.reject_bad_signature()
        return parsed.payload, None

    # -- info ---------------------------------------------------------------

    def info(self, req):
        r = self.app.info(req)
        r.envelope_sig_verified = True
        return r

    # -- mempool connection -------------------------------------------------

    def check_tx(self, req):
        payload, reject = self._payload_or_reject(req.tx)
        if reject is not None:
            return reject
        return self.app.check_tx(at.CheckTxRequest(tx=payload, type_=req.type_))

    def check_txs(self, req):
        """One signature pass for the whole batch, then one inner-app
        batch for the survivors — the round-trip shape batched admission
        exists for."""
        kinds = [self._classify(r.tx) for r in req.requests]
        verdicts = ev.verify_envelopes(
            [p if k == "env" else None for k, p in kinds]
        )
        out: "list[Optional[at.CheckTxResponse]]" = [None] * len(req.requests)
        inner: "list[at.CheckTxRequest]" = []
        inner_ix: "list[int]" = []
        for i, (r, (kind, parsed)) in enumerate(zip(req.requests, kinds)):
            if kind == "bad":
                out[i] = ev.reject_bad_envelope(parsed)
            elif kind == "plain":
                if self.require_envelope:
                    out[i] = ev.reject_bad_envelope("envelope required")
                else:
                    inner.append(r)
                    inner_ix.append(i)
            elif not verdicts[i]:
                out[i] = ev.reject_bad_signature()
            else:
                inner.append(
                    at.CheckTxRequest(tx=parsed.payload, type_=r.type_)
                )
                inner_ix.append(i)
        if inner:
            resp = self.app.check_txs(at.CheckTxsRequest(requests=inner))
            for i, r in zip(inner_ix, resp.responses):
                out[i] = r
        return at.CheckTxsResponse(responses=out)

    # -- consensus connection -----------------------------------------------

    def prepare_proposal(self, req):
        """The inner app selects/orders payloads; selections map back to
        their envelope bytes (a payload appearing in several envelopes
        maps in arrival order).  Payloads the inner app invented — it may
        inject its own txs — pass through unwrapped."""
        payloads: "list[bytes]" = []
        by_payload: "dict[bytes, list[bytes]]" = {}
        for tx in req.txs:
            kind, parsed = self._classify(tx)
            if kind == "env":
                payloads.append(parsed.payload)
                by_payload.setdefault(parsed.payload, []).append(tx)
            else:
                # bad envelopes stay as raw bytes: the inner app sees the
                # same txs FinalizeBlock would, and drops what it can't parse
                payloads.append(tx)
        inner = self.app.prepare_proposal(
            at.PrepareProposalRequest(
                max_tx_bytes=req.max_tx_bytes,
                txs=payloads,
                local_last_commit=req.local_last_commit,
                misbehavior=req.misbehavior,
                height=req.height,
                time_unix_ns=req.time_unix_ns,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
            )
        )
        out = []
        for tx in inner.txs:
            wrapped = by_payload.get(tx)
            out.append(wrapped.pop(0) if wrapped else tx)
        return at.PrepareProposalResponse(txs=out)

    def process_proposal(self, req):
        """A block carrying a malformed or forged envelope is rejected
        outright — verification batches through the seam (cache hits when
        CheckTx already saw these txs)."""
        kinds = [self._classify(tx) for tx in req.txs]
        if any(k == "bad" for k, _ in kinds):
            return at.ProcessProposalResponse(status=at.PROPOSAL_STATUS_REJECT)
        if self.require_envelope and any(k == "plain" for k, _ in kinds):
            return at.ProcessProposalResponse(status=at.PROPOSAL_STATUS_REJECT)
        verdicts = ev.verify_envelopes(
            [p if k == "env" else None for k, p in kinds]
        )
        if any(k == "env" and not v for (k, _), v in zip(kinds, verdicts)):
            return at.ProcessProposalResponse(status=at.PROPOSAL_STATUS_REJECT)
        return self.app.process_proposal(
            at.ProcessProposalRequest(
                txs=[
                    p.payload if k == "env" else tx
                    for tx, (k, p) in zip(req.txs, kinds)
                ],
                proposed_last_commit=req.proposed_last_commit,
                misbehavior=req.misbehavior,
                hash=req.hash,
                height=req.height,
                time_unix_ns=req.time_unix_ns,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
            )
        )

    def finalize_block(self, req):
        """Execute payloads.  A decided block can still carry a bad
        envelope (a Byzantine quorum can decide anything); those txs get
        the canonical rejection code as their ExecTxResult and are NEVER
        executed — deterministic across nodes because the verdict depends
        only on the tx bytes."""
        kinds = [self._classify(tx) for tx in req.txs]
        verdicts = ev.verify_envelopes(
            [p if k == "env" else None for k, p in kinds]
        )
        results: "list[Optional[at.ExecTxResult]]" = [None] * len(req.txs)
        inner_txs: "list[bytes]" = []
        inner_ix: "list[int]" = []
        for i, (tx, (kind, parsed)) in enumerate(zip(req.txs, kinds)):
            if kind == "bad":
                results[i] = at.ExecTxResult(
                    code=ev.CODE_BAD_ENVELOPE,
                    log="malformed tx envelope",
                    codespace=ev.CODESPACE,
                )
            elif kind == "plain":
                if self.require_envelope:
                    results[i] = at.ExecTxResult(
                        code=ev.CODE_BAD_ENVELOPE,
                        log="envelope required",
                        codespace=ev.CODESPACE,
                    )
                else:
                    inner_txs.append(tx)
                    inner_ix.append(i)
            elif not verdicts[i]:
                results[i] = at.ExecTxResult(
                    code=ev.CODE_BAD_SIGNATURE,
                    log="invalid tx envelope signature",
                    codespace=ev.CODESPACE,
                )
            else:
                inner_txs.append(parsed.payload)
                inner_ix.append(i)
        inner = self.app.finalize_block(
            at.FinalizeBlockRequest(
                txs=inner_txs,
                decided_last_commit=req.decided_last_commit,
                misbehavior=req.misbehavior,
                hash=req.hash,
                height=req.height,
                time_unix_ns=req.time_unix_ns,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
                syncing_to_height=req.syncing_to_height,
            )
        )
        for i, r in zip(inner_ix, inner.tx_results):
            results[i] = r
        return at.FinalizeBlockResponse(
            events=inner.events,
            tx_results=results,
            validator_updates=inner.validator_updates,
            consensus_param_updates=inner.consensus_param_updates,
            app_hash=inner.app_hash,
            next_block_delay_ms=inner.next_block_delay_ms,
        )

    # -- pure delegation ----------------------------------------------------

    def query(self, req):
        return self.app.query(req)

    def init_chain(self, req):
        return self.app.init_chain(req)

    def extend_vote(self, req):
        return self.app.extend_vote(req)

    def verify_vote_extension(self, req):
        return self.app.verify_vote_extension(req)

    def commit(self, req):
        return self.app.commit(req)

    def list_snapshots(self, req):
        return self.app.list_snapshots(req)

    def offer_snapshot(self, req):
        return self.app.offer_snapshot(req)

    def load_snapshot_chunk(self, req):
        return self.app.load_snapshot_chunk(req)

    def apply_snapshot_chunk(self, req):
        return self.app.apply_snapshot_chunk(req)
