"""The Application interface — the app boundary of the replication engine.

Reference: abci/types/application.go:11-41 (12 methods over 4 logical
connections) and BaseApplication (:48) returning sane defaults so concrete
apps override only what they need.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as at


class Application:
    """Any finite deterministic state machine, driven through ABCI."""

    # Info/Query connection
    def info(self, req: at.InfoRequest) -> at.InfoResponse:
        raise NotImplementedError

    def query(self, req: at.QueryRequest) -> at.QueryResponse:
        raise NotImplementedError

    # Mempool connection
    def check_tx(self, req: at.CheckTxRequest) -> at.CheckTxResponse:
        raise NotImplementedError

    def check_txs(self, req: at.CheckTxsRequest) -> at.CheckTxsResponse:
        """Batched CheckTx (docs/tx-ingest.md): the default loops over
        ``check_tx`` so every app supports the batched mempool connection
        unchanged — overriding is an optimization (e.g. one fused
        signature dispatch per burst), never a semantic change."""
        return at.CheckTxsResponse(
            responses=[self.check_tx(r) for r in req.requests]
        )

    # Consensus connection
    def init_chain(self, req: at.InitChainRequest) -> at.InitChainResponse:
        raise NotImplementedError

    def prepare_proposal(
        self, req: at.PrepareProposalRequest
    ) -> at.PrepareProposalResponse:
        raise NotImplementedError

    def process_proposal(
        self, req: at.ProcessProposalRequest
    ) -> at.ProcessProposalResponse:
        raise NotImplementedError

    def finalize_block(
        self, req: at.FinalizeBlockRequest
    ) -> at.FinalizeBlockResponse:
        raise NotImplementedError

    def extend_vote(self, req: at.ExtendVoteRequest) -> at.ExtendVoteResponse:
        raise NotImplementedError

    def verify_vote_extension(
        self, req: at.VerifyVoteExtensionRequest
    ) -> at.VerifyVoteExtensionResponse:
        raise NotImplementedError

    def commit(self, req: at.CommitRequest) -> at.CommitResponse:
        raise NotImplementedError

    # State-sync connection
    def list_snapshots(
        self, req: at.ListSnapshotsRequest
    ) -> at.ListSnapshotsResponse:
        raise NotImplementedError

    def offer_snapshot(
        self, req: at.OfferSnapshotRequest
    ) -> at.OfferSnapshotResponse:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: at.LoadSnapshotChunkRequest
    ) -> at.LoadSnapshotChunkResponse:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: at.ApplySnapshotChunkRequest
    ) -> at.ApplySnapshotChunkResponse:
        raise NotImplementedError


class BaseApplication(Application):
    """Default no-op implementations (reference: application.go:48-116)."""

    def info(self, req):
        return at.InfoResponse()

    def query(self, req):
        return at.QueryResponse(code=at.CODE_TYPE_OK)

    def check_tx(self, req):
        return at.CheckTxResponse(code=at.CODE_TYPE_OK)

    def init_chain(self, req):
        return at.InitChainResponse()

    def prepare_proposal(self, req):
        # Default: include txs up to the byte limit, in order.
        txs, total = [], 0
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes and total > req.max_tx_bytes:
                break
            txs.append(tx)
        return at.PrepareProposalResponse(txs=txs)

    def process_proposal(self, req):
        return at.ProcessProposalResponse(status=at.PROPOSAL_STATUS_ACCEPT)

    def finalize_block(self, req):
        return at.FinalizeBlockResponse(
            tx_results=[at.ExecTxResult() for _ in req.txs]
        )

    def extend_vote(self, req):
        return at.ExtendVoteResponse()

    def verify_vote_extension(self, req):
        return at.VerifyVoteExtensionResponse(
            status=at.VERIFY_VOTE_EXTENSION_ACCEPT
        )

    def commit(self, req):
        return at.CommitResponse()

    def list_snapshots(self, req):
        return at.ListSnapshotsResponse()

    def offer_snapshot(self, req):
        return at.OfferSnapshotResponse()

    def load_snapshot_chunk(self, req):
        return at.LoadSnapshotChunkResponse()

    def apply_snapshot_chunk(self, req):
        return at.ApplySnapshotChunkResponse(
            result=at.APPLY_SNAPSHOT_CHUNK_ACCEPT
        )
