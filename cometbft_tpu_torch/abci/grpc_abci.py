"""gRPC flavor of the ABCI boundary (reference: abci/client/grpc_client.go,
abci/server/grpc_server.go).

Serves/speaks the real ``cometbft.abci.v1.ABCIService`` protobuf schema
(proto/cometbft/abci/v1/service.proto — wire-compatible with the
reference), translating to/from this framework's internal ABCI dataclasses
(``abci.types``).  An application written against the reference's gRPC
ABCI contract can be driven by this node, and this node's proxy can drive
a remote reference-style gRPC app.

The port's copy of the JAX package's ``abci/grpc_abci.py``, on the port's
own generated modules: a port client and a JAX server (or the other way
round) exchange the same messages.  ``proxy/multi_app_conn`` imports it
only for the gRPC transport; it needs ``grpc`` and ``google.protobuf``.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Callable, Optional

from cometbft_tpu_torch.proto_gen.cometbft.abci.v1 import types_pb2 as pb

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.abci.application import Application
from cometbft_tpu_torch.abci.client import Client
from cometbft_tpu_torch.rpc.pb_convert import (
    event_pb as _event_to_pb,
    exec_tx_result_pb as _tx_result_to_pb,
    params_from_pb as _params_from_pb,
    params_to_pb as _params_to_pb,
    validator_update_pb as _vu_to_pb,
)

_SERVICE = "cometbft.abci.v1.ABCIService"

_NS = 1_000_000_000


# ---------------------------------------------------------------------------
# protobuf messages -> internal dataclasses (the to-pb direction is shared
# with the gRPC node services via rpc.pb_convert).
# ---------------------------------------------------------------------------

def _ts_to_ns(ts) -> int:
    return ts.seconds * _NS + ts.nanos


def _ns_to_ts(pb_ts, ns: int) -> None:
    pb_ts.seconds = ns // _NS
    pb_ts.nanos = ns % _NS


def _event_from_pb(e) -> at.Event:
    return at.Event(
        type_=e.type,
        attributes=[
            at.EventAttribute(key=a.key, value=a.value, index=a.index)
            for a in e.attributes
        ],
    )




def _tx_result_from_pb(r) -> at.ExecTxResult:
    return at.ExecTxResult(
        code=r.code,
        data=r.data,
        log=r.log,
        info=r.info,
        gas_wanted=r.gas_wanted,
        gas_used=r.gas_used,
        events=[_event_from_pb(e) for e in r.events],
        codespace=r.codespace,
    )




def _vu_from_pb(v) -> at.ValidatorUpdate:
    return at.ValidatorUpdate(
        power=v.power, pub_key_bytes=v.pub_key_bytes, pub_key_type=v.pub_key_type
    )


def _commit_info_to_pb(ci: at.CommitInfo) -> pb.CommitInfo:
    out = pb.CommitInfo(round=ci.round_)
    for v in ci.votes:
        vi = out.votes.add()
        vi.validator.address = v.validator.address
        vi.validator.power = v.validator.power
        vi.block_id_flag = v.block_id_flag
    return out


def _commit_info_from_pb(ci) -> at.CommitInfo:
    return at.CommitInfo(
        round_=ci.round,
        votes=[
            at.VoteInfo(
                validator=at.Validator(
                    address=v.validator.address, power=v.validator.power
                ),
                block_id_flag=v.block_id_flag,
            )
            for v in ci.votes
        ],
    )


def _ext_commit_info_to_pb(ci: at.ExtendedCommitInfo) -> pb.ExtendedCommitInfo:
    out = pb.ExtendedCommitInfo(round=ci.round_)
    for v in ci.votes:
        vi = out.votes.add()
        vi.validator.address = v.validator.address
        vi.validator.power = v.validator.power
        vi.vote_extension = v.vote_extension
        vi.extension_signature = v.extension_signature
        vi.block_id_flag = v.block_id_flag
    return out


def _ext_commit_info_from_pb(ci) -> at.ExtendedCommitInfo:
    return at.ExtendedCommitInfo(
        round_=ci.round,
        votes=[
            at.ExtendedVoteInfo(
                validator=at.Validator(
                    address=v.validator.address, power=v.validator.power
                ),
                vote_extension=v.vote_extension,
                extension_signature=v.extension_signature,
                block_id_flag=v.block_id_flag,
            )
            for v in ci.votes
        ],
    )


def _misb_to_pb(m: at.Misbehavior) -> pb.Misbehavior:
    out = pb.Misbehavior(
        type=m.type_,
        height=m.height,
        total_voting_power=m.total_voting_power,
    )
    out.validator.address = m.validator.address
    out.validator.power = m.validator.power
    _ns_to_ts(out.time, m.time_unix_ns)
    return out


def _misb_from_pb(m) -> at.Misbehavior:
    return at.Misbehavior(
        type_=m.type,
        validator=at.Validator(
            address=m.validator.address, power=m.validator.power
        ),
        height=m.height,
        time_unix_ns=_ts_to_ns(m.time),
        total_voting_power=m.total_voting_power,
    )


def _snapshot_to_pb(s: at.Snapshot) -> pb.Snapshot:
    return pb.Snapshot(
        height=s.height,
        format=s.format,
        chunks=s.chunks,
        hash=s.hash,
        metadata=s.metadata,
    )


def _snapshot_from_pb(s) -> at.Snapshot:
    return at.Snapshot(
        height=s.height,
        format=s.format,
        chunks=s.chunks,
        hash=s.hash,
        metadata=s.metadata,
    )


class GRPCABCIServer:
    """Reference: abci/server/grpc_server.go."""

    def __init__(self, app: Application, address: str):
        import grpc

        self.app = app
        self._lock = threading.Lock()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))

        def locked(fn: Callable) -> Callable:
            def wrapped(request, context):
                with self._lock:
                    return fn(request, context)

            return wrapped

        def echo(request, context):
            return pb.EchoResponse(message=request.message)

        def flush(request, context):
            return pb.FlushResponse()

        def info(request, context):
            r = self.app.info(
                at.InfoRequest(
                    version=request.version,
                    block_version=request.block_version,
                    p2p_version=request.p2p_version,
                    abci_version=request.abci_version,
                )
            )
            out = pb.InfoResponse(
                data=r.data,
                version=r.version,
                app_version=r.app_version,
                last_block_height=r.last_block_height,
                last_block_app_hash=r.last_block_app_hash,
                default_lane=r.default_lane,
            )
            for k, v in r.lane_priorities.items():
                out.lane_priorities[k] = v
            return out

        def check_tx(request, context):
            r = self.app.check_tx(
                at.CheckTxRequest(tx=request.tx, type_=request.type)
            )
            out = pb.CheckTxResponse(
                code=r.code,
                data=r.data,
                log=r.log,
                info=r.info,
                gas_wanted=r.gas_wanted,
                gas_used=r.gas_used,
                codespace=r.codespace,
            )
            for e in r.events:
                out.events.add().CopyFrom(_event_to_pb(e))
            return out

        def query(request, context):
            r = self.app.query(
                at.QueryRequest(
                    data=request.data,
                    path=request.path,
                    height=request.height,
                    prove=request.prove,
                )
            )
            return pb.QueryResponse(
                code=r.code,
                log=r.log,
                info=r.info,
                index=r.index,
                key=r.key,
                value=r.value,
                height=r.height,
                codespace=r.codespace,
            )

        def commit(request, context):
            r = self.app.commit(at.CommitRequest())
            return pb.CommitResponse(retain_height=r.retain_height)

        def init_chain(request, context):
            r = self.app.init_chain(
                at.InitChainRequest(
                    time_unix_ns=_ts_to_ns(request.time),
                    chain_id=request.chain_id,
                    consensus_params=_params_from_pb(
                        request.consensus_params
                        if request.HasField("consensus_params")
                        else None
                    ),
                    validators=[_vu_from_pb(v) for v in request.validators],
                    app_state_bytes=request.app_state_bytes,
                    initial_height=request.initial_height,
                )
            )
            out = pb.InitChainResponse(app_hash=r.app_hash)
            for v in r.validators:
                out.validators.add().CopyFrom(_vu_to_pb(v))
            _params_to_pb(out.consensus_params, r.consensus_params)
            return out

        def list_snapshots(request, context):
            r = self.app.list_snapshots(at.ListSnapshotsRequest())
            out = pb.ListSnapshotsResponse()
            for s in r.snapshots:
                out.snapshots.add().CopyFrom(_snapshot_to_pb(s))
            return out

        def offer_snapshot(request, context):
            r = self.app.offer_snapshot(
                at.OfferSnapshotRequest(
                    snapshot=_snapshot_from_pb(request.snapshot),
                    app_hash=request.app_hash,
                )
            )
            return pb.OfferSnapshotResponse(result=r.result)

        def load_snapshot_chunk(request, context):
            r = self.app.load_snapshot_chunk(
                at.LoadSnapshotChunkRequest(
                    height=request.height,
                    format=request.format,
                    chunk=request.chunk,
                )
            )
            return pb.LoadSnapshotChunkResponse(chunk=r.chunk)

        def apply_snapshot_chunk(request, context):
            r = self.app.apply_snapshot_chunk(
                at.ApplySnapshotChunkRequest(
                    index=request.index,
                    chunk=request.chunk,
                    sender=request.sender,
                )
            )
            return pb.ApplySnapshotChunkResponse(
                result=r.result,
                refetch_chunks=list(r.refetch_chunks),
                reject_senders=list(r.reject_senders),
            )

        def prepare_proposal(request, context):
            r = self.app.prepare_proposal(
                at.PrepareProposalRequest(
                    max_tx_bytes=request.max_tx_bytes,
                    txs=list(request.txs),
                    local_last_commit=_ext_commit_info_from_pb(
                        request.local_last_commit
                    ),
                    misbehavior=[_misb_from_pb(m) for m in request.misbehavior],
                    height=request.height,
                    time_unix_ns=_ts_to_ns(request.time),
                    next_validators_hash=request.next_validators_hash,
                    proposer_address=request.proposer_address,
                )
            )
            return pb.PrepareProposalResponse(txs=list(r.txs))

        def process_proposal(request, context):
            r = self.app.process_proposal(
                at.ProcessProposalRequest(
                    txs=list(request.txs),
                    proposed_last_commit=_commit_info_from_pb(
                        request.proposed_last_commit
                    ),
                    misbehavior=[_misb_from_pb(m) for m in request.misbehavior],
                    hash=request.hash,
                    height=request.height,
                    time_unix_ns=_ts_to_ns(request.time),
                    next_validators_hash=request.next_validators_hash,
                    proposer_address=request.proposer_address,
                )
            )
            return pb.ProcessProposalResponse(status=r.status)

        def extend_vote(request, context):
            r = self.app.extend_vote(
                at.ExtendVoteRequest(
                    hash=request.hash,
                    height=request.height,
                    txs=list(request.txs),
                    proposed_last_commit=_commit_info_from_pb(
                        request.proposed_last_commit
                    ),
                    misbehavior=[_misb_from_pb(m) for m in request.misbehavior],
                    next_validators_hash=request.next_validators_hash,
                    proposer_address=request.proposer_address,
                    time_unix_ns=_ts_to_ns(request.time),
                )
            )
            return pb.ExtendVoteResponse(vote_extension=r.vote_extension)

        def verify_vote_extension(request, context):
            r = self.app.verify_vote_extension(
                at.VerifyVoteExtensionRequest(
                    hash=request.hash,
                    validator_address=request.validator_address,
                    height=request.height,
                    vote_extension=request.vote_extension,
                )
            )
            return pb.VerifyVoteExtensionResponse(status=r.status)

        def finalize_block(request, context):
            r = self.app.finalize_block(
                at.FinalizeBlockRequest(
                    txs=list(request.txs),
                    decided_last_commit=_commit_info_from_pb(
                        request.decided_last_commit
                    ),
                    misbehavior=[_misb_from_pb(m) for m in request.misbehavior],
                    hash=request.hash,
                    height=request.height,
                    time_unix_ns=_ts_to_ns(request.time),
                    next_validators_hash=request.next_validators_hash,
                    proposer_address=request.proposer_address,
                    syncing_to_height=request.syncing_to_height,
                )
            )
            out = pb.FinalizeBlockResponse(app_hash=r.app_hash)
            for e in r.events:
                out.events.add().CopyFrom(_event_to_pb(e))
            for t in r.tx_results:
                out.tx_results.add().CopyFrom(_tx_result_to_pb(t))
            for v in r.validator_updates:
                out.validator_updates.add().CopyFrom(_vu_to_pb(v))
            _params_to_pb(
                out.consensus_param_updates, r.consensus_param_updates
            )
            delay_ns = r.next_block_delay_ms * 1_000_000
            out.next_block_delay.seconds = delay_ns // _NS
            out.next_block_delay.nanos = delay_ns % _NS
            return out

        methods = {
            "Echo": (echo, pb.EchoRequest, pb.EchoResponse),
            "Flush": (flush, pb.FlushRequest, pb.FlushResponse),
            "Info": (info, pb.InfoRequest, pb.InfoResponse),
            "CheckTx": (check_tx, pb.CheckTxRequest, pb.CheckTxResponse),
            "Query": (query, pb.QueryRequest, pb.QueryResponse),
            "Commit": (commit, pb.CommitRequest, pb.CommitResponse),
            "InitChain": (init_chain, pb.InitChainRequest, pb.InitChainResponse),
            "ListSnapshots": (
                list_snapshots,
                pb.ListSnapshotsRequest,
                pb.ListSnapshotsResponse,
            ),
            "OfferSnapshot": (
                offer_snapshot,
                pb.OfferSnapshotRequest,
                pb.OfferSnapshotResponse,
            ),
            "LoadSnapshotChunk": (
                load_snapshot_chunk,
                pb.LoadSnapshotChunkRequest,
                pb.LoadSnapshotChunkResponse,
            ),
            "ApplySnapshotChunk": (
                apply_snapshot_chunk,
                pb.ApplySnapshotChunkRequest,
                pb.ApplySnapshotChunkResponse,
            ),
            "PrepareProposal": (
                prepare_proposal,
                pb.PrepareProposalRequest,
                pb.PrepareProposalResponse,
            ),
            "ProcessProposal": (
                process_proposal,
                pb.ProcessProposalRequest,
                pb.ProcessProposalResponse,
            ),
            "ExtendVote": (
                extend_vote,
                pb.ExtendVoteRequest,
                pb.ExtendVoteResponse,
            ),
            "VerifyVoteExtension": (
                verify_vote_extension,
                pb.VerifyVoteExtensionRequest,
                pb.VerifyVoteExtensionResponse,
            ),
            "FinalizeBlock": (
                finalize_block,
                pb.FinalizeBlockRequest,
                pb.FinalizeBlockResponse,
            ),
        }
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                locked(fn),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
            for name, (fn, req_cls, resp_cls) in methods.items()
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        addr = address.replace("tcp://", "").replace("grpc://", "")
        self.bound_port = self._server.add_insecure_port(addr)

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)


# ---------------------------------------------------------------------------
# Client: drive a remote gRPC ABCI app through the internal Client API.
# ---------------------------------------------------------------------------

class GRPCClient(Client):
    """Reference: abci/client/grpc_client.go — the node-side proxy client
    for applications served over gRPC."""

    def __init__(self, address: str, timeout: float = 10.0):
        import grpc

        self._timeout = timeout
        target = address.replace("tcp://", "").replace("grpc://", "")
        self._channel = grpc.insecure_channel(target)
        self._grpc = grpc
        # bounded pool for the async CheckTx contract — the mempool fires
        # thousands/s; per-call threads would be unbounded
        self._pool = futures.ThreadPoolExecutor(max_workers=4)

    def _unary(self, method: str, request, resp_cls):
        callable_ = self._channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString,
        )
        return callable_(request, timeout=self._timeout)

    def echo(self, message: str) -> at.EchoResponse:
        r = self._unary("Echo", pb.EchoRequest(message=message), pb.EchoResponse)
        return at.EchoResponse(message=r.message)

    def flush(self) -> None:
        self._unary("Flush", pb.FlushRequest(), pb.FlushResponse)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._channel.close()

    def check_tx_async(self, req: at.CheckTxRequest, cb: Callable) -> None:
        # grpc pipelines internally; the pool keeps the async contract
        # (mempool CheckTx callbacks) without unbounded threads
        self._pool.submit(lambda: cb(self.call("check_tx", req)))

    def check_txs(
        self, reqs: "list[at.CheckTxRequest]"
    ) -> "list[at.CheckTxResponse]":
        # The gRPC ABCI service mirrors the reference proto, which has no
        # CheckTxs RPC — batched admission (docs/tx-ingest.md) degrades to
        # per-tx unary calls here (HTTP/2 pipelines them on one channel);
        # only the socket and local clients collapse the round trips.
        return [self.call("check_tx", r) for r in reqs]

    def call(self, method: str, req) -> object:
        if method == "info":
            r = self._unary(
                "Info",
                pb.InfoRequest(
                    version=req.version,
                    block_version=req.block_version,
                    p2p_version=getattr(req, "p2p_version", 0),
                    abci_version=req.abci_version,
                ),
                pb.InfoResponse,
            )
            return at.InfoResponse(
                data=r.data,
                version=r.version,
                app_version=r.app_version,
                last_block_height=r.last_block_height,
                last_block_app_hash=r.last_block_app_hash,
                lane_priorities=dict(r.lane_priorities),
                default_lane=r.default_lane,
            )
        if method == "query":
            r = self._unary(
                "Query",
                pb.QueryRequest(
                    data=req.data,
                    path=req.path,
                    height=req.height,
                    prove=req.prove,
                ),
                pb.QueryResponse,
            )
            return at.QueryResponse(
                code=r.code,
                log=r.log,
                info=r.info,
                index=r.index,
                key=r.key,
                value=r.value,
                height=r.height,
                codespace=r.codespace,
            )
        if method == "check_tx":
            r = self._unary(
                "CheckTx",
                pb.CheckTxRequest(tx=req.tx, type=req.type_),
                pb.CheckTxResponse,
            )
            return at.CheckTxResponse(
                code=r.code,
                data=r.data,
                log=r.log,
                info=r.info,
                gas_wanted=r.gas_wanted,
                gas_used=r.gas_used,
                events=[_event_from_pb(e) for e in r.events],
                codespace=r.codespace,
            )
        if method == "init_chain":
            msg = pb.InitChainRequest(
                chain_id=req.chain_id,
                app_state_bytes=req.app_state_bytes,
                initial_height=req.initial_height,
            )
            _ns_to_ts(msg.time, req.time_unix_ns)
            for v in req.validators:
                msg.validators.add().CopyFrom(_vu_to_pb(v))
            _params_to_pb(msg.consensus_params, req.consensus_params)
            r = self._unary("InitChain", msg, pb.InitChainResponse)
            return at.InitChainResponse(
                consensus_params=_params_from_pb(
                    r.consensus_params
                    if r.HasField("consensus_params")
                    else None
                ),
                validators=[_vu_from_pb(v) for v in r.validators],
                app_hash=r.app_hash,
            )
        if method == "prepare_proposal":
            msg = pb.PrepareProposalRequest(
                max_tx_bytes=req.max_tx_bytes,
                txs=list(req.txs),
                height=req.height,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
            )
            msg.local_last_commit.CopyFrom(
                _ext_commit_info_to_pb(req.local_last_commit)
            )
            for m in req.misbehavior:
                msg.misbehavior.add().CopyFrom(_misb_to_pb(m))
            _ns_to_ts(msg.time, req.time_unix_ns)
            r = self._unary("PrepareProposal", msg, pb.PrepareProposalResponse)
            return at.PrepareProposalResponse(txs=list(r.txs))
        if method == "process_proposal":
            msg = pb.ProcessProposalRequest(
                txs=list(req.txs),
                hash=req.hash,
                height=req.height,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
            )
            msg.proposed_last_commit.CopyFrom(
                _commit_info_to_pb(req.proposed_last_commit)
            )
            for m in req.misbehavior:
                msg.misbehavior.add().CopyFrom(_misb_to_pb(m))
            _ns_to_ts(msg.time, req.time_unix_ns)
            r = self._unary("ProcessProposal", msg, pb.ProcessProposalResponse)
            return at.ProcessProposalResponse(status=r.status)
        if method == "extend_vote":
            msg = pb.ExtendVoteRequest(
                hash=req.hash,
                height=req.height,
                txs=list(req.txs),
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
            )
            msg.proposed_last_commit.CopyFrom(
                _commit_info_to_pb(req.proposed_last_commit)
            )
            for m in req.misbehavior:
                msg.misbehavior.add().CopyFrom(_misb_to_pb(m))
            _ns_to_ts(msg.time, req.time_unix_ns)
            r = self._unary("ExtendVote", msg, pb.ExtendVoteResponse)
            return at.ExtendVoteResponse(vote_extension=r.vote_extension)
        if method == "verify_vote_extension":
            r = self._unary(
                "VerifyVoteExtension",
                pb.VerifyVoteExtensionRequest(
                    hash=req.hash,
                    validator_address=req.validator_address,
                    height=req.height,
                    vote_extension=req.vote_extension,
                ),
                pb.VerifyVoteExtensionResponse,
            )
            return at.VerifyVoteExtensionResponse(status=r.status)
        if method == "finalize_block":
            msg = pb.FinalizeBlockRequest(
                txs=list(req.txs),
                hash=req.hash,
                height=req.height,
                next_validators_hash=req.next_validators_hash,
                proposer_address=req.proposer_address,
                syncing_to_height=req.syncing_to_height,
            )
            msg.decided_last_commit.CopyFrom(
                _commit_info_to_pb(req.decided_last_commit)
            )
            for m in req.misbehavior:
                msg.misbehavior.add().CopyFrom(_misb_to_pb(m))
            _ns_to_ts(msg.time, req.time_unix_ns)
            r = self._unary("FinalizeBlock", msg, pb.FinalizeBlockResponse)
            delay_ns = r.next_block_delay.seconds * _NS + r.next_block_delay.nanos
            return at.FinalizeBlockResponse(
                events=[_event_from_pb(e) for e in r.events],
                tx_results=[_tx_result_from_pb(t) for t in r.tx_results],
                validator_updates=[_vu_from_pb(v) for v in r.validator_updates],
                consensus_param_updates=_params_from_pb(
                    r.consensus_param_updates
                    if r.HasField("consensus_param_updates")
                    else None
                ),
                app_hash=r.app_hash,
                next_block_delay_ms=delay_ns // 1_000_000,
            )
        if method == "commit":
            r = self._unary("Commit", pb.CommitRequest(), pb.CommitResponse)
            return at.CommitResponse(retain_height=r.retain_height)
        if method == "list_snapshots":
            r = self._unary(
                "ListSnapshots",
                pb.ListSnapshotsRequest(),
                pb.ListSnapshotsResponse,
            )
            return at.ListSnapshotsResponse(
                snapshots=[_snapshot_from_pb(s) for s in r.snapshots]
            )
        if method == "offer_snapshot":
            msg = pb.OfferSnapshotRequest(app_hash=req.app_hash)
            msg.snapshot.CopyFrom(_snapshot_to_pb(req.snapshot))
            r = self._unary("OfferSnapshot", msg, pb.OfferSnapshotResponse)
            return at.OfferSnapshotResponse(result=r.result)
        if method == "load_snapshot_chunk":
            r = self._unary(
                "LoadSnapshotChunk",
                pb.LoadSnapshotChunkRequest(
                    height=req.height, format=req.format, chunk=req.chunk
                ),
                pb.LoadSnapshotChunkResponse,
            )
            return at.LoadSnapshotChunkResponse(chunk=r.chunk)
        if method == "apply_snapshot_chunk":
            r = self._unary(
                "ApplySnapshotChunk",
                pb.ApplySnapshotChunkRequest(
                    index=req.index, chunk=req.chunk, sender=req.sender
                ),
                pb.ApplySnapshotChunkResponse,
            )
            return at.ApplySnapshotChunkResponse(
                result=r.result,
                refetch_chunks=list(r.refetch_chunks),
                reject_senders=list(r.reject_senders),
            )
        raise ValueError(f"unknown ABCI method: {method}")
