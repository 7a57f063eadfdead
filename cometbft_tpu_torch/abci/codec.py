"""Wire codec for the ABCI socket protocol.

Reference framing: varint length-prefixed protobuf Request/Response
(abci/client/socket_client.go, protoio).  Here the frame is the same
varint-length prefix (cometbft_tpu_torch.libs.protoenc.uvarint) around a JSON
envelope ``{"m": method, "b": body}`` with bytes fields base64-encoded —
the dataclasses in abci/types.py are the schema.  Dataclass <-> JSON uses
type hints, so the codec needs no per-message code.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import typing

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import protoenc as pe

_REQ_TYPES = {
    "echo": at.EchoRequest,
    "info": at.InfoRequest,
    "query": at.QueryRequest,
    "check_tx": at.CheckTxRequest,
    "check_txs": at.CheckTxsRequest,
    "init_chain": at.InitChainRequest,
    "prepare_proposal": at.PrepareProposalRequest,
    "process_proposal": at.ProcessProposalRequest,
    "finalize_block": at.FinalizeBlockRequest,
    "extend_vote": at.ExtendVoteRequest,
    "verify_vote_extension": at.VerifyVoteExtensionRequest,
    "commit": at.CommitRequest,
    "list_snapshots": at.ListSnapshotsRequest,
    "offer_snapshot": at.OfferSnapshotRequest,
    "load_snapshot_chunk": at.LoadSnapshotChunkRequest,
    "apply_snapshot_chunk": at.ApplySnapshotChunkRequest,
}

_RESP_TYPES = {
    "echo": at.EchoResponse,
    "info": at.InfoResponse,
    "query": at.QueryResponse,
    "check_tx": at.CheckTxResponse,
    "check_txs": at.CheckTxsResponse,
    "init_chain": at.InitChainResponse,
    "prepare_proposal": at.PrepareProposalResponse,
    "process_proposal": at.ProcessProposalResponse,
    "finalize_block": at.FinalizeBlockResponse,
    "extend_vote": at.ExtendVoteResponse,
    "verify_vote_extension": at.VerifyVoteExtensionResponse,
    "commit": at.CommitResponse,
    "list_snapshots": at.ListSnapshotsResponse,
    "offer_snapshot": at.OfferSnapshotResponse,
    "load_snapshot_chunk": at.LoadSnapshotChunkResponse,
    "apply_snapshot_chunk": at.ApplySnapshotChunkResponse,
}


def to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, bytes):
        return {"$b": base64.b64encode(obj).decode()}
    if isinstance(obj, list):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    return obj


def _resolve(tp):
    origin = typing.get_origin(tp)
    return origin if origin is not None else tp


def from_jsonable(tp, doc):
    if doc is None:
        return None
    if isinstance(doc, dict) and "$b" in doc:
        return base64.b64decode(doc["$b"])
    if dataclasses.is_dataclass(tp) and isinstance(doc, dict):
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for f in dataclasses.fields(tp):
            if f.name in doc:
                kwargs[f.name] = from_jsonable(hints[f.name], doc[f.name])
        return tp(**kwargs)
    origin = typing.get_origin(tp)
    if origin is list and isinstance(doc, list):
        (elem,) = typing.get_args(tp)
        return [from_jsonable(elem, x) for x in doc]
    if origin is dict and isinstance(doc, dict):
        _, val = typing.get_args(tp)
        return {k: from_jsonable(val, v) for k, v in doc.items()}
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return from_jsonable(args[0], doc) if args else doc
    return doc


def _frame(payload: bytes) -> bytes:
    return pe.uvarint(len(payload)) + payload


def _read_uvarint(rfile) -> int:
    shift = 0
    out = 0
    while True:
        b = rfile.read(1)
        if not b:
            raise EOFError("ABCI stream closed")
        out |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return out
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def encode_request(method: str, req) -> bytes:
    body = json.dumps({"m": method, "b": to_jsonable(req)}).encode()
    return _frame(body)


def encode_response(method: str, resp) -> bytes:
    body = json.dumps({"m": method, "b": to_jsonable(resp)}).encode()
    return _frame(body)


def encode_error(method: str, err: str) -> bytes:
    body = json.dumps({"m": method, "e": err}).encode()
    return _frame(body)


def _read_envelope(rfile):
    n = _read_uvarint(rfile)
    if n > 128 * 1024 * 1024:
        raise ValueError(f"ABCI frame too large: {n}")
    data = rfile.read(n)
    if len(data) != n:
        raise EOFError("short ABCI frame")
    return json.loads(data.decode())


def read_request(rfile):
    doc = _read_envelope(rfile)
    method = doc["m"]
    req = from_jsonable(_REQ_TYPES[method], doc.get("b", {}))
    return method, req


class RemoteError(Exception):
    pass


def read_response(rfile):
    doc = _read_envelope(rfile)
    method = doc["m"]
    if "e" in doc:
        raise RemoteError(doc["e"])
    resp = from_jsonable(_RESP_TYPES[method], doc.get("b", {}))
    return method, resp
