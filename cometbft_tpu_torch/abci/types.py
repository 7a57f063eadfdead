"""ABCI 2.x request/response types.

Mirrors the reference's protobuf messages (abci/types/, ABCISemVer 2.2.0) as
plain dataclasses: 12 application methods across 4 logical connections
(consensus / mempool / query / snapshot).  They keep the message *shape*
of the reference (abci/types/application.go:11-41) without pulling in its
generated code.  The port's copy of the JAX package's ``abci/types.py``;
the socket transport serializes these as length-prefixed JSON with base64
bytes (see abci/codec.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

CODE_TYPE_OK = 0


# -- shared sub-messages ----------------------------------------------------

@dataclass
class EventAttribute:
    key: str = ""
    value: str = ""
    index: bool = False


@dataclass
class Event:
    type_: str = ""
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ExecTxResult:
    """Reference: abci Application FinalizeBlock per-tx result."""

    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    @property
    def ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class Validator:
    address: bytes = b""
    power: int = 0


@dataclass
class VoteInfo:
    validator: Validator = field(default_factory=Validator)
    block_id_flag: int = 0


@dataclass
class ExtendedVoteInfo:
    validator: Validator = field(default_factory=Validator)
    vote_extension: bytes = b""
    extension_signature: bytes = b""
    block_id_flag: int = 0


@dataclass
class CommitInfo:
    round_: int = 0
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round_: int = 0
    votes: list[ExtendedVoteInfo] = field(default_factory=list)


MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


@dataclass
class Misbehavior:
    type_: int = 0
    validator: Validator = field(default_factory=Validator)
    height: int = 0
    time_unix_ns: int = 0
    total_voting_power: int = 0


@dataclass
class ValidatorUpdate:
    pub_key_type: str = ""
    pub_key_bytes: bytes = b""
    power: int = 0


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


# -- Info / Query (query connection) ----------------------------------------

@dataclass
class InfoRequest:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""
    lane_priorities: dict[str, int] = field(default_factory=dict)
    default_lane: str = ""
    # True when the app (e.g. wrapped in txingest.SigVerifyingApp) rejects
    # signed-tx envelopes with bad signatures itself, using the canonical
    # txingest codes.  The mempool ingest pipeline then pre-verifies
    # envelope signatures on the crypto seam and rejects forgeries without
    # an app round trip — byte-identical codes by construction
    # (docs/tx-ingest.md).
    envelope_sig_verified: bool = False


@dataclass
class QueryRequest:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class QueryResponse:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    codespace: str = ""


# -- CheckTx (mempool connection) -------------------------------------------

CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1


@dataclass
class CheckTxRequest:
    tx: bytes = b""
    type_: int = CHECK_TX_TYPE_NEW


@dataclass
class CheckTxResponse:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""
    lane_id: str = ""

    @property
    def ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class CheckTxsRequest:
    """Batched CheckTx: one mempool-connection round trip admits a whole
    gossip burst (docs/tx-ingest.md).  Apps that don't override
    ``check_txs`` get the loop-over-``check_tx`` fallback in
    ``Application``, so the batch is always semantically a sequence of
    independent per-tx checks — batching changes the round-trip count,
    never the verdicts."""

    requests: list[CheckTxRequest] = field(default_factory=list)


@dataclass
class CheckTxsResponse:
    """One response per request, index-aligned."""

    responses: list[CheckTxResponse] = field(default_factory=list)


# -- consensus connection ---------------------------------------------------

@dataclass
class InitChainRequest:
    time_unix_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[dict] = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class InitChainResponse:
    consensus_params: Optional[dict] = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class PrepareProposalRequest:
    max_tx_bytes: int = 0
    txs: list[bytes] = field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = field(default_factory=ExtendedCommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    height: int = 0
    time_unix_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class PrepareProposalResponse:
    txs: list[bytes] = field(default_factory=list)


PROPOSAL_STATUS_UNKNOWN = 0
PROPOSAL_STATUS_ACCEPT = 1
PROPOSAL_STATUS_REJECT = 2


@dataclass
class ProcessProposalRequest:
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_unix_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ProcessProposalResponse:
    status: int = PROPOSAL_STATUS_UNKNOWN

    @property
    def accepted(self) -> bool:
        return self.status == PROPOSAL_STATUS_ACCEPT


@dataclass
class ExtendVoteRequest:
    hash: bytes = b""
    height: int = 0
    round_: int = 0
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    time_unix_ns: int = 0


@dataclass
class ExtendVoteResponse:
    vote_extension: bytes = b""


VERIFY_VOTE_EXTENSION_UNKNOWN = 0
VERIFY_VOTE_EXTENSION_ACCEPT = 1
VERIFY_VOTE_EXTENSION_REJECT = 2


@dataclass
class VerifyVoteExtensionRequest:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


@dataclass
class VerifyVoteExtensionResponse:
    status: int = VERIFY_VOTE_EXTENSION_UNKNOWN

    @property
    def accepted(self) -> bool:
        return self.status == VERIFY_VOTE_EXTENSION_ACCEPT


@dataclass
class FinalizeBlockRequest:
    txs: list[bytes] = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_unix_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    syncing_to_height: int = 0


@dataclass
class FinalizeBlockResponse:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[dict] = None
    app_hash: bytes = b""
    next_block_delay_ms: int = 0


@dataclass
class CommitRequest:
    pass


@dataclass
class CommitResponse:
    retain_height: int = 0


# -- snapshot connection ----------------------------------------------------

@dataclass
class ListSnapshotsRequest:
    pass


@dataclass
class ListSnapshotsResponse:
    snapshots: list[Snapshot] = field(default_factory=list)


OFFER_SNAPSHOT_UNKNOWN = 0
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5


@dataclass
class OfferSnapshotRequest:
    snapshot: Snapshot = field(default_factory=Snapshot)
    app_hash: bytes = b""


@dataclass
class OfferSnapshotResponse:
    result: int = OFFER_SNAPSHOT_UNKNOWN


@dataclass
class LoadSnapshotChunkRequest:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class LoadSnapshotChunkResponse:
    chunk: bytes = b""


APPLY_SNAPSHOT_CHUNK_UNKNOWN = 0
APPLY_SNAPSHOT_CHUNK_ACCEPT = 1
APPLY_SNAPSHOT_CHUNK_ABORT = 2
APPLY_SNAPSHOT_CHUNK_RETRY = 3
APPLY_SNAPSHOT_CHUNK_RETRY_SNAPSHOT = 4
APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT = 5


@dataclass
class ApplySnapshotChunkRequest:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class ApplySnapshotChunkResponse:
    result: int = APPLY_SNAPSHOT_CHUNK_UNKNOWN
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


# -- echo/flush (transport-level) -------------------------------------------

@dataclass
class EchoRequest:
    message: str = ""


@dataclass
class EchoResponse:
    message: str = ""
