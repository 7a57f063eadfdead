"""Internal types -> wire protobuf messages (cometbft.* packages).

The framework's own storage/gossip encoding is self-defined
(libs/protoenc); these converters produce the *reference-compatible*
protobuf messages that external data companions and gRPC clients expect
(reference: rpc/grpc/server/services/*/service.go response construction).

The port's copy of the JAX package's ``rpc/pb_convert.py``, on the port's
own generated modules (``proto_gen``): the same messages, byte for byte.
Importing it imports ``google.protobuf``.
"""

from __future__ import annotations

from cometbft_tpu_torch.proto_gen.cometbft.abci.v1 import types_pb2 as abci_pb
from cometbft_tpu_torch.proto_gen.cometbft.types.v1 import (
    block_pb2,
    evidence_pb2,
    types_pb2,
)


def _ts(pb_ts, t) -> None:
    pb_ts.seconds = t.seconds
    pb_ts.nanos = t.nanos


def block_id_pb(bid) -> types_pb2.BlockID:
    out = types_pb2.BlockID(hash=bid.hash)
    out.part_set_header.total = bid.part_set_header.total
    out.part_set_header.hash = bid.part_set_header.hash
    return out


def header_pb(h) -> types_pb2.Header:
    out = types_pb2.Header(
        chain_id=h.chain_id,
        height=h.height,
        last_commit_hash=h.last_commit_hash,
        data_hash=h.data_hash,
        validators_hash=h.validators_hash,
        next_validators_hash=h.next_validators_hash,
        consensus_hash=h.consensus_hash,
        app_hash=h.app_hash,
        last_results_hash=h.last_results_hash,
        evidence_hash=h.evidence_hash,
        proposer_address=h.proposer_address,
    )
    out.version.block = h.version.block
    out.version.app = h.version.app
    _ts(out.time, h.time)
    out.last_block_id.CopyFrom(block_id_pb(h.last_block_id))
    return out


def vote_pb(v) -> types_pb2.Vote:
    out = types_pb2.Vote(
        type=v.type_,
        height=v.height,
        round=v.round_,
        validator_address=v.validator_address,
        validator_index=v.validator_index,
        signature=v.signature,
        extension=v.extension,
        extension_signature=v.extension_signature,
    )
    out.block_id.CopyFrom(block_id_pb(v.block_id))
    _ts(out.timestamp, v.timestamp)
    return out


def commit_pb(c) -> types_pb2.Commit:
    out = types_pb2.Commit(height=c.height, round=c.round_)
    out.block_id.CopyFrom(block_id_pb(c.block_id))
    for sig in c.signatures:
        s = out.signatures.add()
        s.block_id_flag = sig.block_id_flag
        s.validator_address = sig.validator_address
        s.signature = sig.signature
        _ts(s.timestamp, sig.timestamp)
    return out


def _validator_pb(v) -> types_pb2.Validator:
    return types_pb2.Validator(
        address=v.address,
        voting_power=v.voting_power,
        proposer_priority=getattr(v, "proposer_priority", 0),
        pub_key_bytes=v.pub_key.bytes(),
        pub_key_type=v.pub_key.type_,
    )


def evidence_pb(ev) -> evidence_pb2.Evidence:
    out = evidence_pb2.Evidence()
    if ev.TYPE == "duplicate_vote":
        dv = out.duplicate_vote_evidence
        dv.vote_a.CopyFrom(vote_pb(ev.vote_a))
        dv.vote_b.CopyFrom(vote_pb(ev.vote_b))
        dv.total_voting_power = ev.total_voting_power
        dv.validator_power = ev.validator_power
        _ts(dv.timestamp, ev.timestamp)
    else:  # light_client_attack
        la = out.light_client_attack_evidence
        lb = ev.conflicting_block
        la.conflicting_block.signed_header.header.CopyFrom(
            header_pb(lb.signed_header.header)
        )
        la.conflicting_block.signed_header.commit.CopyFrom(
            commit_pb(lb.signed_header.commit)
        )
        vs = la.conflicting_block.validator_set
        for v in lb.validator_set.validators:
            vs.validators.add().CopyFrom(_validator_pb(v))
        if lb.validator_set.validators:
            vs.proposer.CopyFrom(
                _validator_pb(lb.validator_set.get_proposer())
            )
        vs.total_voting_power = lb.validator_set.total_voting_power()
        la.common_height = ev.common_height
        for v in ev.byzantine_validators:
            la.byzantine_validators.add().CopyFrom(_validator_pb(v))
        la.total_voting_power = ev.total_voting_power
        _ts(la.timestamp, ev.timestamp)
    return out


def block_pb(b) -> block_pb2.Block:
    out = block_pb2.Block()
    out.header.CopyFrom(header_pb(b.header))
    out.data.txs.extend(b.data.txs)
    for ev in b.evidence:
        out.evidence.evidence.add().CopyFrom(evidence_pb(ev))
    if b.last_commit is not None:
        out.last_commit.CopyFrom(commit_pb(b.last_commit))
    return out


def event_pb(e) -> abci_pb.Event:
    out = abci_pb.Event(type=e.type_)
    for a in e.attributes:
        out.attributes.add(key=a.key, value=a.value, index=a.index)
    return out


def exec_tx_result_pb(r) -> abci_pb.ExecTxResult:
    out = abci_pb.ExecTxResult(
        code=r.code,
        data=r.data,
        log=r.log,
        info=r.info,
        gas_wanted=r.gas_wanted,
        gas_used=r.gas_used,
        codespace=r.codespace,
    )
    for e in r.events:
        out.events.add().CopyFrom(event_pb(e))
    return out


def validator_update_pb(v) -> abci_pb.ValidatorUpdate:
    return abci_pb.ValidatorUpdate(
        power=v.power,
        pub_key_bytes=v.pub_key_bytes,
        pub_key_type=v.pub_key_type,
    )


_NS = 1_000_000_000


def params_to_pb(target, params) -> None:
    """Internal consensus-params dict -> cometbft.types.v1.ConsensusParams
    (in place on ``target``)."""
    if not params:
        return
    block = params.get("block", {})
    if block:
        target.block.max_bytes = int(block.get("max_bytes", 0))
        target.block.max_gas = int(block.get("max_gas", 0))
    ev = params.get("evidence", {})
    if ev:
        target.evidence.max_age_num_blocks = int(
            ev.get("max_age_num_blocks", 0)
        )
        dur_ns = int(ev.get("max_age_duration", 0))
        target.evidence.max_age_duration.seconds = dur_ns // _NS
        target.evidence.max_age_duration.nanos = dur_ns % _NS
        target.evidence.max_bytes = int(ev.get("max_bytes", 0))
    val = params.get("validator", {})
    if val:
        target.validator.pub_key_types.extend(val.get("pub_key_types", []))
    feat = params.get("feature", {})
    if feat:
        if "vote_extensions_enable_height" in feat:
            target.feature.vote_extensions_enable_height.value = int(
                feat["vote_extensions_enable_height"]
            )
        if "pbts_enable_height" in feat:
            target.feature.pbts_enable_height.value = int(
                feat["pbts_enable_height"]
            )


def params_from_pb(msg):
    """cometbft.types.v1.ConsensusParams -> internal dict (None if empty)."""
    if msg is None or not msg.ByteSize():
        return None
    out: dict = {}
    if msg.HasField("block"):
        out["block"] = {
            "max_bytes": msg.block.max_bytes,
            "max_gas": msg.block.max_gas,
        }
    if msg.HasField("evidence"):
        out["evidence"] = {
            "max_age_num_blocks": msg.evidence.max_age_num_blocks,
            "max_age_duration": msg.evidence.max_age_duration.seconds * _NS
            + msg.evidence.max_age_duration.nanos,
            "max_bytes": msg.evidence.max_bytes,
        }
    if msg.HasField("validator"):
        out["validator"] = {
            "pub_key_types": list(msg.validator.pub_key_types)
        }
    if msg.HasField("feature"):
        feat = {}
        if msg.feature.HasField("vote_extensions_enable_height"):
            feat["vote_extensions_enable_height"] = (
                msg.feature.vote_extensions_enable_height.value
            )
        if msg.feature.HasField("pbts_enable_height"):
            feat["pbts_enable_height"] = msg.feature.pbts_enable_height.value
        if feat:
            out["feature"] = feat
    return out or None
