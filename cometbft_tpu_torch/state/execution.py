"""Block executor: bridges consensus ↔ ABCI (reference: state/execution.go).

``create_proposal_block`` reaps the mempool and asks the app to shape the
block (PrepareProposal); ``process_proposal`` asks the app to accept/reject a
peer's proposal; ``apply_block`` validates, FinalizeBlocks, persists results,
computes the next validator set / params, Commits the app (under the mempool
lock) and fires events.  Fail-points between the commit-path fsyncs mirror
the reference's ``fail.Fail()`` discipline (state/execution.go:267-322).

On the card, ``validate_block`` verifies the LastCommit with the Ed25519
kernel (one launch for a cold commit of any size) and hands in-block
evidence to the pool, whose duplicate-vote pair rides one flush of the
verify scheduler; every hash of 32 or more leaves (the validator sets, the
txs, the commit, the results, the part set) is one pass of the tree
kernel once the plane's gate is open.  ``device=None`` means the card: an
executor built with no card raises, unless the caller names the CPU
(``device="cpu"``) or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` is set.  No path
falls back to hide the card.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.state.state import State, _params_from_json, _params_to_json
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.basic import (
    BLOCK_ID_FLAG_ABSENT,
    BlockID,
    Timestamp,
)
from cometbft_tpu_torch.types.block import Block, Commit, Data, Header, ConsensusVersion
from cometbft_tpu_torch.types.events import (
    EventBus,
    EventDataNewBlock,
    EventDataNewBlockEvents,
    EventDataNewBlockHeader,
    EventDataTx,
    EventDataValidatorSetUpdates,
)
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.utils.fail import fail_point
from cometbft_tpu_torch.version import BLOCK_PROTOCOL


class BlockExecutionError(Exception):
    pass


class InvalidBlockError(BlockExecutionError):
    pass


def exec_tx_result_encode(r: at.ExecTxResult) -> bytes:
    """Deterministic encoding for last_results_hash (reference:
    types/results.go ABCIResults.Hash — only code/data/gas fields are
    deterministic and included)."""
    out = b""
    if r.code:
        out += pe.t_varint(1, r.code)
    out += pe.t_bytes(2, r.data)
    if r.gas_wanted:
        out += pe.t_varint(5, r.gas_wanted)
    if r.gas_used:
        out += pe.t_varint(6, r.gas_used)
    return out


def results_hash(results: Sequence[at.ExecTxResult]) -> bytes:
    from cometbft_tpu_torch.proofserve import plane

    return plane.tree_hash(
        [exec_tx_result_encode(r) for r in results]
    )


def make_block(
    height: int,
    txs: list[bytes],
    last_commit: Commit,
    state: State,
    proposer_address: bytes,
    time: Timestamp,
) -> Block:
    """Reference: state/state.go MakeBlock + types/block.go MakeBlock."""
    header = Header(
        version=ConsensusVersion(block=BLOCK_PROTOCOL, app=state.version_app),
        chain_id=state.chain_id,
        height=height,
        time=time,
        last_block_id=state.last_block_id,
        validators_hash=state.validators.hash(),
        next_validators_hash=state.next_validators.hash(),
        consensus_hash=consensus_params_hash(state.consensus_params),
        app_hash=state.app_hash,
        last_results_hash=state.last_results_hash,
        proposer_address=proposer_address,
    )
    block = Block(header=header, data=Data(txs=txs), last_commit=last_commit)
    block.fill_header_hashes()
    return block


def consensus_params_hash(params) -> bytes:
    return params.hash()


def build_last_commit_info(block: Block, last_vals: Optional[ValidatorSet]) -> at.CommitInfo:
    """Reference: state/execution.go buildLastCommitInfo."""
    if block.header.height <= 1 or last_vals is None:
        return at.CommitInfo()
    votes = []
    for i, cs in enumerate(block.last_commit.signatures):
        val = last_vals.get_by_index(i)
        votes.append(
            at.VoteInfo(
                validator=at.Validator(address=val.address, power=val.voting_power),
                block_id_flag=cs.block_id_flag,
            )
        )
    return at.CommitInfo(round_=block.last_commit.round_, votes=votes)


def validate_validator_updates(
    updates: Sequence[at.ValidatorUpdate], params
) -> list[Validator]:
    """Reference: state/validation.go validateValidatorUpdates."""
    from cometbft_tpu_torch.crypto import keys as ck

    out = []
    for vu in updates:
        if vu.power < 0:
            raise BlockExecutionError(f"negative validator power {vu.power}")
        key_type = vu.pub_key_type or "ed25519"
        if key_type not in params.validator.pub_key_types:
            raise BlockExecutionError(f"key type {key_type} not allowed by params")
        pub = ck.pub_key_from_type(key_type, vu.pub_key_bytes)
        out.append(Validator(pub_key=pub, voting_power=vu.power))
    return out


@dataclass
class _PrunerHeights:
    """Retain heights influencing pruning (reference: state/pruner.go —
    app + data-companion block heights, plus companion-set block-results
    and indexer retain heights served by the pruning gRPC service)."""

    app_retain: int = 0
    companion_retain: int = 0
    companion_results_retain: int = 0
    tx_index_retain: int = 0
    block_index_retain: int = 0


class BlockExecutor:
    """Reference: state/execution.go:70 BlockExecutor."""

    def __init__(
        self,
        state_store: StateStore,
        block_store: BlockStore,
        proxy_app,  # consensus connection (abci Client)
        mempool,
        evidence_pool=None,
        event_bus: Optional[EventBus] = None,
        logger=None,
        device=None,
    ):
        self.device = validation.require_device(device)
        self.state_store = state_store
        self.block_store = block_store
        self.proxy_app = proxy_app
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.logger = logger
        self._retain = _PrunerHeights()

    # -- proposal construction (reference :113 CreateProposalBlock) -------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Commit,
        proposer_address: bytes,
        last_ext_commit_info: Optional[at.ExtendedCommitInfo] = None,
        block_time: Optional[Timestamp] = None,
    ) -> Block:
        params = state.consensus_params
        max_bytes = params.block.max_bytes
        max_gas = params.block.max_gas
        evidence, ev_size = [], 0
        if self.evidence_pool is not None:
            evidence, ev_size = self.evidence_pool.pending_evidence(
                params.evidence.max_bytes
            )
        # max data bytes (reference: types.MaxDataBytes)
        max_data_bytes = max_bytes - 1024 - ev_size  # header/commit overhead
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        time = block_time or Timestamp.now()

        req = at.PrepareProposalRequest(
            max_tx_bytes=max_data_bytes,
            txs=txs,
            local_last_commit=last_ext_commit_info or at.ExtendedCommitInfo(),
            misbehavior=[m for ev in evidence for m in ev.abci()],
            height=height,
            time_unix_ns=time.to_ns(),
            next_validators_hash=state.next_validators.hash(),
            proposer_address=proposer_address,
        )
        res = self.proxy_app.prepare_proposal(req)
        new_txs = res.txs if res is not None else txs
        total = sum(len(t) for t in new_txs)
        if total > max_data_bytes:
            raise BlockExecutionError(
                f"app returned {total}B of txs > limit {max_data_bytes}B"
            )
        block = make_block(height, list(new_txs), last_commit, state, proposer_address, time)
        # attach evidence BEFORE the hashes are trusted: evidence_hash was
        # filled for an empty list inside make_block, recompute it
        block.evidence = evidence
        from cometbft_tpu_torch.types.evidence import evidence_list_hash

        block.header.evidence_hash = evidence_list_hash(evidence)
        return block

    # -- proposal validation (reference :173 ProcessProposal) -------------

    def process_proposal(self, block: Block, state: State) -> bool:
        req = at.ProcessProposalRequest(
            txs=list(block.data.txs),
            proposed_last_commit=build_last_commit_info(block, state.last_validators),
            misbehavior=[m for ev in block.evidence for m in ev.abci()],
            hash=block.hash(),
            height=block.header.height,
            time_unix_ns=block.header.time.to_ns(),
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        res = self.proxy_app.process_proposal(req)
        return res.accepted

    # -- block validation (reference: state/validation.go:17) -------------

    def validate_block(self, state: State, block: Block) -> None:
        err = block.validate_basic()
        if err:
            raise InvalidBlockError(err)
        h = block.header
        if h.version.block != BLOCK_PROTOCOL:
            raise InvalidBlockError(
                f"block protocol {h.version.block} != {BLOCK_PROTOCOL}"
            )
        if h.version.app != state.version_app:
            raise InvalidBlockError("app version mismatch")
        if h.chain_id != state.chain_id:
            raise InvalidBlockError("chain id mismatch")
        expected_height = state.last_block_height + 1
        if state.last_block_height == 0:
            expected_height = state.initial_height
        if h.height != expected_height:
            raise InvalidBlockError(
                f"height {h.height}, expected {expected_height}"
            )
        if h.last_block_id != state.last_block_id:
            raise InvalidBlockError("last block id mismatch")
        if h.app_hash != state.app_hash:
            raise InvalidBlockError("app hash mismatch")
        if h.last_results_hash != state.last_results_hash:
            raise InvalidBlockError("last results hash mismatch")
        if h.validators_hash != state.validators.hash():
            raise InvalidBlockError("validators hash mismatch")
        if h.next_validators_hash != state.next_validators.hash():
            raise InvalidBlockError("next validators hash mismatch")
        if h.consensus_hash != consensus_params_hash(state.consensus_params):
            raise InvalidBlockError("consensus params hash mismatch")

        # LastCommit verification — THE hot path (§3.4): batch Ed25519 on
        # the card, pre-filtered by the consensus-wide signature cache: votes
        # already verified at gossip time (vote_set.add_vote) resolve as
        # cache hits, so a commit assembled from our own vote set re-verifies
        # without any device dispatch.
        if h.height > state.initial_height:
            if block.last_commit.size() != len(state.last_validators):
                raise InvalidBlockError(
                    "last commit size != last validator set size"
                )
            before = t0 = None
            if self.logger is not None:
                import time as _time

                from cometbft_tpu_torch.crypto import sigcache

                before = sigcache.get_cache().stats()
                t0 = _time.perf_counter()
            validation.verify_commit(
                state.chain_id,
                state.last_validators,
                state.last_block_id,
                h.height - 1,
                block.last_commit,
                device=self.device,
            )
            if self.logger is not None:
                after = sigcache.get_cache().stats()
                self.logger.debug(
                    "last commit verified",
                    height=h.height,
                    elapsed_ms=round((_time.perf_counter() - t0) * 1e3, 2),
                    cache_hits=after["hits"] - before["hits"],
                    cache_misses=after["misses"] - before["misses"],
                )
        elif block.last_commit.size() != 0:
            raise InvalidBlockError("initial block must have empty last commit")

        if len(h.proposer_address) != 20 or not state.validators.has_address(
            h.proposer_address
        ):
            raise InvalidBlockError("proposer not in validator set")

        # evidence: size limit + full verification against the pool
        # (reference: state/validation.go:17 validateBlock evidence section)
        from cometbft_tpu_torch.types.evidence import evidence_list_bytes

        ev_bytes = evidence_list_bytes(block.evidence)
        if ev_bytes > state.consensus_params.evidence.max_bytes:
            raise InvalidBlockError(
                f"evidence bytes {ev_bytes} > limit "
                f"{state.consensus_params.evidence.max_bytes}"
            )
        if self.evidence_pool is not None:
            from cometbft_tpu_torch.evidence.verify import EvidenceInvalidError

            try:
                self.evidence_pool.check_evidence(state, block.evidence)
            except EvidenceInvalidError as e:
                raise InvalidBlockError(f"invalid evidence: {e}") from e

    # -- ApplyBlock (reference :224-334) ----------------------------------

    def apply_block(
        self, state: State, block_id: BlockID, block: Block, syncing_to_height: int = 0
    ) -> State:
        self.validate_block(state, block)
        return self.apply_verified_block(state, block_id, block, syncing_to_height)

    def apply_verified_block(
        self, state: State, block_id: BlockID, block: Block, syncing_to_height: int = 0
    ) -> State:
        h = block.header
        req = at.FinalizeBlockRequest(
            txs=list(block.data.txs),
            decided_last_commit=build_last_commit_info(block, state.last_validators),
            misbehavior=[m for ev in block.evidence for m in ev.abci()],
            hash=block.hash(),
            height=h.height,
            time_unix_ns=h.time.to_ns(),
            next_validators_hash=h.next_validators_hash,
            proposer_address=h.proposer_address,
            syncing_to_height=syncing_to_height or h.height,
        )
        res = self.proxy_app.finalize_block(req)
        if len(res.tx_results) != len(block.data.txs):
            raise BlockExecutionError(
                f"app returned {len(res.tx_results)} tx results, "
                f"expected {len(block.data.txs)}"
            )

        fail_point(1)  # after FinalizeBlock, before saving response
        self.state_store.save_finalize_block_response(
            h.height, _fbr_to_json(res)
        )
        fail_point(2)

        val_updates = validate_validator_updates(
            res.validator_updates, state.consensus_params
        )
        new_state = self._update_state(state, block_id, block, res, val_updates)

        # Commit app + update mempool under the mempool lock (reference :402).
        app_hash_in_commit = self._commit(new_state, block, res)
        assert app_hash_in_commit == res.app_hash

        if self.evidence_pool is not None:
            self.evidence_pool.update(new_state, block.evidence)

        fail_point(3)
        new_state.app_hash = res.app_hash
        self.state_store.save(new_state)
        fail_point(4)

        # pruning happens in the background Pruner service (state/pruner.py)
        # off the commit path, honoring the recorded retain heights
        self._fire_events(block, block_id, res, val_updates)
        return new_state

    def _commit(self, state: State, block: Block, res) -> bytes:
        self.mempool.lock()
        try:
            # flush ensures all pending CheckTx responses landed
            commit_res = self.proxy_app.commit()
            self._retain.app_retain = commit_res.retain_height
            self.mempool.update(
                block.header.height, list(block.data.txs), list(res.tx_results)
            )
            return res.app_hash
        finally:
            self.mempool.unlock()

    def _update_state(
        self, state: State, block_id: BlockID, block: Block, res, val_updates
    ) -> State:
        """Reference: state/execution.go:633 updateState."""
        h = block.header
        next_vals = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if val_updates:
            next_vals.update_with_change_set(val_updates)
            last_height_vals_changed = h.height + 1 + 1

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        if res.consensus_param_updates:
            params = _params_from_json(
                _merge_params(_params_to_json(params), res.consensus_param_updates)
            )
            last_height_params_changed = h.height + 1

        next_vals.increment_proposer_priority(1)
        return State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=h.height,
            last_block_id=block_id,
            last_block_time=h.time,
            validators=state.next_validators.copy(),
            next_validators=next_vals,
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash(res.tx_results),
            app_hash=state.app_hash,  # overwritten by caller post-commit
            version_app=state.version_app,
        )


    def _fire_events(self, block: Block, block_id: BlockID, res, val_updates):
        """Reference: state/execution.go:706 fireEvents."""
        if self.event_bus is None:
            return
        self.event_bus.publish_new_block(
            EventDataNewBlock(block=block, block_id=block_id, result_finalize_block=res)
        )
        self.event_bus.publish_new_block_header(
            EventDataNewBlockHeader(header=block.header)
        )
        self.event_bus.publish_new_block_events(
            EventDataNewBlockEvents(
                height=block.header.height,
                events=res.events,
                num_txs=len(block.data.txs),
            )
        )
        for i, tx in enumerate(block.data.txs):
            self.event_bus.publish_tx(
                EventDataTx(
                    height=block.header.height,
                    index=i,
                    tx=tx,
                    result=res.tx_results[i],
                )
            )
        if val_updates:
            self.event_bus.publish_validator_set_updates(
                EventDataValidatorSetUpdates(validator_updates=val_updates)
            )

    # -- vote extensions (reference :339 ExtendVote / VerifyVoteExtension) -

    def extend_vote(self, vote, block, state) -> bytes:
        res = self.proxy_app.extend_vote(
            at.ExtendVoteRequest(
                hash=vote.block_id.hash,
                height=vote.height,
                round_=vote.round_,
                txs=list(block.data.txs) if block else [],
                next_validators_hash=state.next_validators.hash(),
                proposer_address=block.header.proposer_address if block else b"",
                time_unix_ns=block.header.time.to_ns() if block else 0,
            )
        )
        return res.vote_extension

    def verify_vote_extension(self, vote) -> bool:
        res = self.proxy_app.verify_vote_extension(
            at.VerifyVoteExtensionRequest(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
            )
        )
        return res.accepted


def _merge_params(base: dict, updates: dict) -> dict:
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in base.items()}
    for section, vals in (updates or {}).items():
        if isinstance(vals, dict):
            out.setdefault(section, {}).update(vals)
        else:
            out[section] = vals
    return out


# -- FinalizeBlockResponse JSON round-trip (for the state store) -----------

def _fbr_to_json(res: at.FinalizeBlockResponse) -> bytes:
    import base64

    def ev(e):
        return {
            "type": e.type_,
            "attributes": [
                {"key": a.key, "value": a.value, "index": a.index}
                for a in e.attributes
            ],
        }

    doc = {
        "events": [ev(e) for e in res.events],
        "tx_results": [
            {
                "code": r.code,
                "data": base64.b64encode(r.data).decode(),
                "log": r.log,
                "gas_wanted": r.gas_wanted,
                "gas_used": r.gas_used,
                "events": [ev(e) for e in r.events],
            }
            for r in res.tx_results
        ],
        "validator_updates": [
            {
                "pub_key_type": vu.pub_key_type,
                "pub_key": base64.b64encode(vu.pub_key_bytes).decode(),
                "power": vu.power,
            }
            for vu in res.validator_updates
        ],
        "consensus_param_updates": res.consensus_param_updates,
        "app_hash": base64.b64encode(res.app_hash).decode(),
    }
    return json.dumps(doc, sort_keys=True).encode()


def fbr_from_json(raw: bytes) -> at.FinalizeBlockResponse:
    import base64

    def ev(d):
        return at.Event(
            type_=d["type"],
            attributes=[
                at.EventAttribute(key=a["key"], value=a["value"], index=a["index"])
                for a in d["attributes"]
            ],
        )

    doc = json.loads(raw.decode())
    return at.FinalizeBlockResponse(
        events=[ev(e) for e in doc["events"]],
        tx_results=[
            at.ExecTxResult(
                code=r["code"],
                data=base64.b64decode(r["data"]),
                log=r["log"],
                gas_wanted=r["gas_wanted"],
                gas_used=r["gas_used"],
                events=[ev(e) for e in r["events"]],
            )
            for r in doc["tx_results"]
        ],
        validator_updates=[
            at.ValidatorUpdate(
                pub_key_type=vu["pub_key_type"],
                pub_key_bytes=base64.b64decode(vu["pub_key"]),
                power=vu["power"],
            )
            for vu in doc["validator_updates"]
        ],
        consensus_param_updates=doc["consensus_param_updates"],
        app_hash=base64.b64decode(doc["app_hash"]),
    )
