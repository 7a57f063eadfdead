"""ABCI handshake + block replay on boot.

Reference: internal/consensus/replay.go:242 Handshaker.Handshake — on
startup, ask the app its height (`Info`), InitChain if the app is fresh,
then replay whatever blocks the app is missing from the block store, and
apply the final block through the BlockExecutor if the state store is one
height behind the block store (crash between SaveBlock and ApplyBlock).

``device`` is the executor's (``state/execution.BlockExecutor``): None
means the card, and a handshaker built with no card raises at that block
unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.state.execution import (
    BlockExecutor,
    build_last_commit_info,
    validate_validator_updates,
)
from cometbft_tpu_torch.state.state import State, _params_from_json, _params_to_json
from cometbft_tpu_torch.state.execution import _merge_params
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.validator import ValidatorSet


class HandshakeError(Exception):
    pass


class Handshaker:
    """Reference: replay.go Handshaker."""

    def __init__(
        self,
        state_store,
        block_store,
        genesis_doc: GenesisDoc,
        event_bus=None,
        evidence_pool=None,
        logger: Optional[liblog.Logger] = None,
        device=None,
    ):
        self.device = device
        self.state_store = state_store
        self.block_store = block_store
        self.genesis_doc = genesis_doc
        self.event_bus = event_bus
        self.evidence_pool = evidence_pool
        self.logger = logger or liblog.nop_logger()
        self.n_blocks_replayed = 0

    def handshake(self, state: State, app_conns) -> State:
        """Sync the app with our stores; returns the (possibly updated)
        state.  ``app_conns`` is a proxy.AppConns."""
        info = app_conns.query.info(at.InfoRequest())
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")
        self.logger.info(
            "ABCI handshake", app_height=app_height, app_hash=app_hash
        )
        state.version_app = info.app_version

        if app_height == 0:
            state = self._init_chain(state, app_conns)

        state = self._replay_blocks(state, app_conns, app_height)
        return state

    # -- InitChain (reference: replay.go:282-350) --------------------------

    def _init_chain(self, state: State, app_conns) -> State:
        gdoc = self.genesis_doc
        validators = [
            at.ValidatorUpdate(
                pub_key_type=v.pub_key.type_,
                pub_key_bytes=v.pub_key.bytes(),
                power=v.power,
            )
            for v in gdoc.validators
        ]
        req = at.InitChainRequest(
            time_unix_ns=gdoc.genesis_time.to_ns(),
            chain_id=gdoc.chain_id,
            consensus_params=_params_to_json(gdoc.consensus_params),
            validators=validators,
            app_state_bytes=gdoc.app_state,
            initial_height=gdoc.initial_height,
        )
        res = app_conns.consensus.init_chain(req)

        if state.last_block_height == 0:
            if res.app_hash:
                state.app_hash = res.app_hash
            if res.consensus_params:
                state.consensus_params = _params_from_json(
                    _merge_params(
                        _params_to_json(state.consensus_params),
                        res.consensus_params,
                    )
                )
            if res.validators:
                vals = validate_validator_updates(
                    res.validators, state.consensus_params
                )
                state.validators = ValidatorSet(vals)
                state.next_validators = state.validators.copy_increment_proposer_priority(1)
            self.state_store.bootstrap(state)
        return state

    # -- block replay (reference: replay.go ReplayBlocks + :95) ------------

    def _replay_blocks(self, state: State, app_conns, app_height: int) -> State:
        store_height = self.block_store.height()
        state_height = state.last_block_height
        if store_height == 0:
            return state
        if app_height > state_height:
            raise HandshakeError(
                f"app height {app_height} ahead of state height {state_height}"
            )

        # 1) replay finished blocks into the app only
        replay_to = state_height
        if store_height == state_height + 1:
            replay_to = state_height  # final block handled below
        for h in range(app_height + 1, replay_to + 1):
            self._replay_block_into_app(state, app_conns, h)
            self.n_blocks_replayed += 1

        # 2) block saved but state not advanced (crash mid-commit):
        #    run it through the full executor.
        if store_height == state_height + 1:
            block = self.block_store.load_block(store_height)
            meta = self.block_store.load_block_meta(store_height)
            block_exec = BlockExecutor(
                self.state_store,
                self.block_store,
                app_conns.consensus,
                _ReplayMempool(),
                evidence_pool=self.evidence_pool,
                event_bus=self.event_bus,
                logger=self.logger,
                device=self.device,
            )
            state = block_exec.apply_block(state, meta.block_id, block)
            self.n_blocks_replayed += 1
        return state

    def _replay_block_into_app(self, state: State, app_conns, height: int):
        """FinalizeBlock + Commit only — state/stores already have it."""
        block = self.block_store.load_block(height)
        if block is None:
            raise HandshakeError(f"missing block {height} in store")
        last_vals = None
        if height > state.initial_height:
            last_vals = self.state_store.load_validators(height - 1)
        req = at.FinalizeBlockRequest(
            txs=list(block.data.txs),
            decided_last_commit=build_last_commit_info(block, last_vals),
            misbehavior=[m for ev in block.evidence for m in ev.abci()],
            hash=block.hash(),
            height=height,
            time_unix_ns=block.header.time.to_ns(),
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
            syncing_to_height=self.block_store.height(),
        )
        res = app_conns.consensus.finalize_block(req)
        app_conns.consensus.commit()
        self.logger.info("replayed block into app", height=height)
        return res


class _ReplayMempool:
    """Nop mempool for replay-time block execution."""

    def lock(self):
        pass

    def unlock(self):
        pass

    def update(self, height, txs, tx_results):
        pass

    def reap_max_bytes_max_gas(self, a, b):
        return []

    def is_empty(self):
        return True
