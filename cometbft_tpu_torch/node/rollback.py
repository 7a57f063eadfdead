"""Offline state rollback (reference: state/rollback.go + commands/rollback.go).

Rolls the state store back one height so a node can retry applying the last
block (e.g. after a faulty upgrade).  ``--hard`` also removes the block
itself from the block store.

The port's copy of the JAX package's ``node/rollback.py``.
"""

from __future__ import annotations

import os

from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.store.kv import open_kv


class RollbackError(Exception):
    pass


def rollback_state(cfg, remove_block: bool = False) -> tuple[int, bytes]:
    data_dir = os.path.join(cfg.base.home, cfg.base.db_dir)
    db = open_kv(
        cfg.base.db_backend,
        os.path.join(data_dir, "chain.db"),
        surface="state",
    )
    try:
        state_store = StateStore(db)
        block_store = BlockStore(db)
        state = state_store.load()
        if state is None:
            raise RollbackError("no state found")
        height = state.last_block_height

        # Crash-mid-commit: block store is one ahead of state (block saved
        # but never applied).  Only discard the pending block — the state is
        # already correct (reference: state/rollback.go:29-36).
        if block_store.height() == height + 1:
            if remove_block:
                block_store.delete_latest_block()
            return height, state.app_hash
        if block_store.height() != height:
            raise RollbackError(
                f"block store height {block_store.height()} != state height {height}"
            )
        if height <= state.initial_height:
            raise RollbackError("cannot roll back the initial height")

        rollback_height = height - 1
        rollback_block = block_store.load_block_meta(rollback_height)
        if rollback_block is None:
            raise RollbackError(f"block meta {rollback_height} not found")
        # the block at `height` holds the app hash AFTER rollback_height
        latest = block_store.load_block_meta(height)
        if latest is None:
            raise RollbackError(f"block meta {height} not found")

        prev_vals = state_store.load_validators(rollback_height)
        vals = state_store.load_validators(height)
        next_vals = state_store.load_validators(height + 1)
        params = state_store.load_consensus_params(height)
        if vals is None or next_vals is None:
            raise RollbackError("validator sets for rollback not found")

        new_state = State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=rollback_block.header.height,
            last_block_id=rollback_block.block_id,
            last_block_time=rollback_block.header.time,
            validators=vals,
            next_validators=next_vals,
            last_validators=prev_vals,
            last_height_validators_changed=state.last_height_validators_changed,
            consensus_params=params or state.consensus_params,
            last_height_consensus_params_changed=state.last_height_consensus_params_changed,
            last_results_hash=latest.header.last_results_hash,
            app_hash=latest.header.app_hash,
            version_app=state.version_app,
        )
        state_store.save(new_state)
        if remove_block:
            block_store.delete_latest_block()
        return new_state.last_block_height, new_state.app_hash
    finally:
        db.close()
