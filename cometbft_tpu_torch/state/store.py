"""State store (reference: state/store.go:230).

Persists the consensus State, historical validator sets, consensus params and
FinalizeBlock responses, with pruning.
"""

from __future__ import annotations

import json
from typing import Optional

from cometbft_tpu_torch.state.state import (
    State,
    _params_from_json,
    _params_to_json,
)
from cometbft_tpu_torch.store.kv import KVStore

_K_STATE = b"stateKey"


def _k_vals(height: int) -> bytes:
    return b"validatorsKey:" + height.to_bytes(8, "big")


def _k_params(height: int) -> bytes:
    return b"consensusParamsKey:" + height.to_bytes(8, "big")


def _k_abci_resp(height: int) -> bytes:
    return b"abciResponsesKey:" + height.to_bytes(8, "big")


class StateStore:
    def __init__(self, db: KVStore):
        self._db = db

    # -- state ------------------------------------------------------------

    def save(self, state: State) -> None:
        """Persist state plus the validator/params entries for lookup
        (reference: state/store.go save)."""
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:
            # bootstrap: also save validators for the initial height
            self._save_validators(next_height, state.validators)
        self._save_validators(next_height + 1, state.next_validators)
        self._save_params(next_height, state.consensus_params)
        self._db.set(_K_STATE, state.to_json())

    def load(self) -> Optional[State]:
        raw = self._db.get(_K_STATE)
        return State.from_json(raw) if raw else None

    def bootstrap(self, state: State) -> None:
        """Reference: state/store.go Bootstrap (used by statesync)."""
        height = state.last_block_height + 1
        if state.last_validators is not None and state.last_block_height > 0:
            self._save_validators(state.last_block_height, state.last_validators)
        self._save_validators(height, state.validators)
        self._save_validators(height + 1, state.next_validators)
        self._save_params(height, state.consensus_params)
        self._db.set(_K_STATE, state.to_json())

    # -- validators -------------------------------------------------------

    def _save_validators(self, height: int, vals) -> None:
        self._db.set(
            _k_vals(height), json.dumps(State._vals_to_json(vals)).encode()
        )

    def load_validators(self, height: int):
        """Reference: state/store.go:870 LoadValidators."""
        raw = self._db.get(_k_vals(height))
        if raw is None:
            return None
        return State._vals_from_json(json.loads(raw.decode()))

    # -- consensus params -------------------------------------------------

    def _save_params(self, height: int, params) -> None:
        self._db.set(
            _k_params(height), json.dumps(_params_to_json(params)).encode()
        )

    def load_consensus_params(self, height: int):
        raw = self._db.get(_k_params(height))
        if raw is None:
            return None
        return _params_from_json(json.loads(raw.decode()))

    # -- finalize-block responses ----------------------------------------

    def save_finalize_block_response(self, height: int, response_json: bytes):
        """Reference: state/store.go:739 SaveFinalizeBlockResponse."""
        self._db.set(_k_abci_resp(height), response_json)

    def load_finalize_block_response(self, height: int) -> Optional[bytes]:
        return self._db.get(_k_abci_resp(height))

    def delete_finalize_block_response(self, height: int) -> bool:
        """Used by the background pruner (results retain height); returns
        True if an entry existed."""
        key = _k_abci_resp(height)
        if self._db.get(key) is None:
            return False
        self._db.delete(key)
        return True

    def save_retain_heights(self, retain) -> None:
        """Persist data-companion retain heights so they survive restarts
        (reference persists them in the state store for the same reason:
        a companion's hold on blocks must not be lost on reboot)."""
        import json as _json

        self._db.set(
            b"companion_retain",
            _json.dumps(
                {
                    "companion_retain": retain.companion_retain,
                    "companion_results_retain": retain.companion_results_retain,
                    "tx_index_retain": retain.tx_index_retain,
                    "block_index_retain": retain.block_index_retain,
                }
            ).encode(),
        )

    def load_retain_heights(self, retain) -> None:
        """Restore persisted companion retain heights into ``retain``."""
        import json as _json

        raw = self._db.get(b"companion_retain")
        if raw is None:
            return
        doc = _json.loads(raw.decode())
        retain.companion_retain = int(doc.get("companion_retain", 0))
        retain.companion_results_retain = int(
            doc.get("companion_results_retain", 0)
        )
        retain.tx_index_retain = int(doc.get("tx_index_retain", 0))
        retain.block_index_retain = int(doc.get("block_index_retain", 0))

    # -- pruning ----------------------------------------------------------

    def prune_states(
        self, from_height: int, to_height: int, include_responses: bool = True
    ) -> int:
        """Prune [from, to) validator/params (and, unless a data companion
        governs them separately, finalize-block response) entries
        (reference: state/store.go:427 PruneStates / PruneABCIResponses)."""
        deletes = []
        for h in range(from_height, to_height):
            deletes += [_k_vals(h), _k_params(h)]
            if include_responses:
                deletes.append(_k_abci_resp(h))
        self._db.write_batch([], deletes)
        return to_height - from_height
