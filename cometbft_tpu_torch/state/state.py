"""Consensus state snapshot (reference: state/state.go).

``State`` is everything consensus needs between blocks: the last block info,
current/next/last validator sets, consensus params and app hash.  Immutable
by convention — ``apply`` steps produce new copies.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field, replace
from typing import Optional

from cometbft_tpu_torch.crypto import keys as ck
from cometbft_tpu_torch.types.basic import BlockID, Timestamp
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.version import BLOCK_PROTOCOL


@dataclass
class State:
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time: Timestamp
    validators: ValidatorSet
    next_validators: ValidatorSet
    last_validators: Optional[ValidatorSet]
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_height_consensus_params_changed: int
    last_results_hash: bytes
    app_hash: bytes
    version_app: int = 0

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy(),
            next_validators=self.next_validators.copy(),
            last_validators=self.last_validators.copy()
            if self.last_validators
            else None,
        )

    def is_empty(self) -> bool:
        return len(self.validators) == 0

    # -- serialization (JSON; not consensus-critical) ---------------------

    @staticmethod
    def _vals_to_json(vals: Optional[ValidatorSet]):
        if vals is None:
            return None
        return {
            "validators": [
                {
                    "pub_key": base64.b64encode(v.pub_key.bytes()).decode(),
                    "key_type": v.pub_key.type_,
                    "power": v.voting_power,
                    "priority": v.proposer_priority,
                }
                for v in vals.validators
            ],
            "proposer": base64.b64encode(vals.get_proposer().address).decode()
            if len(vals) > 0
            else None,
        }

    @staticmethod
    def _vals_from_json(doc) -> Optional[ValidatorSet]:
        if doc is None:
            return None
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [
            Validator(
                pub_key=ck.pub_key_from_type(
                    v.get("key_type", "ed25519"), base64.b64decode(v["pub_key"])
                ),
                voting_power=v["power"],
                proposer_priority=v["priority"],
            )
            for v in doc["validators"]
        ]
        vs._total_voting_power = None
        vs._addr_index = None
        vs.proposer = None
        if doc.get("proposer"):
            addr = base64.b64decode(doc["proposer"])
            found = vs.get_by_address(addr)
            vs.proposer = found[1] if found else None
        return vs

    def to_json(self) -> bytes:
        doc = {
            "chain_id": self.chain_id,
            "initial_height": self.initial_height,
            "last_block_height": self.last_block_height,
            "last_block_id": {
                "hash": self.last_block_id.hash.hex(),
                "parts_total": self.last_block_id.part_set_header.total,
                "parts_hash": self.last_block_id.part_set_header.hash.hex(),
            },
            "last_block_time": [
                self.last_block_time.seconds,
                self.last_block_time.nanos,
            ],
            "validators": self._vals_to_json(self.validators),
            "next_validators": self._vals_to_json(self.next_validators),
            "last_validators": self._vals_to_json(self.last_validators),
            "last_height_validators_changed": self.last_height_validators_changed,
            "consensus_params": _params_to_json(self.consensus_params),
            "last_height_consensus_params_changed": self.last_height_consensus_params_changed,
            "last_results_hash": self.last_results_hash.hex(),
            "app_hash": self.app_hash.hex(),
            "version_app": self.version_app,
        }
        return json.dumps(doc, sort_keys=True).encode()

    @staticmethod
    def from_json(raw: bytes) -> "State":
        from cometbft_tpu_torch.types.basic import PartSetHeader

        doc = json.loads(raw.decode())
        lbi = doc["last_block_id"]
        return State(
            chain_id=doc["chain_id"],
            initial_height=doc["initial_height"],
            last_block_height=doc["last_block_height"],
            last_block_id=BlockID(
                hash=bytes.fromhex(lbi["hash"]),
                part_set_header=PartSetHeader(
                    total=lbi["parts_total"], hash=bytes.fromhex(lbi["parts_hash"])
                ),
            ),
            last_block_time=Timestamp(*doc["last_block_time"]),
            validators=State._vals_from_json(doc["validators"]),
            next_validators=State._vals_from_json(doc["next_validators"]),
            last_validators=State._vals_from_json(doc["last_validators"]),
            last_height_validators_changed=doc["last_height_validators_changed"],
            consensus_params=_params_from_json(doc["consensus_params"]),
            last_height_consensus_params_changed=doc[
                "last_height_consensus_params_changed"
            ],
            last_results_hash=bytes.fromhex(doc["last_results_hash"]),
            app_hash=bytes.fromhex(doc["app_hash"]),
            version_app=doc.get("version_app", 0),
        )


def _params_to_json(p: ConsensusParams):
    return {
        "block": {"max_bytes": p.block.max_bytes, "max_gas": p.block.max_gas},
        "evidence": {
            "max_age_num_blocks": p.evidence.max_age_num_blocks,
            "max_age_duration_ns": p.evidence.max_age_duration_ns,
            "max_bytes": p.evidence.max_bytes,
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "feature": {
            "vote_extensions_enable_height": p.feature.vote_extensions_enable_height,
            "pbts_enable_height": p.feature.pbts_enable_height,
        },
        "synchrony": {
            "precision_ns": p.synchrony.precision_ns,
            "message_delay_ns": p.synchrony.message_delay_ns,
        },
    }


def _params_from_json(doc) -> ConsensusParams:
    from cometbft_tpu_torch.types.params import (
        BlockParams,
        EvidenceParams,
        FeatureParams,
        SynchronyParams,
        ValidatorParams,
    )

    return ConsensusParams(
        block=BlockParams(**doc["block"]),
        evidence=EvidenceParams(**doc["evidence"]),
        validator=ValidatorParams(pub_key_types=tuple(doc["validator"]["pub_key_types"])),
        feature=FeatureParams(**doc["feature"]),
        synchrony=SynchronyParams(**doc["synchrony"]),
    )


def state_from_genesis(gdoc: GenesisDoc) -> State:
    """Reference: state/state.go MakeGenesisState."""
    gdoc.validate_and_complete()
    val_set = gdoc.validator_set()
    next_vals = val_set.copy_increment_proposer_priority(1)
    return State(
        chain_id=gdoc.chain_id,
        initial_height=gdoc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=gdoc.genesis_time,
        validators=val_set,
        next_validators=next_vals,
        last_validators=None,
        last_height_validators_changed=gdoc.initial_height,
        consensus_params=gdoc.consensus_params,
        last_height_consensus_params_changed=gdoc.initial_height,
        last_results_hash=b"",
        app_hash=gdoc.app_hash,
        version_app=0,
    )
