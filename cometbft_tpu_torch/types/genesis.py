"""Genesis document (reference: types/genesis.go)."""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.crypto import keys as ck
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types.basic import Timestamp
from cometbft_tpu_torch.types.params import ConsensusParams, default_consensus_params
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key: object
    power: int
    name: str = ""

    @property
    def address(self) -> bytes:
        return self.pub_key.address()


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp)
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=default_consensus_params)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> None:
        if not self.chain_id:
            raise ValueError("genesis doc must include chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("chain_id too long")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        err = self.consensus_params.validate()
        if err:
            raise ValueError(f"invalid consensus params: {err}")
        for v in self.validators:
            if v.power < 0:
                raise ValueError("genesis validator cannot have negative power")
        if self.genesis_time.is_zero():
            self.genesis_time = Timestamp.now()

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [Validator(v.pub_key, v.power) for v in self.validators]
        )

    # -- JSON persistence --------------------------------------------------

    def to_json(self) -> str:
        doc = {
            "genesis_time": {
                "seconds": self.genesis_time.seconds,
                "nanos": self.genesis_time.nanos,
            },
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": {
                "block": {
                    "max_bytes": str(self.consensus_params.block.max_bytes),
                    "max_gas": str(self.consensus_params.block.max_gas),
                },
                "evidence": {
                    "max_age_num_blocks": str(
                        self.consensus_params.evidence.max_age_num_blocks
                    ),
                    "max_age_duration": str(
                        self.consensus_params.evidence.max_age_duration_ns
                    ),
                    "max_bytes": str(self.consensus_params.evidence.max_bytes),
                },
                "validator": {
                    "pub_key_types": list(
                        self.consensus_params.validator.pub_key_types
                    ),
                },
                "feature": {
                    "vote_extensions_enable_height": str(
                        self.consensus_params.feature.vote_extensions_enable_height
                    ),
                    "pbts_enable_height": str(
                        self.consensus_params.feature.pbts_enable_height
                    ),
                },
            },
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {
                        "type": v.pub_key.type_,
                        "value": base64.b64encode(v.pub_key.bytes()).decode(),
                    },
                    "power": str(v.power),
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
            "app_state": json.loads(self.app_state.decode() or "{}"),
        }
        return json.dumps(doc, indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "GenesisDoc":
        doc = json.loads(text)
        gt = doc.get("genesis_time", {})
        params = doc.get("consensus_params", {})
        block = params.get("block", {})
        evidence = params.get("evidence", {})
        validator = params.get("validator", {})
        feature = params.get("feature", {})
        from cometbft_tpu_torch.types.params import (
            BlockParams,
            EvidenceParams,
            FeatureParams,
            ValidatorParams,
        )

        cp = ConsensusParams(
            block=BlockParams(
                max_bytes=int(block.get("max_bytes", 4 * 1024 * 1024)),
                max_gas=int(block.get("max_gas", -1)),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=int(evidence.get("max_age_num_blocks", 100000)),
                max_age_duration_ns=int(
                    evidence.get("max_age_duration", 48 * 3600 * 10**9)
                ),
                max_bytes=int(evidence.get("max_bytes", 1024 * 1024)),
            ),
            validator=ValidatorParams(
                pub_key_types=tuple(validator.get("pub_key_types", ["ed25519"]))
            ),
            feature=FeatureParams(
                vote_extensions_enable_height=int(
                    feature.get("vote_extensions_enable_height", 0)
                ),
                pbts_enable_height=int(feature.get("pbts_enable_height", 0)),
            ),
        )
        gdoc = GenesisDoc(
            chain_id=doc["chain_id"],
            genesis_time=Timestamp(gt.get("seconds", 0), gt.get("nanos", 0)),
            initial_height=int(doc.get("initial_height", 1)),
            consensus_params=cp,
            validators=[
                GenesisValidator(
                    pub_key=ck.pub_key_from_type(
                        v["pub_key"]["type"],
                        base64.b64decode(v["pub_key"]["value"]),
                    ),
                    power=int(v["power"]),
                    name=v.get("name", ""),
                )
                for v in doc.get("validators", [])
            ],
            app_hash=bytes.fromhex(doc.get("app_hash", "")),
            app_state=json.dumps(doc.get("app_state", {})).encode(),
        )
        gdoc.validate_and_complete()
        return gdoc
