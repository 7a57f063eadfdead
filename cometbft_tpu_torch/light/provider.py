"""Light-block providers (reference: light/provider/).

``Provider`` is the interface; ``HTTPProvider`` fetches signed headers and
validator sets from a full node's JSON-RPC (``commit`` + ``validators``
routes) and reassembles them into LightBlocks.
"""

from __future__ import annotations

import base64
import calendar
import json
import time
import urllib.request
from typing import Optional

from cometbft_tpu_torch.crypto.keys import pub_key_from_type
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, Timestamp
from cometbft_tpu_torch.types.block import Commit, ConsensusVersion, Header
from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import CommitSig


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    pass


class ErrNoResponse(ProviderError):
    pass


class Provider:
    """Reference: light/provider/provider.go."""

    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """height=0 means latest."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        raise NotImplementedError

    def consensus_params(self, height: int):
        """Consensus params at ``height`` (reference:
        statesync/stateprovider.go ConsensusParams)."""
        raise NotImplementedError

    def id(self) -> str:
        return repr(self)


def _parse_ts(s: str) -> Timestamp:
    base, _, frac = s.rstrip("Z").partition(".")
    secs = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
    nanos = int((frac or "0").ljust(9, "0")[:9])
    return Timestamp(seconds=secs, nanos=nanos)


def _parse_header(d: dict) -> Header:
    return Header(
        version=ConsensusVersion(
            block=int(d["version"]["block"]), app=int(d["version"]["app"])
        ),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=_parse_ts(d["time"]),
        last_block_id=_parse_block_id(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        next_validators_hash=bytes.fromhex(d["next_validators_hash"]),
        consensus_hash=bytes.fromhex(d["consensus_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        evidence_hash=bytes.fromhex(d["evidence_hash"]),
        proposer_address=bytes.fromhex(d["proposer_address"]),
    )


def _parse_block_id(d: dict) -> BlockID:
    return BlockID(
        hash=bytes.fromhex(d["hash"]),
        part_set_header=PartSetHeader(
            total=int(d["parts"]["total"]), hash=bytes.fromhex(d["parts"]["hash"])
        ),
    )


def _parse_commit(d: dict) -> Commit:
    return Commit(
        height=int(d["height"]),
        round_=int(d["round"]),
        block_id=_parse_block_id(d["block_id"]),
        signatures=[
            CommitSig(
                block_id_flag=int(s["block_id_flag"]),
                validator_address=bytes.fromhex(s["validator_address"]),
                timestamp=_parse_ts(s["timestamp"]),
                signature=base64.b64decode(s["signature"]) if s["signature"] else b"",
            )
            for s in d["signatures"]
        ],
    )


_KEY_TYPES = {
    "tendermint/PubKeyEd25519": "ed25519",
    "tendermint/PubKeySecp256k1": "secp256k1",
}


def _parse_validators(items: list[dict]) -> ValidatorSet:
    vals = []
    for v in items:
        wire_type = v["pub_key"]["type"]
        key_type = _KEY_TYPES.get(wire_type)
        if key_type is None:
            raise ProviderError(f"unsupported validator key type {wire_type!r}")
        pub = pub_key_from_type(key_type, base64.b64decode(v["pub_key"]["value"]))
        vals.append(
            Validator(
                pub_key=pub,
                voting_power=int(v["voting_power"]),
                proposer_priority=int(v.get("proposer_priority", 0)),
            )
        )
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = vals
    vs.proposer = None
    vs._total_voting_power = None
    vs._addr_index = None
    return vs


class HTTPProvider(Provider):
    """Reference: light/provider/http/http.go."""

    def __init__(self, chain_id: str, base_url: str, timeout: float = 10.0):
        self._chain_id = chain_id
        # accept the reference config's address styles: bare host:port and
        # tcp:// both mean plain HTTP (config/config.go rpc_servers)
        if base_url.startswith("tcp://"):
            base_url = "http://" + base_url[len("tcp://"):]
        elif "://" not in base_url:
            base_url = "http://" + base_url
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def chain_id(self) -> str:
        return self._chain_id

    def id(self) -> str:
        return self.base_url

    def _rpc(self, method: str, params: dict):
        body = json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.base_url + "/",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                doc = json.loads(resp.read())
        except OSError as e:
            raise ErrNoResponse(f"{self.base_url}: {e}") from e
        if "error" in doc:
            msg = doc["error"].get("message", "")
            if "not found" in msg:
                raise ErrLightBlockNotFound(msg)
            raise ProviderError(msg)
        return doc["result"]

    def light_block(self, height: int) -> LightBlock:
        params = {} if height == 0 else {"height": str(height)}
        commit_res = self._rpc("commit", params)
        sh = SignedHeader(
            header=_parse_header(commit_res["signed_header"]["header"]),
            commit=_parse_commit(commit_res["signed_header"]["commit"]),
        )
        # paginate validators
        items: list[dict] = []
        page = 1
        while True:
            vres = self._rpc(
                "validators",
                {
                    "height": str(sh.height),
                    "page": page,
                    "per_page": 100,
                },
            )
            items.extend(vres["validators"])
            if len(items) >= int(vres["total"]) or not vres["validators"]:
                break
            page += 1
        lb = LightBlock(signed_header=sh, validator_set=_parse_validators(items))
        err = lb.validate_basic(self._chain_id)
        if err:
            raise ProviderError(f"invalid light block from {self.base_url}: {err}")
        return lb

    def report_evidence(self, ev) -> None:
        from cometbft_tpu_torch.types import codec

        raw = base64.b64encode(codec.encode_evidence(ev)).decode()
        try:
            self._rpc("broadcast_evidence", {"evidence": raw})
        except ProviderError:
            pass

    def consensus_params(self, height: int):
        from cometbft_tpu_torch.state.state import _params_from_json

        res = self._rpc("consensus_params", {"height": str(height)})
        return _params_from_json(res["consensus_params"])


class NodeProvider(Provider):
    """In-process provider reading a Node's stores directly (test fixture +
    local statesync; reference analog: light/provider/mock)."""

    def __init__(self, node):
        self.node = node

    def chain_id(self) -> str:
        return self.node.genesis_doc.chain_id

    def id(self) -> str:
        return f"node:{self.node.node_key.node_id[:12]}"

    def light_block(self, height: int) -> LightBlock:
        bs = self.node.block_store
        h = height or bs.height()
        meta = bs.load_block_meta(h)
        commit = bs.load_block_commit(h) or bs.load_seen_commit(h)
        vals = self.node.state_store.load_validators(h)
        if meta is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(f"height {h}")
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def report_evidence(self, ev) -> None:
        from cometbft_tpu_torch.types.evidence import EvidenceError

        try:
            self.node.evidence_pool.add_evidence(ev)
        except EvidenceError as e:
            raise ProviderError(f"evidence rejected: {e}") from e

    def consensus_params(self, height: int):
        params = self.node.state_store.load_consensus_params(height)
        if params is None:
            params = self.node.consensus.state.consensus_params
        return params

