"""JSON-RPC core routes (reference: rpc/core/routes.go:12-57).

``Environment`` holds handles into the running node; each public method is
one RPC route returning JSON-serializable dicts in the reference's wire
shapes (hashes hex, bytes base64, ints as strings where the reference uses
int64-as-string JSON).

The port's copy of the JAX package's ``rpc/core.py``: the same routes and
the same JSON.  ``tx?prove=true`` proves through the port's
``proofserve.prove_tx`` (the tree kernel on the card).  The two debug
routes read ``libs/tracing`` and ``libs/blackbox``, host counters only.
"""

from __future__ import annotations

import base64
import time
from typing import Optional

from cometbft_tpu_torch.abci import types as at
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs import storage_stats
from cometbft_tpu_torch.libs.pubsub import Query
from cometbft_tpu_torch.mempool.clist_mempool import MempoolError, TxInCacheError
from cometbft_tpu_torch.state.execution import fbr_from_json
from cometbft_tpu_torch.types import events as tev
from cometbft_tpu_torch.version import CMT_SEMVER, BLOCK_PROTOCOL, P2P_PROTOCOL


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _ts_json(ts) -> str:
    t = time.gmtime(ts.seconds)
    return time.strftime("%Y-%m-%dT%H:%M:%S", t) + f".{ts.nanos:09d}Z"


def _block_id_json(bid) -> dict:
    return {
        "hash": _hex(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": _hex(bid.part_set_header.hash),
        },
    }


def _header_json(h) -> dict:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": _ts_json(h.time),
        "last_block_id": _block_id_json(h.last_block_id),
        "last_commit_hash": _hex(h.last_commit_hash),
        "data_hash": _hex(h.data_hash),
        "validators_hash": _hex(h.validators_hash),
        "next_validators_hash": _hex(h.next_validators_hash),
        "consensus_hash": _hex(h.consensus_hash),
        "app_hash": _hex(h.app_hash),
        "last_results_hash": _hex(h.last_results_hash),
        "evidence_hash": _hex(h.evidence_hash),
        "proposer_address": _hex(h.proposer_address),
    }


def _commit_json(c) -> dict:
    return {
        "height": str(c.height),
        "round": c.round_,
        "block_id": _block_id_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": cs.block_id_flag,
                "validator_address": _hex(cs.validator_address),
                "timestamp": _ts_json(cs.timestamp),
                "signature": _b64(cs.signature) if cs.signature else None,
            }
            for cs in c.signatures
        ],
    }


def _evidence_json(ev) -> dict:
    from cometbft_tpu_torch.types import codec as _codec

    return {
        "type": ev.TYPE,
        "height": str(ev.height),
        "time": _ts_json(ev.time),
        "total_voting_power": str(ev.total_voting_power),
        "bytes": _b64(_codec.encode_evidence(ev)),
    }


class QuotedString(str):
    """A URI argument that arrived double-quoted: a raw string literal,
    never hex/base64 (reference: rpc/jsonrpc/server/uri.go)."""


def _bytes_arg(v) -> bytes:
    """Decode a bytes-typed RPC argument with the reference's conventions
    (rpc/jsonrpc/server/uri.go): URI quoted string -> raw bytes of the
    string, 0x/hex -> hex decode, otherwise base64 (JSON-RPC body form)."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if v is None or v == "":
        return b""
    if isinstance(v, QuotedString):
        return str(v).encode()
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1].encode()
    h = v[2:] if v.startswith("0x") else v
    try:
        return bytes.fromhex(h)
    except ValueError:
        pass
    return base64.b64decode(v)


def _block_json(block) -> dict:
    return {
        "header": _header_json(block.header),
        "data": {"txs": [_b64(tx) for tx in block.data.txs]},
        "evidence": {"evidence": [_evidence_json(ev) for ev in block.evidence]},
        "last_commit": _commit_json(block.last_commit),
    }


def _tx_result_json(r: at.ExecTxResult) -> dict:
    return {
        "code": r.code,
        "data": _b64(r.data),
        "log": r.log,
        "info": r.info,
        "gas_wanted": str(r.gas_wanted),
        "gas_used": str(r.gas_used),
        "events": [
            {
                "type": e.type_,
                "attributes": [
                    {"key": a.key, "value": a.value, "index": a.index}
                    for a in e.attributes
                ],
            }
            for e in r.events
        ],
        "codespace": r.codespace,
    }


class Environment:
    """Reference: rpc/core/env.go Environment."""

    # stored validator sets rendered for ``validators``, by height (a set
    # stored at a height never changes); a light client pages a 10,240-
    # validator set 100 at a time, and each page would otherwise decode
    # the whole set again
    _VALSET_CACHE = 8

    def __init__(self, node):
        self.node = node
        self._valset_items: dict = {}

    # -- info routes -------------------------------------------------------

    def health(self) -> dict:
        # A fail-stop storage fatal means a persistent surface halted this
        # node — liveness probes must see it (the HTTP server maps this
        # error to 503 on the health route).
        totals = storage_stats.snapshot()["totals"]
        if totals["fatal"]:
            raise RPCError(
                -32000,
                "node unhealthy: fail-stop storage fault",
                data=f"fatals={totals['fatals']}",
            )
        return {}

    def status(self) -> dict:
        node = self.node
        height = node.block_store.height()
        meta = node.block_store.load_block_meta(height) if height else None
        pv_addr = node.priv_validator.pub_key().address()
        state = node.consensus.state
        found = state.validators.get_by_address(pv_addr)
        val_info = {
            "address": _hex(pv_addr),
            "pub_key": {
                "type": "tendermint/PubKeyEd25519",
                "value": _b64(node.priv_validator.pub_key().bytes()),
            },
            "voting_power": str(found[1].voting_power if found else 0),
        }
        return {
            "node_info": {
                "id": node.node_key.node_id,
                "listen_addr": node.config.p2p.laddr,
                "network": node.genesis_doc.chain_id,
                "version": CMT_SEMVER,
                "protocol_version": {
                    "p2p": str(P2P_PROTOCOL),
                    "block": str(BLOCK_PROTOCOL),
                },
                "moniker": node.config.base.moniker,
            },
            "sync_info": {
                "latest_block_hash": _hex(meta.block_id.hash) if meta else "",
                "latest_app_hash": _hex(state.app_hash),
                "latest_block_height": str(height),
                "latest_block_time": _ts_json(meta.header.time)
                if meta
                else _ts_json(node.genesis_doc.genesis_time),
                "earliest_block_height": str(node.block_store.base()),
                "catching_up": False,
            },
            "validator_info": val_info,
        }

    def net_info(self) -> dict:
        sw = getattr(self.node, "switch", None)
        peers = []
        if sw is not None:
            for p in sw.peers_list():
                peers.append(
                    {
                        "node_info": {"id": p.node_id()},
                        "is_outbound": p.is_outbound,
                        "remote_ip": p.remote_ip(),
                    }
                )
        return {
            "listening": sw is not None,
            "listeners": [self.node.config.p2p.laddr],
            "n_peers": str(len(peers)),
            "peers": peers,
        }

    def genesis(self) -> dict:
        import json as _json

        return {"genesis": _json.loads(self.node.genesis_doc.to_json())}

    def genesis_chunked(self, chunk: int = 0) -> dict:
        data = self.node.genesis_doc.to_json().encode()
        size = 16 * 1024 * 1024
        chunks = [data[i : i + size] for i in range(0, len(data), size)] or [b""]
        if not 0 <= chunk < len(chunks):
            raise RPCError(-32603, f"chunk {chunk} out of range [0,{len(chunks)})")
        return {
            "chunk": str(chunk),
            "total": str(len(chunks)),
            "data": _b64(chunks[chunk]),
        }

    # -- block routes ------------------------------------------------------

    def _height_or_latest(self, height: Optional[int]) -> int:
        latest = self.node.block_store.height()
        if height is None or height <= 0:
            return latest
        if height < self.node.block_store.base() or height > latest:
            raise RPCError(-32603, f"height {height} not available")
        return height

    def block(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        block = self.node.block_store.load_block(h)
        meta = self.node.block_store.load_block_meta(h)
        if block is None:
            raise RPCError(-32603, f"block {h} not found")
        return {
            "block_id": _block_id_json(meta.block_id),
            "block": _block_json(block),
        }

    def block_by_hash(self, hash_: str) -> dict:
        raw = _bytes_arg(hash_)
        block = self.node.block_store.load_block_by_hash(raw)
        if block is None:
            raise RPCError(-32603, "block not found")
        return self.block(block.header.height)

    def header(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        meta = self.node.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"header {h} not found")
        return {"header": _header_json(meta.header)}

    def header_by_hash(self, hash_: str) -> dict:
        """Reference: rpc/core/blocks.go HeaderByHash:106-117 — an unknown
        hash returns a null header, not an error."""
        raw = _bytes_arg(hash_)
        meta = self.node.block_store.load_block_meta_by_hash(raw)
        if meta is None:
            return {"header": None}
        return {"header": _header_json(meta.header)}

    def commit(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        meta = self.node.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"block {h} not found")
        # The canonical commit for h is stored when block h+1 is saved; for
        # the head block fall back to the seen commit (reference:
        # rpc/core/blocks.go Commit — canonical=false in that case).
        commit = self.node.block_store.load_block_commit(h)
        canonical = commit is not None
        if commit is None:
            commit = self.node.block_store.load_seen_commit(h)
        if commit is None:
            raise RPCError(-32603, f"commit {h} not found")
        return {
            "signed_header": {
                "header": _header_json(meta.header),
                "commit": _commit_json(commit),
            },
            "canonical": canonical,
        }

    def block_results(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        raw = self.node.state_store.load_finalize_block_response(h)
        if raw is None:
            raise RPCError(-32603, f"no results for height {h}")
        res = fbr_from_json(raw)
        return {
            "height": str(h),
            "txs_results": [_tx_result_json(r) for r in res.tx_results],
            "finalize_block_events": [
                {"type": e.type_, "attributes": [
                    {"key": a.key, "value": a.value, "index": a.index}
                    for a in e.attributes]}
                for e in res.events
            ],
            "validator_updates": [
                {"pub_key_type": v.pub_key_type, "power": str(v.power)}
                for v in res.validator_updates
            ],
            "app_hash": _hex(res.app_hash),
        }

    def blockchain(self, min_height: int = 0, max_height: int = 0) -> dict:
        store = self.node.block_store
        latest = store.height()
        if max_height <= 0:
            max_height = latest
        max_height = min(max_height, latest)
        if min_height <= 0:
            min_height = max(1, max_height - 19)
        min_height = max(min_height, store.base())
        metas = []
        for h in range(max_height, min_height - 1, -1):
            m = store.load_block_meta(h)
            if m is not None:
                metas.append(
                    {
                        "block_id": _block_id_json(m.block_id),
                        "block_size": str(m.block_size),
                        "header": _header_json(m.header),
                        "num_txs": str(m.num_txs),
                    }
                )
        return {"last_height": str(latest), "block_metas": metas}

    def validators(
        self,
        height: Optional[int] = None,
        page: int = 1,
        per_page: int = 30,
    ) -> dict:
        h = self._height_or_latest(height)
        items = self._valset_items.get(h)
        if items is None:
            vals = self.node.state_store.load_validators(h)
            stored = vals is not None
            if not stored:
                vals = self.node.consensus.state.validators
            items = [
                {
                    "address": _hex(v.address),
                    "pub_key": {
                        "type": "tendermint/PubKeyEd25519",
                        "value": _b64(v.pub_key.bytes()),
                    },
                    "voting_power": str(v.voting_power),
                    "proposer_priority": str(v.proposer_priority),
                }
                for v in vals.validators
            ]
            if stored:
                while len(self._valset_items) >= self._VALSET_CACHE:
                    self._valset_items.pop(next(iter(self._valset_items)))
                self._valset_items[h] = items
        per_page = max(1, min(per_page, 100))
        start = (max(page, 1) - 1) * per_page
        return {
            "block_height": str(h),
            "validators": items[start : start + per_page],
            "count": str(len(items[start : start + per_page])),
            "total": str(len(items)),
        }

    def consensus_params(self, height: Optional[int] = None) -> dict:
        from cometbft_tpu_torch.state.state import _params_to_json

        h = self._height_or_latest(height)
        params = self.node.state_store.load_consensus_params(h)
        if params is None:
            params = self.node.consensus.state.consensus_params
        return {
            "block_height": str(h),
            "consensus_params": _params_to_json(params),
        }

    def consensus_state(self) -> dict:
        rs = self.node.consensus.get_round_state()
        return {
            "round_state": {
                "height/round/step": f"{rs.height}/{rs.round_}/{rs.step}",
                "height": str(rs.height),
                "round": rs.round_,
                "step": rs.step_name(),
                "proposal_block_hash": _hex(rs.proposal_block.hash())
                if rs.proposal_block
                else "",
                "locked_block_hash": _hex(rs.locked_block.hash())
                if rs.locked_block
                else "",
                "valid_block_hash": _hex(rs.valid_block.hash())
                if rs.valid_block
                else "",
            }
        }

    def dump_consensus_state(self) -> dict:
        rs = self.node.consensus.get_round_state()
        out = self.consensus_state()
        votes = []
        if rs.votes is not None:
            for r in range(rs.round_ + 1):
                pv = rs.votes.prevotes(r)
                pc = rs.votes.precommits(r)
                votes.append(
                    {
                        "round": r,
                        "prevotes_bit_array": str(pv.bit_array()) if pv else "",
                        "precommits_bit_array": str(pc.bit_array()) if pc else "",
                    }
                )
        out["round_state"]["height_vote_set"] = votes
        return out

    # -- ABCI routes -------------------------------------------------------

    def abci_info(self) -> dict:
        res = self.node.proxy_app.query.info()
        return {
            "response": {
                "data": res.data,
                "version": res.version,
                "app_version": str(res.app_version),
                "last_block_height": str(res.last_block_height),
                "last_block_app_hash": _b64(res.last_block_app_hash),
            }
        }

    def abci_query(
        self,
        path: str = "",
        data: str = "",
        height: int = 0,
        prove: bool = False,
    ) -> dict:
        raw = _bytes_arg(data)
        res = self.node.proxy_app.query.query(
            at.QueryRequest(data=raw, path=path, height=height, prove=prove)
        )
        return {
            "response": {
                "code": res.code,
                "log": res.log,
                "info": res.info,
                "index": str(res.index),
                "key": _b64(res.key),
                "value": _b64(res.value),
                "height": str(res.height),
                "codespace": res.codespace,
            }
        }

    # -- mempool routes ----------------------------------------------------

    def _check_tx_to_mempool(self, tx: bytes) -> at.CheckTxResponse:
        try:
            return self.node.mempool.check_tx(tx)
        except TxInCacheError:
            raise RPCError(-32603, "tx already exists in cache")
        except MempoolError as e:
            raise RPCError(-32603, f"mempool error: {e}")

    def broadcast_tx_async(self, tx: str) -> dict:
        raw = _bytes_arg(tx)
        import threading

        threading.Thread(
            target=lambda: self._try_check(raw), daemon=True
        ).start()
        return {"code": 0, "data": "", "log": "", "hash": _hex(tmhash.sum256(raw))}

    def _try_check(self, raw: bytes) -> None:
        try:
            self.node.mempool.check_tx(raw)
        except MempoolError:
            pass

    def broadcast_tx_sync(self, tx: str) -> dict:
        raw = _bytes_arg(tx)
        res = self._check_tx_to_mempool(raw)
        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "codespace": res.codespace,
            "hash": _hex(tmhash.sum256(raw)),
        }

    def broadcast_tx_commit(self, tx: str) -> dict:
        """CheckTx then wait for the tx to be committed (reference:
        rpc/core/mempool.go BroadcastTxCommit)."""
        raw = _bytes_arg(tx)
        tx_hash = tmhash.sum256(raw)
        q = Query.parse(
            f"{tev.EVENT_TYPE_KEY}='{tev.EVENT_TX}' AND "
            f"{tev.TX_HASH_KEY}='{_hex(tx_hash)}'"
        )
        import uuid

        subscriber = f"tx-commit-{uuid.uuid4().hex[:12]}"
        sub = self.node.event_bus.subscribe(subscriber, q, capacity=1)
        try:
            check_res = self._check_tx_to_mempool(raw)
            if not check_res.ok:
                return {
                    "check_tx": _tx_result_json(
                        at.ExecTxResult(code=check_res.code, log=check_res.log)
                    ),
                    "tx_result": _tx_result_json(at.ExecTxResult()),
                    "hash": _hex(tx_hash),
                    "height": "0",
                }
            timeout = self.node.config.rpc.timeout_broadcast_tx_commit_ms / 1000
            msg = sub.next(timeout=timeout)
            if msg is None:
                raise RPCError(-32603, "timed out waiting for tx to be included")
            ev: tev.EventDataTx = msg.data
            return {
                "check_tx": _tx_result_json(
                    at.ExecTxResult(code=check_res.code, log=check_res.log)
                ),
                "tx_result": _tx_result_json(ev.result),
                "hash": _hex(tx_hash),
                "height": str(ev.height),
            }
        finally:
            self.node.event_bus.unsubscribe_all(subscriber)

    def unconfirmed_txs(self, limit: int = 30) -> dict:
        txs = self.node.mempool.reap_max_txs(max(1, min(limit, 100)))
        return {
            "n_txs": str(len(txs)),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.size_bytes()),
            "txs": [_b64(tx) for tx in txs],
        }

    def num_unconfirmed_txs(self) -> dict:
        return {
            "n_txs": str(self.node.mempool.size()),
            "total": str(self.node.mempool.size()),
            "total_bytes": str(self.node.mempool.size_bytes()),
        }

    def unconfirmed_tx(self, hash_: str) -> dict:
        """A single queued tx by hash (reference: rpc/core/mempool.go
        UnconfirmedTx:189-197 — error only on an empty hash; an unknown
        hash returns a null tx)."""
        raw = _bytes_arg(hash_)
        if not raw:
            raise RPCError(-32602, "transaction hash cannot be empty")
        tx = self.node.mempool.get_tx_by_hash(raw)
        return {"tx": _b64(tx) if tx is not None else None}

    # -- unsafe routes (served only when config rpc.unsafe is set; the
    #    reference adds these via AddUnsafeRoutes, routes.go:59-64) -------

    @staticmethod
    def _addr_list(value, what: str) -> list:
        """Normalize an address-list param (JSON array, or a
        comma-separated string from the URI form) and validate every
        address up front — the reference returns ErrInvalidPeerAddr
        rather than dialing a partial list (rpc/core/net.go:50-86)."""
        from cometbft_tpu_torch.p2p.node_info import NetAddress

        if isinstance(value, str):
            value = [a for a in value.split(",") if a]
        if not isinstance(value, list) or not value:
            raise RPCError(-32602, f"no {what} provided")
        for a in value:
            if not isinstance(a, str):
                raise RPCError(-32602, f"{what} must be strings: {a!r}")
            try:
                NetAddress.parse(a)
            except Exception as e:  # noqa: BLE001
                raise RPCError(-32602, f"invalid {what} address {a!r}: {e}")
        return value

    def dial_seeds(self, seeds=None) -> dict:
        """Reference: rpc/core/net.go UnsafeDialSeeds:50-59."""
        addrs = self._addr_list(seeds, "seeds")
        sw = getattr(self.node, "switch", None)
        if sw is None:
            raise RPCError(-32603, "p2p switch unavailable")
        sw.dial_peers_async(addrs, persistent=False)
        return {"log": "Dialing seeds in progress. See /net_info for details"}

    def dial_peers(
        self,
        peers=None,
        persistent: bool = False,
        unconditional: bool = False,
        private: bool = False,
    ) -> dict:
        """Reference: rpc/core/net.go UnsafeDialPeers:61-86 (the
        unconditional/private markers are accepted for wire parity; this
        switch tracks persistence only)."""
        addrs = self._addr_list(peers, "peers")
        sw = getattr(self.node, "switch", None)
        if sw is None:
            raise RPCError(-32603, "p2p switch unavailable")
        sw.dial_peers_async(addrs, persistent=bool(persistent))
        return {"log": "Dialing peers in progress. See /net_info for details"}

    def unsafe_flush_mempool(self) -> dict:
        """Reference: rpc/core/dev.go UnsafeFlushMempool:8-12."""
        self.node.mempool.flush()
        return {}

    def check_tx(self, tx: str) -> dict:
        raw = _bytes_arg(tx)
        res = self.node.proxy_app.mempool.check_tx(at.CheckTxRequest(tx=raw))
        return {"code": res.code, "log": res.log, "gas_wanted": str(res.gas_wanted)}

    # -- tx lookup (via indexer when present) ------------------------------

    def _tx_loader(self, height: int):
        """Block-store tx loader for the proof plane (None = unknown
        height — pruned or not yet committed)."""
        blk = self.node.block_store.load_block(int(height))
        if blk is None:
            return None
        return list(blk.data.txs)

    def _tx_proof_json(self, result) -> Optional[dict]:
        """ResultTx.Proof JSON (reference: rpc/core/tx.go Tx +
        types.TxProof): the inclusion proof of ``result.tx`` against the
        committed block's ``data_hash``.  Coalesced through the proof
        server when active; serial otherwise — byte-identical."""
        from cometbft_tpu_torch import proofserve

        got = proofserve.prove_tx(
            self._tx_loader, result.height, result.index
        )
        if got is None:
            return None
        root, proof = got
        return {
            "root_hash": _hex(root),
            "data": _b64(result.tx),
            "proof": {
                "total": str(proof.total),
                "index": str(proof.index),
                "leaf_hash": _b64(proof.leaf_hash),
                "aunts": [_b64(a) for a in proof.aunts],
            },
        }

    def tx(self, hash_: str, prove: bool = False) -> dict:
        indexer = getattr(self.node, "tx_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled")
        raw_hash = _bytes_arg(hash_)
        result = indexer.get(raw_hash)
        if result is None:
            raise RPCError(-32603, f"tx {hash_} not found")
        doc = result.to_json()
        if prove:
            doc["proof"] = self._tx_proof_json(result)
        return doc

    def tx_search(
        self,
        query: str,
        prove: bool = False,
        page: int = 1,
        per_page: int = 30,
        order_by: str = "asc",
    ) -> dict:
        indexer = getattr(self.node, "tx_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled")
        results = indexer.search(Query.parse(query))
        if order_by == "desc":
            results = list(reversed(results))
        per_page = max(1, min(per_page, 100))
        start = (max(page, 1) - 1) * per_page
        window = results[start : start + per_page]
        txs = []
        for r in window:
            doc = r.to_json()
            if prove:
                doc["proof"] = self._tx_proof_json(r)
            txs.append(doc)
        return {
            "txs": txs,
            "total_count": str(len(results)),
        }

    def block_search(
        self, query: str, page: int = 1, per_page: int = 30, order_by: str = "asc"
    ) -> dict:
        indexer = getattr(self.node, "block_indexer", None)
        if indexer is None:
            raise RPCError(-32603, "block indexing is disabled")
        heights = indexer.search(Query.parse(query))
        if order_by == "desc":
            heights = list(reversed(heights))
        per_page = max(1, min(per_page, 100))
        start = (max(page, 1) - 1) * per_page
        out = []
        for h in heights[start : start + per_page]:
            out.append(self.block(h))
        return {"blocks": out, "total_count": str(len(heights))}

    # -- observability (docs/observability.md) -----------------------------

    def debug_verify_trace(self, spans: int = 256, rounds: int = 8) -> dict:
        """One JSON document snapshotting the verify pipeline: flight-
        recorder ring tail + per-stage latency summary + the last-K merged
        consensus-round timelines (per-step p50/p99, quorum-arrival times,
        commit-to-proposal trace linkage) + health (breaker states,
        signature-cache hit rates, scheduler queue, warm-boot progress).
        Served as ``/debug/verify_trace`` (GET) and the
        ``debug_verify_trace`` JSON-RPC method; the ``cmd trace`` CLI
        renders it.  Every read is host counters and never touches CUDA —
        this endpoint must work exactly when the node (or its card) is
        sickest."""
        from cometbft_tpu_torch.libs import tracing

        doc = tracing.trace_document(
            max_spans=max(0, min(int(spans), 4096)),
            rounds=max(0, min(int(rounds), 256)),
        )
        node = self.node
        ctx: dict = {}
        try:
            ctx["latest_block_height"] = str(node.block_store.height())
        except Exception:  # noqa: BLE001 — health must render regardless
            pass
        try:
            ctx["consensus_height"] = str(node.consensus.rs.height)
        except Exception:  # noqa: BLE001
            pass
        doc["node"] = ctx
        return doc

    def debug_postmortem(self) -> dict:
        """The node's crash forensics: the previous run's black-box
        postmortem digest (decoded at boot — ``unclean_shutdown`` means
        the last process died without writing its clean-close sentinel)
        plus the live journal's counters.  Served as ``/debug/postmortem``
        (GET) and the ``debug_postmortem`` JSON-RPC method; it never
        touches CUDA, like every forensic surface."""
        from cometbft_tpu_torch.libs import blackbox

        boot = getattr(self.node, "boot_postmortem", None)
        doc: dict = {
            "blackbox": "on" if blackbox.enabled() else "off",
            "unclean_shutdown": bool(boot and boot.get("unclean_shutdown")),
            "boot": boot or {},
        }
        stats = blackbox.journal_stats()
        if stats is not None:
            doc["journal"] = stats
        return doc

    def broadcast_evidence(self, evidence) -> dict:
        """Reference: rpc/core/evidence.go BroadcastEvidence.  ``evidence``
        is the proto-encoded evidence (base64/hex/quoted per _bytes_arg)."""
        from cometbft_tpu_torch.types import codec as _codec
        from cometbft_tpu_torch.types.evidence import EvidenceError

        pool = getattr(self.node, "evidence_pool", None)
        if pool is None:
            raise RPCError(-32603, "evidence pool is disabled")
        try:
            ev = _codec.decode_evidence(_bytes_arg(evidence))
        except (ValueError, KeyError) as e:
            raise RPCError(-32602, f"undecodable evidence: {e}") from e
        try:
            pool.add_evidence(ev)
        except EvidenceError as e:
            raise RPCError(-32603, f"evidence rejected: {e}") from e
        return {"hash": _hex(ev.hash())}


# route name -> method name (reference: rpc/core/routes.go)
ROUTES = {
    "health": "health",
    "status": "status",
    "net_info": "net_info",
    "genesis": "genesis",
    "genesis_chunked": "genesis_chunked",
    "blockchain": "blockchain",
    "block": "block",
    "block_by_hash": "block_by_hash",
    "block_results": "block_results",
    "header": "header",
    "header_by_hash": "header_by_hash",
    "commit": "commit",
    "validators": "validators",
    "consensus_params": "consensus_params",
    "consensus_state": "consensus_state",
    "dump_consensus_state": "dump_consensus_state",
    "abci_info": "abci_info",
    "abci_query": "abci_query",
    "broadcast_tx_async": "broadcast_tx_async",
    "broadcast_tx_sync": "broadcast_tx_sync",
    "broadcast_tx_commit": "broadcast_tx_commit",
    "unconfirmed_txs": "unconfirmed_txs",
    "num_unconfirmed_txs": "num_unconfirmed_txs",
    "unconfirmed_tx": "unconfirmed_tx",
    "check_tx": "check_tx",
    "tx": "tx",
    "tx_search": "tx_search",
    "block_search": "block_search",
    "broadcast_evidence": "broadcast_evidence",
    # verify-pipeline flight recorder (docs/observability.md); the slash
    # alias serves the conventional GET /debug/verify_trace path
    "debug_verify_trace": "debug_verify_trace",
    "debug/verify_trace": "debug_verify_trace",
    # black-box crash forensics (boot postmortem digest + live journal)
    "debug_postmortem": "debug_postmortem",
    "debug/postmortem": "debug_postmortem",
}

# Served only when config rpc.unsafe is true (reference AddUnsafeRoutes,
# rpc/core/routes.go:59-64); the server refuses them otherwise.
UNSAFE_ROUTES = {
    "dial_seeds": "dial_seeds",
    "dial_peers": "dial_peers",
    "unsafe_flush_mempool": "unsafe_flush_mempool",
}

# JSON-RPC params that should be ints
_INT_PARAMS = {
    "height",
    "min_height",
    "max_height",
    "page",
    "per_page",
    "limit",
    "chunk",
    "spans",
}
_BOOL_PARAMS = {"prove", "persistent", "unconditional", "private"}


def coerce_params(params: dict) -> dict:
    out = {}
    for k, v in (params or {}).items():
        key = "hash_" if k == "hash" else k
        if key in _INT_PARAMS and isinstance(v, str):
            out[key] = int(v)
        elif key in _BOOL_PARAMS and isinstance(v, str):
            out[key] = v.lower() == "true"
        else:
            out[key] = v
    return out
