"""Inspect: read-only RPC over a (possibly crashed) node's data directory.

Reference: internal/inspect/inspect.go — boots the stores and indexers
WITHOUT consensus/p2p and serves the store-backed RPC routes so operators
can examine a wedged node.

The port's copy of the JAX package's ``node/inspect.py``.  It reads the
stores and verifies nothing, so it takes no device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.config.config import Config
from cometbft_tpu_torch.indexer import KVBlockIndexer, KVTxIndexer
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.state.state import state_from_genesis
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.store.kv import UnionKV, open_kv
from cometbft_tpu_torch.types.genesis import GenesisDoc


@dataclass
class _StubSyncInfo:
    pass


class _StubConsensus:
    """Satisfies the few Environment touches that read consensus state."""

    def __init__(self, state):
        self.state = state

    def get_round_state(self):
        from cometbft_tpu_torch.consensus.types import RoundState

        rs = RoundState()
        rs.height = self.state.last_block_height
        return rs


class _StubNodeKey:
    node_id = "0" * 40


class InspectNode:
    """A store-only pseudo-node wired into the standard RPC Environment
    (reference: inspect.go uses the same rpc/core handlers)."""

    def __init__(self, config: Config, logger=None):
        self.config = config
        self.logger = logger or liblog.nop_logger()
        home = config.base.home
        data_dir = os.path.join(home, config.base.db_dir)
        self.db = open_kv(
            config.base.db_backend,
            os.path.join(data_dir, "chain.db"),
            surface="state",
        )
        self.block_store = BlockStore(self.db)
        self.state_store = StateStore(self.db)
        with open(os.path.join(home, config.base.genesis_file)) as f:
            self.genesis_doc = GenesisDoc.from_json(f.read())
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(self.genesis_doc)
        self.state = state
        self.consensus = _StubConsensus(state)
        # the live node keeps its index in a dedicated tx_index.db
        # (degradable surface); pre-split data dirs still hold it inside
        # chain.db.  Inspect never migrates: it reads through a union of
        # the two so even a partially drained legacy index serves every
        # height
        index_path = os.path.join(data_dir, "tx_index.db")
        if os.path.exists(index_path):
            self.index_db = open_kv(
                config.base.db_backend, index_path, surface="indexer"
            )
            index_view = UnionKV(
                self.index_db, self.db, fallback_surface="indexer"
            )
        else:
            self.index_db = index_view = self.db
        self.tx_indexer = KVTxIndexer(index_view)
        self.block_indexer = KVBlockIndexer(index_view)
        self.node_key = _StubNodeKey()
        self.switch = None
        self.evidence_pool = None
        self.mempool = None
        self.proxy_app = None

        class _PV:
            def pub_key(self_inner):
                from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

                return Ed25519PrivKey.from_seed(bytes(32)).pub_key()

        self.priv_validator = _PV()
        self.event_bus = None
        self.rpc_server = None

    def serve(self) -> "InspectNode":
        from cometbft_tpu_torch.rpc.core import Environment
        from cometbft_tpu_torch.rpc.server import RPCServer
        from cometbft_tpu_torch.types.events import EventBus

        self.event_bus = EventBus()
        env = Environment(self)
        self.rpc_server = RPCServer(self.config.rpc, env, self.event_bus)
        self.rpc_server.start()
        return self

    def close(self) -> None:
        if self.rpc_server is not None:
            self.rpc_server.stop()
        if self.index_db is not self.db:
            self.index_db.close()
        self.db.close()
