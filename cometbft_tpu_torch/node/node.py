"""Node assembly: wires stores → ABCI proxy → handshake → mempool →
consensus → RPC (reference: node/node.go:280-660, node/setup.go).

Startup phases mirror the reference: load genesis/state, start the app
proxy, ABCI handshake (InitChain / block replay), build mempool + block
executor + consensus, then serve RPC.  The p2p switch slots in behind
``broadcast_hook``/``add_peer_message`` once the transport layer is wired
(reference ordering: node/node.go:584 OnStart).

The port's copy of the JAX package's ``node/node.py``.  ``Node(device=None)``
runs on the card: the evidence pool, the handshake, the executor, the
transport (so every peer link and the remote signer's), the blocksync
reactor, the ingest coalescer and the statesync light client all get the
node's device, and on the card the batch backend resolves when the node is
built (``types/validation.entry_device``), before any reactor starts.  With
no card the build raises unless the caller names the CPU (``device="cpu"``
or ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``).

The gRPC options (``grpc.laddr``, ``grpc.privileged_laddr``, ``abci =
"grpc"``) need the ``grpc`` and ``google.protobuf`` packages, imported only
for them; where one does not import, the build raises
``NotImplementedError`` naming it (``_require_grpc``).  The psql sink
(``tx_index.indexer = "psql"``) and the p2p latency zones (``p2p.zone``)
are built as the JAX node builds them.  The node keeps
``libs/metrics.NodeMetrics`` with a 2 s sampler, serves ``/metrics``
behind ``instrumentation.prometheus`` and ``/debug/pprof/`` behind
``rpc.pprof_laddr``, journals to the black box (``libs/blackbox``: a
"boot" record, the previous run's postmortem in the boot log, the
clean-close sentinel at stop), and names the flight recorder's state in its
boot line, as the JAX node does.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
from typing import Optional

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config.config import Config
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.libs import log as liblog
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.mempool.clist_mempool import CListMempool, NopMempool
from cometbft_tpu_torch.node.nodekey import NodeKey
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.proxy.multi_app_conn import (
    AppConns,
    local_client_creator,
    remote_client_creator,
)
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import State, state_from_genesis
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.store.kv import open_kv
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.validation import entry_device


def _builtin_app(name: str):
    """Registry of in-process apps (reference: abci/example + proxy
    DefaultClientCreator's builtin path)."""
    if name in ("kvstore", "persistent_kvstore"):
        return KVStoreApplication()
    if name == "noop":
        from cometbft_tpu_torch.abci.application import BaseApplication

        return BaseApplication()
    raise ValueError(f"unknown builtin app {name!r}")


def _require_grpc(config: Config) -> None:
    """Raise ``NotImplementedError`` naming the package when a gRPC option
    is set and ``grpc`` or ``google.protobuf`` does not import, so that a
    node never runs on quietly without the option.  Nothing else needs
    either package, and the defaults set no gRPC option."""
    options = [
        name
        for name, on in (
            ("grpc.laddr", config.grpc.laddr),
            ("grpc.privileged_laddr", config.grpc.privileged_laddr),
            ('abci = "grpc"', config.base.abci == "grpc"),
        )
        if on
    ]
    if not options:
        return
    for package in ("grpc", "google.protobuf"):
        try:
            importlib.import_module(package)
        except ImportError as e:
            raise NotImplementedError(
                f"{', '.join(options)} needs the {package!r} package, "
                f"which does not import: {e}"
            ) from e


class Node(BaseService):
    """Reference: node/node.go Node."""

    def __init__(
        self,
        config: Config,
        logger: Optional[liblog.Logger] = None,
        app=None,
        device=None,
    ):
        """``app``: optional in-process ABCI application overriding
        ``config.base.proxy_app`` (the reference's custom-client-creator
        injection, node/setup.go DefaultNewNode vs NewNodeWithCliParams).
        ``device``: None is the card (see the module's docstring)."""
        super().__init__("Node")
        _require_grpc(config)
        device = entry_device(device)
        self.device = device
        self._app_override = app
        self.config = config
        self.logger = logger or liblog.Logger(
            level=liblog.parse_level(config.base.log_level)
        )
        home = config.base.home

        # -- stores (reference: node/setup.go:161 initDBs) ------------------
        data_dir = os.path.join(home, config.base.db_dir)
        os.makedirs(data_dir, exist_ok=True)
        self.db = open_kv(
            config.base.db_backend,
            os.path.join(data_dir, "chain.db"),
            surface="state",
        )
        self.block_store = BlockStore(self.db)
        self.state_store = StateStore(self.db)

        # -- genesis + state ------------------------------------------------
        genesis_path = os.path.join(home, config.base.genesis_file)
        with open(genesis_path) as f:
            self.genesis_doc = GenesisDoc.from_json(f.read())
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(self.genesis_doc)

        # -- node key + privval --------------------------------------------
        self.node_key = NodeKey.load_or_generate(
            os.path.join(home, config.base.node_key_file)
        )
        self._signer_endpoint = None
        if config.base.priv_validator_laddr:
            # remote signer (reference: node/node.go:383
            # createAndStartPrivValidatorSocketClient)
            from cometbft_tpu_torch.privval.signer import (
                RetrySignerClient,
                SignerClient,
                SignerListenerEndpoint,
            )

            self._signer_endpoint = SignerListenerEndpoint(
                config.base.priv_validator_laddr,
                logger=self.logger.with_(module="privval"),
                device=device,
            )
            self._signer_endpoint.start()
            self._signer_endpoint.wait_for_connection()
            self.priv_validator = RetrySignerClient(
                SignerClient(self._signer_endpoint)
            )
        else:
            self.priv_validator = FilePV.load_or_generate(
                os.path.join(home, config.base.priv_validator_key_file),
                os.path.join(home, config.base.priv_validator_state_file),
            )

        # -- ABCI proxy (reference: node/node.go:359) -----------------------
        if self._app_override is not None:
            self.app = self._app_override
            creator = local_client_creator(self.app)
        elif config.base.abci == "grpc":
            self.app = None
            creator = remote_client_creator(
                config.base.proxy_app, transport="grpc"
            )
        elif config.base.abci == "builtin":
            self.app = _builtin_app(config.base.proxy_app)
            creator = local_client_creator(self.app)
        else:
            self.app = None
            creator = remote_client_creator(config.base.proxy_app)
        self.proxy_app = AppConns(creator)
        self.proxy_app.start()

        # -- event bus ------------------------------------------------------
        self.event_bus = EventBus()

        # -- indexers (reference: node/node.go:373 createAndStartIndexerService)
        self.tx_indexer = None
        self.block_indexer = None
        self.indexer_service = None
        self.index_db = None
        if config.tx_index.indexer == "kv":
            from cometbft_tpu_torch.indexer import KVBlockIndexer, KVTxIndexer

            # own DB under the DEGRADABLE ``indexer`` surface (reference
            # keeps a separate tx_index db too, node.go DBContext): an
            # index write failure is a counted drop + anomaly, never a
            # halted node — unlike chain.db's fail-stop ``state`` surface
            self.index_db = open_kv(
                config.base.db_backend,
                os.path.join(data_dir, "tx_index.db"),
                surface="indexer",
            )
            # pre-split data dirs hold their index inside chain.db —
            # drain it across so tx_search keeps seeing old heights.
            # The indexer surface is DEGRADABLE: a failed drain must not
            # halt boot (it resumes next boot; queries are merely stale)
            from cometbft_tpu_torch.indexer.kv import migrate_legacy_index

            drained = False
            try:
                moved = migrate_legacy_index(self.db, self.index_db)
                drained = True  # the drain loops ran to empty ranges
            except Exception as e:  # noqa: BLE001 — degrade, never halt
                moved = 0
                self.logger.error(
                    "legacy tx index migration failed; "
                    "will resume next boot", err=repr(e)
                )
            if moved:
                self.logger.info(
                    "migrated legacy tx index out of chain.db", rows=moved
                )
            if drained:
                # chain.db provably holds zero legacy index rows — bind
                # the indexers straight to tx_index.db; a permanent
                # union view would charge every query a chain.db lookup
                # for rows that can never exist there
                index_view = self.index_db
            else:
                # interrupted drain: read through the union of the two
                # dbs (writes go to tx_index.db) so pre-split heights
                # don't vanish from tx_search until a later boot drains
                from cometbft_tpu_torch.store.kv import UnionKV

                index_view = UnionKV(
                    self.index_db, self.db, fallback_surface="indexer"
                )
            self.tx_indexer = KVTxIndexer(index_view)
            self.block_indexer = KVBlockIndexer(index_view)
        elif config.tx_index.indexer == "psql":
            from cometbft_tpu_torch.indexer.psql import (
                PsqlBlockIndexerAdapter,
                PsqlEventSink,
                PsqlTxIndexerAdapter,
            )

            self.event_sink = PsqlEventSink(
                config.tx_index.psql_conn, self.genesis_doc.chain_id
            )
            self.tx_indexer = PsqlTxIndexerAdapter(self.event_sink)
            self.block_indexer = PsqlBlockIndexerAdapter(self.event_sink)
        if self.tx_indexer is not None:
            from cometbft_tpu_torch.indexer import IndexerService

            self.indexer_service = IndexerService(
                self.tx_indexer,
                self.block_indexer,
                self.event_bus,
                logger=self.logger.with_(module="txindex"),
            )

        # -- evidence pool (reference: node/node.go:431 createEvidenceReactor)
        from cometbft_tpu_torch.evidence.pool import EvidencePool

        self.evidence_pool = EvidencePool(
            self.db,
            self.state_store,
            self.block_store,
            logger=self.logger.with_(module="evidence"),
            device=device,
        )

        # -- handshake (reference: node/node.go:411 doHandshake) ------------
        handshaker = Handshaker(
            self.state_store,
            self.block_store,
            self.genesis_doc,
            event_bus=self.event_bus,
            evidence_pool=self.evidence_pool,
            logger=self.logger.with_(module="handshaker"),
            device=device,
        )
        state = handshaker.handshake(state, self.proxy_app)
        self.state = state
        self.evidence_pool.state = state

        # -- mempool --------------------------------------------------------
        info = self.proxy_app.query.info()
        self.tx_ingest = None
        if config.mempool.type_ == "nop":
            self.mempool = NopMempool()
        else:
            self.mempool = CListMempool(
                config.mempool,
                self.proxy_app.mempool,
                height=state.last_block_height,
                lane_priorities=dict(info.lane_priorities),
                default_lane=info.default_lane,
                envelope_aware=getattr(info, "envelope_sig_verified", False),
            )
            if not config.consensus.create_empty_blocks:
                self.mempool.enable_txs_available()
            # batched gossip admission (docs/tx-ingest.md); inert until
            # COMETBFT_TPU_TXINGEST + the trusted-backend gate activate it
            from cometbft_tpu_torch.txingest import IngestCoalescer

            self.tx_ingest = IngestCoalescer(self.mempool, device=device)

        # -- block executor -------------------------------------------------
        self.block_exec = BlockExecutor(
            self.state_store,
            self.block_store,
            self.proxy_app.consensus,
            self.mempool,
            evidence_pool=self.evidence_pool,
            event_bus=self.event_bus,
            logger=self.logger.with_(module="state"),
            device=device,
        )
        # restore data-companion retain heights (survive restarts)
        self.state_store.load_retain_heights(self.block_exec._retain)

        # -- consensus ------------------------------------------------------
        wal_path = os.path.join(home, config.consensus.wal_file)
        self.consensus = ConsensusState(
            config.consensus,
            state,
            self.block_exec,
            self.block_store,
            self.mempool,
            priv_validator=self.priv_validator,
            wal=WAL(wal_path),
            event_bus=self.event_bus,
            evidence_pool=self.evidence_pool,
            logger=self.logger.with_(module="consensus"),
        )

        # -- p2p switch + reactors (reference: node/node.go:501-538) --------
        self.switch = None
        self.addr_book = None
        if config.p2p.laddr:
            self._setup_p2p()

        # -- metrics (reference: node/setup.go:139 DefaultMetricsProvider) --
        from cometbft_tpu_torch.libs.metrics import NodeMetrics

        self.metrics = NodeMetrics(config.instrumentation.namespace)
        self.metrics_server = None

        # -- RPC ------------------------------------------------------------
        self.rpc_server = None
        self._tx_waiter_thread: Optional[threading.Thread] = None

    def _metrics_sampler(self) -> None:
        """Periodic gauge refresh (reference wires metrics through every
        constructor; sampling the same state keeps the surface identical
        without threading a handle into each subsystem)."""
        m = self.metrics
        last_height = 0
        last_time = None
        while self.is_running:
            try:
                rs = self.consensus.rs
                height = self.block_store.height()
                m.height.set(height)
                m.rounds.set(rs.round_)
                if rs.validators is not None:
                    m.validators.set(len(rs.validators))
                    m.validators_power.set(rs.validators.total_voting_power())
                if height > last_height:
                    meta = self.block_store.load_block_meta(height)
                    if meta is not None:
                        m.num_txs.set(meta.num_txs)
                        m.block_size.set(meta.block_size)
                        t = meta.header.time.to_ns() / 1e9
                        if last_time is not None and height == last_height + 1:
                            m.block_interval.observe(max(t - last_time, 0.0))
                        last_time = t
                    last_height = height
                if hasattr(self.mempool, "size"):
                    m.mempool_size.set(self.mempool.size())
                if hasattr(self.mempool, "size_bytes"):
                    m.mempool_size_bytes.set(self.mempool.size_bytes())
                if self.switch is not None:
                    m.peers.set(len(self.switch.peers_list()))
                # the card's availability: fold the out-of-process
                # watcher's status file into the gauge + journal (no-op
                # unless COMETBFT_TPU_CHIP_STATUS points at one)
                from cometbft_tpu_torch.ops import device_health

                device_health.poll_status_file()
            except Exception:  # noqa: BLE001 — metrics must never kill the node
                pass
            time.sleep(2.0)

    def _setup_p2p(self) -> None:
        """Create transport, switch, and the protocol reactors
        (reference: node/node.go:501 createTransport → :538 pex)."""
        from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
        from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
        from cometbft_tpu_torch.mempool.clist_mempool import CListMempool
        from cometbft_tpu_torch.mempool.reactor import MempoolReactor
        from cometbft_tpu_torch.p2p.node_info import NodeInfo
        from cometbft_tpu_torch.p2p.pex import AddrBook, PEXReactor
        from cometbft_tpu_torch.p2p.switch import Switch
        from cometbft_tpu_torch.p2p.transport import Transport

        config = self.config
        # channels advertised in the node info (filled below by reactors)
        from cometbft_tpu_torch.version import CMT_SEMVER

        self._node_info = NodeInfo(
            node_id=self.node_key.node_id,
            network=self.genesis_doc.chain_id,
            listen_addr=config.p2p.external_address or config.p2p.laddr,
            moniker=config.base.moniker,
            rpc_address=config.rpc.laddr,
            # the wire-advertised version must track the running build —
            # the e2e upgrade perturbation restarts nodes under a new
            # COMETBFT_TPU_SEMVER and peers must see it in the handshake
            version=CMT_SEMVER,
        )
        latency = None
        if config.p2p.zone:
            from cometbft_tpu_torch.p2p.latency import ZoneMatrix

            latency = (
                config.p2p.zone,
                ZoneMatrix.from_config(config.p2p.zone_rtt_ms),
                dict(config.p2p.peer_zones or {}),
            )
        transport = Transport(
            self.node_key,
            lambda: self._node_info,
            handshake_timeout=config.p2p.handshake_timeout_s,
            dial_timeout=config.p2p.dial_timeout_s,
            latency=latency,
            device=self.device,
        )
        self.switch = Switch(
            config.p2p,
            transport,
            lambda: self._node_info,
            logger=self.logger.with_(module="p2p"),
        )

        # phased startup (reference: node OnStart — statesync → blocksync →
        # consensus): statesync only for a fresh node with it enabled;
        # blocksync unless we are the only validator (reference:
        # node/node.go onlyValidatorIsUs — a solo validator can't sync
        # from anyone and must propose immediately)
        self.statesync_active = (
            config.statesync.enable and self.state.last_block_height == 0
        )
        block_sync = not self._only_validator_is_us()
        self.consensus_reactor = ConsensusReactor(
            self.consensus,
            self.block_store,
            wait_sync=block_sync or self.statesync_active,
            logger=self.logger.with_(module="consensus-reactor"),
        )
        self.switch.add_reactor("CONSENSUS", self.consensus_reactor)

        from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor

        self.blocksync_reactor = BlocksyncReactor(
            self.state,
            self.block_exec,
            self.block_store,
            consensus_reactor=self.consensus_reactor,
            enabled=block_sync and not self.statesync_active,
            logger=self.logger.with_(module="blocksync"),
            device=self.device,
        )
        self.switch.add_reactor("BLOCKSYNC", self.blocksync_reactor)

        from cometbft_tpu_torch.statesync.reactor import StatesyncReactor

        self.statesync_reactor = StatesyncReactor(
            self.proxy_app, logger=self.logger.with_(module="statesync")
        )
        self.switch.add_reactor("STATESYNC", self.statesync_reactor)
        if isinstance(self.mempool, CListMempool):
            self.mempool_reactor = MempoolReactor(
                config.mempool,
                self.mempool,
                logger=self.logger.with_(module="mempool-reactor"),
                ingest=self.tx_ingest,
            )
            self.switch.add_reactor("MEMPOOL", self.mempool_reactor)
        self.evidence_reactor = EvidenceReactor(
            self.evidence_pool, logger=self.logger.with_(module="evidence-reactor")
        )
        self.switch.add_reactor("EVIDENCE", self.evidence_reactor)

        if config.p2p.pex:
            book_path = os.path.join(
                config.base.home, config.p2p.addr_book_file
            )
            self.addr_book = AddrBook(book_path, strict=config.p2p.addr_book_strict)
            self.addr_book.add_our_id(self.node_key.node_id)
            self.pex_reactor = PEXReactor(
                self.addr_book,
                seeds=config.p2p.seeds,
                seed_mode=config.p2p.seed_mode,
                logger=self.logger.with_(module="pex"),
            )
            self.switch.add_reactor("PEX", self.pex_reactor)
            self.switch.addr_book = self.addr_book

        # advertise the union of reactor channels
        self._node_info.channels = bytes(
            sorted(self.switch._chan_to_reactor.keys())
        )

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        # black-box journal (docs/observability.md "Black box"): decode
        # the PREVIOUS run's journal first — a missing clean-close
        # sentinel means the process died uncleanly, and the postmortem
        # digest belongs in the boot log (and at /debug/postmortem)
        # before anything overwrites the evidence.  COMETBFT_TPU_BLACKBOX=0
        # restores the RAM-only recorder bit-for-bit.
        from cometbft_tpu_torch.libs import blackbox

        self.boot_postmortem = None
        self._blackbox = None
        if blackbox.enabled():
            bb_dir = os.path.join(
                self.config.base.home, self.config.base.db_dir, "blackbox"
            )
            try:
                self.boot_postmortem = blackbox.boot_report(bb_dir)
            except Exception as e:  # noqa: BLE001 — forensics must never
                # keep a node from booting
                self.logger.error("black-box boot decode failed", err=repr(e))
            if self.boot_postmortem and self.boot_postmortem.get(
                "unclean_shutdown"
            ):
                bp = self.boot_postmortem
                self.logger.warn(
                    "unclean shutdown detected: previous run left no "
                    "clean-close sentinel",
                    last_committed=bp.get("last_committed_height"),
                    in_flight=bp.get("in_flight"),
                    last_dispatch=bp.get("last_dispatch"),
                    open_spans=len(bp.get("open_spans") or ()),
                    anomalies=bp.get("anomaly_counts"),
                    torn_tail=bp.get("journal", {}).get("torn_tail"),
                )
            self._blackbox = blackbox.open_journal(bb_dir)
            if self._blackbox is not None:
                self._blackbox.on_event(
                    "boot",
                    {
                        "height": self.state.last_block_height,
                        "unclean_prev": bool(
                            self.boot_postmortem
                            and self.boot_postmortem.get("unclean_shutdown")
                        ),
                    },
                )
        # warm-boot the verify compile matrix in the background (docs/
        # warm-boot.md): on the trusted tpu backend the node reaches full
        # verify throughput without its first commits paying a compile.
        # jax-free when disabled; failures demote tiers via the breaker.
        from cometbft_tpu_torch.ops import warmboot

        self._warmboot_thread = warmboot.start()
        if self.indexer_service is not None:
            self.indexer_service.start()
        # background pruner (reference: node/node.go createPruner; the
        # executor records retain heights, this service acts on them)
        from cometbft_tpu_torch.state.pruner import Pruner

        self.pruner = Pruner(
            self.block_exec._retain,
            self.block_store,
            self.state_store,
            tx_indexer=self.tx_indexer,
            block_indexer=self.block_indexer,
            interval_s=2.0,
            logger=self.logger.with_(module="pruner"),
        )
        self.pruner.start()
        threading.Thread(
            target=self._metrics_sampler, name="metrics-sampler", daemon=True
        ).start()
        if self.config.instrumentation.prometheus:
            from cometbft_tpu_torch.libs.metrics import MetricsServer

            self.metrics_server = MetricsServer(
                self.metrics.registry,
                self.config.instrumentation.prometheus_listen_addr,
            )
            self.metrics_server.start()
        self.pprof_server = None
        if self.config.rpc.pprof_laddr:
            # profiling endpoints (reference: node/node.go:592-595)
            from cometbft_tpu_torch.node.pprof import PprofServer

            self.pprof_server = PprofServer(
                self.config.rpc.pprof_laddr,
                logger=self.logger.with_(module="pprof"),
            )
            self.pprof_server.start()
        if self.config.rpc.laddr:
            from cometbft_tpu_torch.rpc.core import Environment
            from cometbft_tpu_torch.rpc.server import RPCServer

            # proof-serving coalescer for light-client read traffic
            # (docs/proof-serving.md): store-backed loaders, decoupled
            # from the RPC handlers that ride it
            from cometbft_tpu_torch import proofserve

            if proofserve.enabled():
                proofserve.configure(
                    self._proof_tx_loader,
                    self._proof_header_hasher,
                    self._proof_valset_hasher,
                )
            env = Environment(self)
            self.rpc_server = RPCServer(self.config.rpc, env, self.event_bus)
            self.rpc_server.start()
        self.grpc_server = None
        self.grpc_privileged_server = None
        if self.config.grpc.laddr:
            from cometbft_tpu_torch.rpc.grpc_server import GRPCServer

            self.grpc_server = GRPCServer(
                self, self.config.grpc.laddr,
                logger=self.logger.with_(module="grpc"),
            )
            self.grpc_server.start()
        if self.config.grpc.privileged_laddr:
            from cometbft_tpu_torch.rpc.grpc_server import GRPCServer

            self.grpc_privileged_server = GRPCServer(
                self, self.config.grpc.privileged_laddr, privileged=True,
                logger=self.logger.with_(module="grpc-priv"),
            )
            self.grpc_privileged_server.start()
        if self.switch is not None:
            # listen, then fix up the advertised address with the bound port
            host, port = self.switch.transport.listen(self.config.p2p.laddr)
            if not self.config.p2p.external_address:
                adv_host = "127.0.0.1" if host in ("0.0.0.0", "::") else host
                self._node_info.listen_addr = f"{adv_host}:{port}"
            self.switch.start()  # starts reactors; consensus reactor starts cs
            if self.config.p2p.persistent_peers:
                self.switch.dial_peers_async(
                    self.config.p2p.persistent_peers, persistent=True
                )
            if self.statesync_active:
                threading.Thread(
                    target=self._run_statesync,
                    name="statesync",
                    daemon=True,
                ).start()
        else:
            self.consensus.start()
        if self.mempool.txs_available() is not None:
            self._tx_waiter_thread = threading.Thread(
                target=self._tx_waiter, daemon=True
            )
            self._tx_waiter_thread.start()
        # flight-recorder state belongs in the boot log: when a postmortem
        # needs a dump, the first question is whether tracing was on and
        # where dumps land (docs/observability.md)
        from cometbft_tpu_torch.libs import tracing

        self.logger.info(
            "node started",
            node_id=self.node_key.node_id,
            chain_id=self.genesis_doc.chain_id,
            height=self.state.last_block_height,
            flight_recorder="on" if tracing.enabled() else "off",
            trace_dir=tracing.trace_dir() or "",
            blackbox=(
                self._blackbox.dir if self._blackbox is not None else "off"
            ),
        )

    def _run_statesync(self) -> None:
        """Reference: node/setup.go:560 startStateSync — restore a snapshot,
        bootstrap the stores, then hand off to blocksync."""
        from cometbft_tpu_torch.light.provider import HTTPProvider
        from cometbft_tpu_torch.light.verifier import TrustOptions
        from cometbft_tpu_torch.statesync.stateprovider import (
            LightClientStateProvider,
        )
        from cometbft_tpu_torch.statesync.syncer import Syncer

        cfg = self.config.statesync
        try:
            providers = [
                HTTPProvider(self.genesis_doc.chain_id, url)
                for url in cfg.rpc_servers
            ]
            state_provider = LightClientStateProvider(
                self.genesis_doc.chain_id,
                providers,
                TrustOptions(
                    period_s=cfg.trust_period_s,
                    height=cfg.trust_height,
                    hash=bytes.fromhex(cfg.trust_hash),
                ),
                genesis_doc=self.genesis_doc,
                logger=self.logger.with_(module="statesync-provider"),
                device=self.device,
            )
            syncer = Syncer(
                state_provider,
                self.proxy_app,
                self.statesync_reactor.request_chunk,
                chunk_timeout=cfg.chunk_request_timeout_s,
                logger=self.logger.with_(module="statesync"),
            )
            self.statesync_reactor.syncer = syncer
            self.statesync_reactor.request_snapshots()
            state, commit = syncer.sync_any(
                cfg.discovery_time_s,
                lambda: self.is_running,
                rediscover=self.statesync_reactor.request_snapshots,
            )
        except Exception as e:  # noqa: BLE001
            self.logger.error(
                "statesync failed, falling back to blocksync", err=repr(e)
            )
            self.statesync_reactor.syncer = None
            self.blocksync_reactor.start_sync(self.state)
            return
        self.statesync_reactor.syncer = None
        # bootstrap stores (reference: node/setup.go:587-601)
        self.state_store.bootstrap(state)
        self.block_store.save_seen_commit(state.last_block_height, commit)
        self.state = state
        self.evidence_pool.state = state
        self.logger.info(
            "statesync complete", height=state.last_block_height
        )
        self.blocksync_reactor.start_sync(state)

    def _tx_waiter(self) -> None:
        """Forward mempool txs-available pulses into consensus (reference:
        txNotifier channel, state.go:1026 handleTxsAvailable)."""
        ev = self.mempool.txs_available()
        while self.is_running:
            if ev.wait(timeout=0.2):
                ev.clear()
                self.consensus.notify_txs_available()

    # -- proof-server loaders (proofserve.configure at start) --------------

    def _proof_tx_loader(self, height: int):
        blk = self.block_store.load_block(int(height))
        return None if blk is None else list(blk.data.txs)

    def _proof_header_hasher(self, height: int):
        meta = self.block_store.load_block_meta(int(height))
        return None if meta is None else meta.header.hash()

    def _proof_valset_hasher(self, height: int):
        try:
            vals = self.state_store.load_validators(int(height))
        except Exception:  # noqa: BLE001 — pruned/unknown height
            return None
        return None if vals is None else vals.hash()

    def on_stop(self) -> None:
        if self.switch is not None:
            self.switch.stop()
        from cometbft_tpu_torch import proofserve
        from cometbft_tpu_torch.p2p import handshake_pool

        # drain the proof coalescer before servers close: a future handed
        # to an RPC thread must resolve even across shutdown; same for
        # the handshake pool — a dial mid-flush must get its secret (or
        # shed to sync) before the process tears down transport state
        proofserve.reset_server()
        handshake_pool.reset_pool()
        if self.tx_ingest is not None:
            # drain queued gossip into the mempool before the proxy closes
            self.tx_ingest.close()
        self.consensus.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        if self.addr_book is not None:
            self.addr_book.save()
        if self.indexer_service is not None:
            self.indexer_service.stop()
        if getattr(self, "pruner", None) is not None:
            self.pruner.stop()
        if getattr(self, "event_sink", None) is not None:
            self.event_sink.stop()
        if self._signer_endpoint is not None:
            self._signer_endpoint.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if getattr(self, "pprof_server", None) is not None:
            self.pprof_server.stop()
        for srv in (getattr(self, "grpc_server", None),
                    getattr(self, "grpc_privileged_server", None)):
            if srv is not None:
                srv.stop()
        self.proxy_app.stop()
        if getattr(self, "_blackbox", None) is not None:
            # the clean-close sentinel: the one record whose absence at
            # the next boot means this stop never ran
            from cometbft_tpu_torch.libs import blackbox

            if blackbox.get_journal() is self._blackbox:
                blackbox.close_journal(clean=True)
            else:
                self._blackbox.close(clean=True)
            self._blackbox = None
        if self.index_db is not None:
            self.index_db.close()
        self.db.close()
        self.logger.info("node stopped")

    def _only_validator_is_us(self) -> bool:
        """Reference: node/node.go onlyValidatorIsUs."""
        vals = self.state.validators
        if len(vals) != 1:
            return False
        return vals.validators[0].address == self.priv_validator.pub_key().address()

    # -- introspection -----------------------------------------------------

    @property
    def current_height(self) -> int:
        return self.block_store.height()
