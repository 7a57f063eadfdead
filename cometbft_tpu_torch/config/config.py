"""Node configuration: one TOML file, sectioned structs.

Mirrors the reference's mega-Config (config/config.go:93-1567) — Base/RPC/
GRPC/P2P/Mempool/StateSync/BlockSync/Consensus/Storage/TxIndex/
Instrumentation — plus a `crypto` section that is new here: it selects the
batch-verification backend (cpu | gpu | tpu | auto; tpu reads as the
card), the pluggable seam the accelerator build hangs off (SURVEY.md §7
step 2).

TOML is read with stdlib tomllib; writing uses a small emitter (the config
surface is flat sections of scalars/lists, which TOML expresses exactly).
"""

from __future__ import annotations

import os
try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib
from dataclasses import dataclass, field, fields as dc_fields, is_dataclass, asdict
from typing import Optional


def _home(*parts: str) -> str:
    return os.path.join(*parts)


@dataclass
class BaseConfig:
    """Reference: config/config.go BaseConfig."""

    chain_id: str = ""
    home: str = ""
    moniker: str = "anonymous"
    db_backend: str = "sqlite"  # sqlite (embedded default) | memdb
    db_dir: str = "data"
    log_level: str = "info"
    log_format: str = "plain"  # plain | json
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    priv_validator_laddr: str = ""  # remote signer listen address
    node_key_file: str = "config/node_key.json"
    abci: str = "builtin"  # builtin | socket | grpc
    proxy_app: str = "kvstore"  # app name (builtin) or address (socket/grpc)
    filter_peers: bool = False

    def genesis_path(self) -> str:
        return _home(self.home, self.genesis_file)

    def priv_validator_key_path(self) -> str:
        return _home(self.home, self.priv_validator_key_file)

    def priv_validator_state_path(self) -> str:
        return _home(self.home, self.priv_validator_state_file)

    def node_key_path(self) -> str:
        return _home(self.home, self.node_key_file)

    def db_path(self) -> str:
        return _home(self.home, self.db_dir)

    def validate_basic(self) -> Optional[str]:
        if self.log_format not in ("plain", "json"):
            return "unknown log_format (must be 'plain' or 'json')"
        if self.abci not in ("builtin", "socket", "grpc"):
            return "unknown abci mode"
        return None


@dataclass
class RPCConfig:
    """Reference: config/config.go RPCConfig."""

    laddr: str = "tcp://127.0.0.1:26657"
    cors_allowed_origins: list[str] = field(default_factory=list)
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit_ms: int = 10_000
    max_request_batch_size: int = 10
    max_body_bytes: int = 1_000_000
    pprof_laddr: str = ""
    # serve the dial_seeds/dial_peers/unsafe_flush_mempool routes
    # (reference config.go RPCConfig.Unsafe + routes.go AddUnsafeRoutes)
    unsafe: bool = False

    def validate_basic(self) -> Optional[str]:
        if self.max_open_connections < 0:
            return "max_open_connections cannot be negative"
        if self.timeout_broadcast_tx_commit_ms < 0:
            return "timeout_broadcast_tx_commit_ms cannot be negative"
        return None


@dataclass
class GRPCConfig:
    """Reference: config/config.go GRPCConfig (versioned services)."""

    laddr: str = ""  # empty = disabled
    block_service_enabled: bool = True
    block_results_service_enabled: bool = True
    version_service_enabled: bool = True
    privileged_laddr: str = ""
    pruning_service_enabled: bool = False

    def validate_basic(self) -> Optional[str]:
        return None


@dataclass
class P2PConfig:
    """Reference: config/config.go P2PConfig."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: list[str] = field(default_factory=list)
    persistent_peers: list[str] = field(default_factory=list)
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    unconditional_peer_ids: list[str] = field(default_factory=list)
    persistent_peers_max_dial_period_s: int = 0
    flush_throttle_timeout_ms: int = 10
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
    seed_mode: bool = False
    private_peer_ids: list[str] = field(default_factory=list)
    allow_duplicate_ip: bool = False
    handshake_timeout_s: int = 20
    dial_timeout_s: int = 3
    # WAN latency emulation (testnets): this node's zone, the zone-pair RTT
    # matrix (ms), and each peer id's zone.  Empty zone = no emulation.
    # Reference analog: test/e2e/pkg/latency/ zone tables applied via tc.
    zone: str = ""
    zone_rtt_ms: dict = field(default_factory=dict)
    peer_zones: dict = field(default_factory=dict)

    def validate_basic(self) -> Optional[str]:
        if self.max_packet_msg_payload_size <= 0:
            return "max_packet_msg_payload_size must be positive"
        if self.send_rate < 0 or self.recv_rate < 0:
            return "send_rate/recv_rate cannot be negative"
        for a, row in (self.zone_rtt_ms or {}).items():
            if not isinstance(row, dict):
                return f"zone_rtt_ms[{a!r}] must be a table of rtt values"
            for b, v in row.items():
                if not isinstance(v, (int, float)) or v < 0:
                    return f"zone_rtt_ms[{a!r}][{b!r}] must be a nonneg number"
        return None


@dataclass
class MempoolConfig:
    """Reference: config/config.go MempoolConfig."""

    type_: str = "flood"  # flood | nop
    recheck: bool = True
    recheck_timeout_ms: int = 1000
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1_073_741_824
    cache_size: int = 10_000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1_048_576

    def validate_basic(self) -> Optional[str]:
        if self.type_ not in ("flood", "nop"):
            return "unknown mempool type"
        if self.size < 0 or self.cache_size < 0:
            return "mempool size/cache_size cannot be negative"
        return None


@dataclass
class StateSyncConfig:
    """Reference: config/config.go StateSyncConfig."""

    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_s: int = 168 * 3600
    discovery_time_s: int = 15
    temp_dir: str = ""
    chunk_request_timeout_s: int = 10
    chunk_fetchers: int = 4

    def validate_basic(self) -> Optional[str]:
        if self.enable:
            if len(self.rpc_servers) < 2:
                return "state sync requires >=2 rpc_servers"
            if self.trust_height <= 0:
                return "state sync requires trust_height > 0"
            if not self.trust_hash:
                return "state sync requires trust_hash"
        return None


@dataclass
class BlockSyncConfig:
    """Reference: config/config.go BlockSyncConfig."""

    version: str = "v0"

    def validate_basic(self) -> Optional[str]:
        if self.version != "v0":
            return "unknown blocksync version"
        return None


@dataclass
class ConsensusConfig:
    """Reference: config/config.go ConsensusConfig (timeouts in ms)."""

    wal_file: str = "data/cs.wal/wal"
    timeout_propose_ms: int = 3000
    timeout_propose_delta_ms: int = 500
    timeout_vote_ms: int = 1000
    timeout_vote_delta_ms: int = 500
    timeout_commit_ms: int = 1000
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ms: int = 0
    peer_gossip_sleep_duration_ms: int = 100
    peer_query_maj23_sleep_duration_ms: int = 2000
    double_sign_check_height: int = 0

    def propose_timeout(self, round_: int) -> float:
        return (
            self.timeout_propose_ms + self.timeout_propose_delta_ms * round_
        ) / 1000.0

    def vote_timeout(self, round_: int) -> float:
        return (self.timeout_vote_ms + self.timeout_vote_delta_ms * round_) / 1000.0

    def commit_timeout(self) -> float:
        return self.timeout_commit_ms / 1000.0

    def validate_basic(self) -> Optional[str]:
        for name in (
            "timeout_propose_ms",
            "timeout_propose_delta_ms",
            "timeout_vote_ms",
            "timeout_vote_delta_ms",
            "timeout_commit_ms",
        ):
            if getattr(self, name) < 0:
                return f"{name} cannot be negative"
        return None


@dataclass
class StorageConfig:
    """Reference: config/config.go StorageConfig."""

    discard_abci_responses: bool = False
    pruning_interval_s: int = 10
    compact: bool = False
    compaction_interval: int = 1000

    def validate_basic(self) -> Optional[str]:
        return None


@dataclass
class TxIndexConfig:
    """Reference: config/config.go TxIndexConfig."""

    indexer: str = "kv"  # kv | null | psql
    psql_conn: str = ""

    def validate_basic(self) -> Optional[str]:
        if self.indexer not in ("kv", "null", "psql"):
            return "unknown indexer"
        if self.indexer == "psql" and not self.psql_conn:
            return "the psql connection settings cannot be empty"
        return None


@dataclass
class InstrumentationConfig:
    """Reference: config/config.go InstrumentationConfig."""

    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    max_open_connections: int = 3
    namespace: str = "cometbft"

    def validate_basic(self) -> Optional[str]:
        return None


@dataclass
class CryptoConfig:
    """Accelerator-build specific: selects the batch-verification backend
    behind the crypto/batch seam (SURVEY.md §7 design stance).  ``backend``
    takes what ``crypto/batch.env_backend`` takes: ``auto``, ``cpu``,
    ``gpu``, and ``tpu`` (the JAX package's name for its accelerator), read
    as the card, so a file written for the JAX package loads unchanged."""

    backend: str = "auto"  # auto | cpu | gpu | tpu (= gpu)
    min_batch_size: int = 2
    mesh_shard_threshold: int = 4096  # shard batches larger than this over the mesh

    def validate_basic(self) -> Optional[str]:
        if self.backend not in ("auto", "cpu", "gpu", "tpu"):
            return "crypto backend must be auto|cpu|gpu|tpu"
        return None


_SECTIONS = {
    "rpc": RPCConfig,
    "grpc": GRPCConfig,
    "p2p": P2PConfig,
    "mempool": MempoolConfig,
    "statesync": StateSyncConfig,
    "blocksync": BlockSyncConfig,
    "consensus": ConsensusConfig,
    "storage": StorageConfig,
    "tx_index": TxIndexConfig,
    "instrumentation": InstrumentationConfig,
    "crypto": CryptoConfig,
}


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    grpc: GRPCConfig = field(default_factory=GRPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)

    def set_home(self, home: str) -> "Config":
        self.base.home = home
        return self

    def wal_path(self) -> str:
        return _home(self.base.home, self.consensus.wal_file)

    def addr_book_path(self) -> str:
        return _home(self.base.home, self.p2p.addr_book_file)

    def validate_basic(self) -> Optional[str]:
        err = self.base.validate_basic()
        if err:
            return f"base: {err}"
        for name, _ in _SECTIONS.items():
            err = getattr(self, name).validate_basic()
            if err:
                return f"{name}: {err}"
        return None


def default_config() -> Config:
    return Config()


def test_config(home: str = "") -> Config:
    """Fast timeouts for tests (reference: config.TestConfig)."""
    cfg = Config()
    cfg.base.home = home
    cfg.base.chain_id = "test-chain"
    cfg.base.db_backend = "memdb"
    cfg.consensus.timeout_propose_ms = 400
    cfg.consensus.timeout_propose_delta_ms = 100
    cfg.consensus.timeout_vote_ms = 100
    cfg.consensus.timeout_vote_delta_ms = 50
    cfg.consensus.timeout_commit_ms = 20
    cfg.consensus.peer_gossip_sleep_duration_ms = 5
    cfg.crypto.backend = "cpu"
    return cfg


# ---------------------------------------------------------------------------
# TOML round-trip
# ---------------------------------------------------------------------------

def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        s = v.replace("\\", "\\\\").replace('"', '\\"')
        s = "".join(
            c if ord(c) >= 0x20 and c != "\x7f" else f"\\u{ord(c):04x}"
            for c in s
        )
        return '"' + s + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    if isinstance(v, dict):
        # inline table; keys always quoted (zone names, node ids)
        return (
            "{"
            + ", ".join(
                f"{_toml_value(str(k))} = {_toml_value(x)}"
                for k, x in v.items()
            )
            + "}"
        )
    raise TypeError(f"unsupported TOML value: {type(v)}")


def _emit_section(name: str, obj) -> str:
    lines = [f"[{name}]"] if name else []
    for f in dc_fields(obj):
        key = f.name.rstrip("_")
        lines.append(f"{key} = {_toml_value(getattr(obj, f.name))}")
    return "\n".join(lines) + "\n"


def dumps(cfg: Config) -> str:
    out = ["# cometbft_tpu_torch node configuration\n"]
    base = _emit_section("", cfg.base)
    # home is a runtime path, not persisted
    base = "\n".join(
        l for l in base.splitlines() if not l.startswith("home = ")
    )
    out.append(base + "\n")
    for name in _SECTIONS:
        out.append("\n" + _emit_section(name, getattr(cfg, name)))
    return "".join(out)


def _fill(obj, doc: dict):
    for f in dc_fields(obj):
        key = f.name.rstrip("_")
        if key in doc:
            setattr(obj, f.name, doc[key])
    return obj


def loads(text: str) -> Config:
    doc = tomllib.loads(text)
    cfg = Config()
    _fill(cfg.base, {k: v for k, v in doc.items() if not isinstance(v, dict)})
    for name in _SECTIONS:
        if name in doc:
            _fill(getattr(cfg, name), doc[name])
    return cfg


def write_config(cfg: Config, path: Optional[str] = None) -> None:
    path = path or _home(cfg.base.home, "config", "config.toml")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(dumps(cfg))


def load_config(home: str) -> Config:
    path = _home(home, "config", "config.toml")
    with open(path) as f:
        cfg = loads(f.read())
    cfg.base.home = home
    return cfg
