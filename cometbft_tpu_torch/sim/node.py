"""Validator node assembly shared by the simulator and the test harness.

This is ``tests/net_harness.py``'s node wiring promoted into the package:
kvstore app, ``BlockStore``/``StateStore`` over one KV db, ``Handshaker``
replay on boot, WAL, FilePV — everything a real node has except sockets.
The sim passes ``clock``/``ticker_factory``/``threaded=False`` to run the
consensus state machine on virtual time; the thread-based loopback harness
passes nothing and gets wall-clock behaviour.

Crash-restart support falls out of the assembly being a function of
``(db, home)``: keep the ``MemKV`` and the home dir (WAL + privval files),
call ``build_node`` again, and the ``Handshaker`` + WAL catchup replay
rebuild the consensus state the dead process was in.

``device=None`` means the card: ``BlockExecutor``, ``EvidencePool`` and the
``Handshaker`` get it, and a node built with no card raises unless the
caller names the CPU (``device="cpu"`` or
``COMETBFT_TPU_CRYPTO_BACKEND=cpu``).  On the card ``build_node`` resolves
the batch backend (``crypto/batch.default_backend``: the kernel's
known-answer self-check, once per process) before it returns, so that the
verify scheduler's gate is open for the node's first proposal and vote.
``HandleProvider`` is a statesync joiner's light-block provider over a
live ``NodeHandle``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config.config import ConsensusConfig, MempoolConfig
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.evidence.pool import EvidencePool
from cometbft_tpu_torch.mempool.clist_mempool import CListMempool
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.proxy.multi_app_conn import AppConns, local_client_creator
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import state_from_genesis
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.block_store import BlockStore
from cometbft_tpu_torch.store.kv import MemKV
from cometbft_tpu_torch.types.basic import Timestamp
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.validation import entry_device


@dataclass
class NodeHandle:
    """Everything a driver needs to poke at one assembled validator."""

    index: int
    cs: ConsensusState
    app: KVStoreApplication
    app_conns: AppConns
    mempool: CListMempool
    block_store: BlockStore
    state_store: StateStore
    event_bus: EventBus
    priv_val: FilePV
    evidence_pool: EvidencePool


def sim_consensus_config() -> ConsensusConfig:
    """Round-trip friendly virtual-time timeouts (virtual seconds are free,
    so these only shape the event schedule, not the wall-clock runtime)."""
    return ConsensusConfig(
        timeout_propose_ms=1000,
        timeout_propose_delta_ms=500,
        timeout_vote_ms=500,
        timeout_vote_delta_ms=250,
        # ~1 height per virtual second: keeps scripted fault times (t=3.0,
        # heal at t=25.0, ...) meaningful in heights, like production pacing
        timeout_commit_ms=1000,
    )


def make_genesis(
    n_vals: int,
    chain_id: str,
    seed_tag: bytes = b"netval%d",
    n_nodes: Optional[int] = None,
) -> tuple[list[Ed25519PrivKey], GenesisDoc]:
    """Deterministic validator keys + a genesis doc naming the first
    ``n_vals`` of them.  ``n_nodes`` (>= n_vals) mints extra keys for
    standby full nodes — churn/rotation scenarios later join them via
    statesync and vote them in with ``val:`` txs."""
    privs = [
        Ed25519PrivKey.from_seed(hashlib.sha256(seed_tag % i).digest())
        for i in range(max(n_vals, n_nodes or 0))
    ]
    gdoc = GenesisDoc(
        chain_id=chain_id,
        genesis_time=Timestamp(0, 0),
        validators=[
            GenesisValidator(p.pub_key(), 10) for p in privs[:n_vals]
        ],
    )
    return privs, gdoc


class HandleProvider:
    """Light-block provider over a live ``NodeHandle`` (the in-process
    analog of ``light.provider.NodeProvider``): a statesync joiner's light
    client reads headers/commits/validator sets straight from a helper
    peer's stores, so snapshot trust verification runs the production
    light-client path on the virtual clock."""

    def __init__(self, handle: "NodeHandle", chain_id: str):
        self.handle = handle
        self._chain_id = chain_id

    def chain_id(self) -> str:
        return self._chain_id

    def id(self) -> str:
        return f"simnode:{self.handle.index}"

    def light_block(self, height: int):
        from cometbft_tpu_torch.light.provider import ErrLightBlockNotFound
        from cometbft_tpu_torch.types.light import LightBlock, SignedHeader

        bs = self.handle.block_store
        h = height or bs.height()
        meta = bs.load_block_meta(h)
        commit = bs.load_block_commit(h) or bs.load_seen_commit(h)
        vals = self.handle.state_store.load_validators(h)
        if meta is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(f"height {h}")
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def report_evidence(self, ev) -> None:
        self.handle.evidence_pool.add_evidence(ev)

    def consensus_params(self, height: int):
        params = self.handle.state_store.load_consensus_params(height)
        if params is None:
            params = self.handle.cs.state.consensus_params
        return params


def build_node(
    index: int,
    priv: Ed25519PrivKey,
    gdoc: GenesisDoc,
    root,
    config: Optional[ConsensusConfig] = None,
    db=None,
    clock: Optional[Callable[[], float]] = None,
    ticker_factory: Optional[Callable] = None,
    threaded: bool = True,
    app_factory: Optional[Callable] = None,
    mempool_config: Optional[MempoolConfig] = None,
    app=None,
    app_conns=None,
    device=None,
) -> NodeHandle:
    """Assemble one validator under ``root/node{index}``.

    ``db`` defaults to a fresh ``MemKV``; pass the previous instance (plus
    the same ``root``) to model a crash-restart from persisted stores.
    ``app_factory`` overrides the default kvstore app: a node that admits
    signed envelopes wraps it in ``txingest.SigVerifyingApp``, so that
    envelope traffic takes the batched admission path.  ``app``/``app_conns``
    hand in an ALREADY-RUNNING application (the statesync join path: the
    syncer restored a snapshot into it before the node is assembled, so
    the handshake must see that instance, not a fresh one).
    """
    device = entry_device(device)
    config = config or sim_consensus_config()
    home = root / f"node{index}"
    home.mkdir(parents=True, exist_ok=True)
    db = db if db is not None else MemKV()
    block_store = BlockStore(db)
    state_store = StateStore(db)

    if app is None:
        app = app_factory() if app_factory is not None else KVStoreApplication()
    if app_conns is None:
        conns = AppConns(local_client_creator(app))
        conns.start()
    else:
        conns = app_conns

    state = state_store.load()
    if state is None:
        state = state_from_genesis(gdoc)

    event_bus = EventBus()
    evidence_pool = EvidencePool(db, state_store, block_store, device=device)
    handshaker = Handshaker(
        state_store,
        block_store,
        gdoc,
        event_bus=event_bus,
        evidence_pool=evidence_pool,
        device=device,
    )
    state = handshaker.handshake(state, conns)
    evidence_pool.state = state

    info = conns.query.info()
    mempool = CListMempool(
        mempool_config or MempoolConfig(recheck=False),
        conns.mempool,
        height=state.last_block_height,
        lane_priorities=dict(info.lane_priorities),
        default_lane=info.default_lane,
        envelope_aware=getattr(info, "envelope_sig_verified", False),
    )
    block_exec = BlockExecutor(
        state_store,
        block_store,
        conns.consensus,
        mempool,
        evidence_pool=evidence_pool,
        event_bus=event_bus,
        device=device,
    )
    key_path = str(home / "pv_key.json")
    state_path = str(home / "pv_state.json")
    pv = FilePV.load_or_generate(key_path, state_path)
    if pv.pub_key().address() != priv.pub_key().address():
        # first boot: install the deterministic genesis key (a restart must
        # keep the persisted last-sign state for double-sign protection)
        pv = FilePV(priv, key_path, state_path)
        pv.save()

    wal = WAL(str(home / "cs.wal"))
    cs = ConsensusState(
        config,
        state,
        block_exec,
        block_store,
        mempool,
        priv_validator=pv,
        wal=wal,
        evidence_pool=evidence_pool,
        event_bus=event_bus,
        clock=clock,
        ticker_factory=ticker_factory,
        threaded=threaded,
    )
    return NodeHandle(
        index=index,
        cs=cs,
        app=app,
        app_conns=conns,
        mempool=mempool,
        block_store=block_store,
        state_store=state_store,
        event_bus=event_bus,
        priv_val=pv,
        evidence_pool=evidence_pool,
    )
