"""A small seeded chain driven through either package's apply path.

``drive("cometbft_tpu", ...)`` and ``drive("cometbft_tpu_torch", ...)`` run
the same script: genesis, ``InitChain`` on a ``KVStoreApplication`` through
``LocalClient``, then ``heights`` blocks made by ``make_block``, cut into
part sets, saved with a seen commit and applied by
``BlockExecutor.apply_block`` over one store (``MemKV`` unless ``db`` is
given), with an ``EvidencePool`` and an ``EventBus`` subscriber.  Keys,
txs and times come from a numpy seed, so both packages sign and hash the
same bytes.  The module imports neither package at the top: the jax-free
subprocess of ``tests/test_torch_import_audit.py`` drives the port with
it.
"""

from __future__ import annotations

import base64
import importlib
from types import SimpleNamespace

import numpy as np

CHAIN_ID = "apply-test-chain"
T0 = 1_700_000_000
POWER = 10

_MODULES = {
    "at": "abci.types",
    "client": "abci.client",
    "kvstore": "abci.kvstore",
    "basic": "types.basic",
    "block": "types.block",
    "evidence": "types.evidence",
    "genesis": "types.genesis",
    "vote": "types.vote",
    "events": "types.events",
    "pubsub": "libs.pubsub",
    "kv": "store.kv",
    "block_store": "store.block_store",
    "state": "state.state",
    "state_store": "state.store",
    "execution": "state.execution",
    "pool": "evidence.pool",
    "mempool": "mempool.clist_mempool",
    "keys": "crypto.keys",
    "merkle": "crypto.merkle",
    "validator": "types.validator",
    "light": "types.light",
    "codec": "types.codec",
    "part_set": "types.part_set",
    "params": "types.params",
    "everify": "evidence.verify",
    "validation": "types.validation",
    "diskguard": "libs.diskguard",
    "storage_stats": "libs.storage_stats",
}


def modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}")
                              for k, v in _MODULES.items()})


def seeds(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def txs_at(height: int, n: int, seed: int) -> list:
    """``n`` KVStore txs (``key=value``) of one height."""
    rng = np.random.default_rng(seed * 1000 + height)
    return [b"k%d-%d=%s" % (height, i, rng.bytes(12).hex().encode())
            for i in range(n)]


def val_tx(m, priv, power: int) -> bytes:
    return (m.kvstore.VALIDATOR_PREFIX + base64.b64encode(priv.pub_key().bytes())
            + b"!%d" % power)


def signed_vote(m, priv, valset, height: int, block_id, ts, round_: int = 0):
    addr = priv.pub_key().address()
    idx, _ = valset.get_by_address(addr)
    v = m.vote.Vote(type_=m.basic.PRECOMMIT_TYPE, height=height, round_=round_,
                    block_id=block_id, timestamp=ts, validator_address=addr,
                    validator_index=idx)
    v.signature = priv.sign(v.sign_bytes(CHAIN_ID))
    return v


def sign_commit(m, privs_by_addr, valset, height: int, block_id, absent=()):
    """Every validator of ``valset`` signs a precommit for ``block_id``,
    each at its own time, except those at the indices in ``absent``."""
    sigs = []
    for i, v in enumerate(valset.validators):
        if i in absent:
            sigs.append(m.vote.CommitSig.absent_sig())
            continue
        ts = m.basic.Timestamp(T0 + height, 1000 * (i + 1))
        cs = m.vote.CommitSig(m.basic.BLOCK_ID_FLAG_COMMIT, v.address, ts, b"")
        sigs.append(cs)
    commit = m.block.Commit(height, 0, block_id, sigs)
    for i, cs in enumerate(sigs):
        if not cs.absent():
            cs.signature = privs_by_addr[cs.validator_address].sign(
                commit.vote_sign_bytes(CHAIN_ID, i))
    return commit


def duplicate_vote(m, privs, state_store, block_store, height: int, who: int):
    """Evidence that validator ``who`` precommitted two blocks at
    ``height``, with the power and time the chain recorded there."""
    vals = state_store.load_validators(height)
    meta = block_store.load_block_meta(height)
    ts = m.basic.Timestamp(T0 + height, 7)
    bid = [m.basic.BlockID(bytes([c]) * 32, m.basic.PartSetHeader(1, bytes([c + 1]) * 32))
           for c in (0xA0, 0xB0)]
    va, vb = (signed_vote(m, privs[who], vals, height, b, ts) for b in bid)
    _, val = vals.get_by_address(privs[who].pub_key().address())
    return m.evidence.DuplicateVoteEvidence.from_votes(
        va, vb, meta.header.time, val.voting_power, vals.total_voting_power())


class Chain:
    """One node's apply path over a store, ready to take blocks."""

    def __init__(self, pkg: str, n_vals: int = 4, seed: int = 20261031,
                 db=None, executor_kw=None, pool_kw=None):
        m = self.m = modules(pkg)
        self.privs = [m.keys.Ed25519PrivKey.from_seed(s) for s in seeds(n_vals, seed)]
        self.by_addr = {p.pub_key().address(): p for p in self.privs}
        self.seed = seed
        self.genesis = m.genesis.GenesisDoc(
            chain_id=CHAIN_ID,
            genesis_time=m.basic.Timestamp(T0, 0),
            validators=[m.genesis.GenesisValidator(p.pub_key(), POWER, f"val{i}")
                        for i, p in enumerate(self.privs)],
        )
        self.genesis.validate_and_complete()
        state = m.state.state_from_genesis(self.genesis)
        self.db = db if db is not None else m.kv.MemKV()
        self.state_store = m.state_store.StateStore(self.db)
        self.block_store = m.block_store.BlockStore(self.db)
        self.app = m.kvstore.KVStoreApplication()
        self.client = m.client.LocalClient(self.app)
        res = self.client.init_chain(m.at.InitChainRequest(
            time_unix_ns=self.genesis.genesis_time.to_ns(),
            chain_id=CHAIN_ID,
            validators=[m.at.ValidatorUpdate("ed25519", p.pub_key().bytes(), POWER)
                        for p in self.privs],
            app_state_bytes=self.genesis.app_state,
            initial_height=self.genesis.initial_height,
        ))
        state.app_hash = res.app_hash
        self.state_store.bootstrap(state)
        self.state = state
        self.pool = m.pool.EvidencePool(self.db, self.state_store, self.block_store,
                                        **(pool_kw or {}))
        self.bus = m.events.EventBus()
        self.sub = self.bus.subscribe("test", m.pubsub.Query.parse("tm.event EXISTS"),
                                      capacity=100_000)
        self.executor = m.execution.BlockExecutor(
            self.state_store, self.block_store, self.client,
            m.mempool.NopMempool(), evidence_pool=self.pool, event_bus=self.bus,
            **(executor_kw or {}))
        self.last_commit = m.block.empty_commit()

    def make_block(self, height: int, txs: list, evidence=()):
        m, st = self.m, self.state
        block = m.execution.make_block(
            height, txs, self.last_commit, st,
            st.validators.get_proposer().address, m.basic.Timestamp(T0 + height, 0))
        if evidence:
            block.evidence = list(evidence)
            block.header.evidence_hash = m.evidence.evidence_list_hash(block.evidence)
        return block

    def commit_for(self, block, part_set, absent=()):
        bid = self.m.basic.BlockID(block.hash(), part_set.header)
        return bid, sign_commit(self.m, self.by_addr, self.state.validators,
                                block.header.height, bid, absent)

    def apply(self, block, absent=(), part_size: int = 65536):
        """Part set, save with a seen commit, ``apply_block``; the commit
        becomes the next block's LastCommit."""
        parts = block.make_part_set(part_size)
        bid, commit = self.commit_for(block, parts, absent)
        self.block_store.save_block(block, parts, commit)
        self.state = self.executor.apply_block(self.state, bid, block)
        self.last_commit = commit
        return bid

    def events(self) -> list:
        """(tags, data type) of every event published so far."""
        out = []
        while True:
            msg = self.sub.next(timeout=0)
            if msg is None:
                return out
            out.append((msg.tags, type(msg.data).__name__))


def drive(pkg: str, heights: int = 4, txs: int = 8, val_update_at: int = 2,
          evidence_at: int = 3, **kw) -> "tuple[Chain, list]":
    """The script: ``txs`` txs a block, one ``val:`` tx at ``val_update_at``
    (validator 1 to power 20), a duplicate vote of validator 2 at height 1
    in the block at ``evidence_at``, the last validator absent from every
    commit.  Returns the chain and, per height, (state JSON, app hash,
    results hash, validators hash, next validators hash, events)."""
    c = Chain(pkg, **kw)
    n = len(c.privs)
    out = []
    for h in range(1, heights + 1):
        body = txs_at(h, txs, c.seed)
        if h == val_update_at:
            body.append(val_tx(c.m, c.privs[1], 2 * POWER))
        ev = ()
        if h == evidence_at:
            ev = [duplicate_vote(c.m, c.privs, c.state_store, c.block_store, 1, 2)]
        c.apply(c.make_block(h, body, ev), absent=(n - 1,))
        s = c.state
        out.append((s.to_json(), s.app_hash, s.last_results_hash,
                    s.validators.hash(), s.next_validators.hash(), c.events()))
    return c, out
