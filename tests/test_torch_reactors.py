"""The port's protocol reactors against the JAX package's: the consensus
reactor's ``PeerState`` and gossip, the mempool reactor and the evidence
reactor.

* ``PeerState``: the same sequence of state-channel messages (new round
  steps across rounds and heights, proposals, parts, votes, vote-set
  bits, a valid block) leaves the same state in both packages.
* Gossip: one seeded round state (height 3 of ``tests/torch_chain``'s
  4-validator chain: a proposal cut into parts, three prevotes and one
  precommit, height 2's precommits as the last commit) is offered to a
  stub peer at the same height, one height behind and two behind;
  ``_gossip_data_once`` and ``_gossip_votes_once`` send the same
  messages, byte for byte, in the same order, until both have nothing
  left to send.
* Mempool: the same pool contents go out to a stub peer as the same
  bytes (the txs the peer sent us skipped), and the same txs coming in
  (new, duplicate, malformed) give the same per-peer stats and pool.
* Evidence: a pending duplicate vote goes out as the same bytes; the
  same bytes coming in are admitted by the other pool, and undecodable
  bytes stop the peer.

Both packages run with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu`` (the JAX
package's ``COMETBFT_TPU_TXINGEST=0`` as well); the port's signature
batches go through the supervisor's device-runner seam answering from
the pure-Python oracle, so no plain verify runs.  Every wait has a
deadline and every reactor started is stopped in a ``finally``.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch_chain as tc
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch import verifysched as tvs

J, P = "cometbft_tpu", "cometbft_tpu_torch"
PKGS = (J, P)
WAIT_S = 30.0
CPU = {"executor_kw": {"device": "cpu"}, "pool_kw": {"device": "cpu"}}


def _oracle(backend, pubs, msgs, sigs, lanes):
    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [len(p) == 32 and len(s) == 64 and ref.verify_zip215(p, m, s)
                        for p, m, s in zip(pubs, msgs, sigs)]
    return out


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("COMETBFT_TPU_TXINGEST", "0")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()
    tsup.set_device_runner(_oracle)
    yield
    tsup.clear_device_runner()
    tvs.reset_scheduler()
    tsc.reset_cache()


def mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


class StubPeer:
    """A peer that records what reactors send it."""

    def __init__(self, node_id="aa" * 20):
        self.id = node_id
        self.sent = []
        self.is_running = True
        self.is_outbound = True
        self._data = {}

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, bytes(msg)))
        return True

    send = try_send

    def set(self, key, value):
        self._data[key] = value

    def get(self, key, default=None):
        return self._data.get(key, default)


# -- PeerState ---------------------------------------------------------------


def _peer_state_script(pkg):
    cm, basic = mod(pkg, "consensus.messages"), mod(pkg, "types.basic")
    ct, cr = mod(pkg, "consensus.types"), mod(pkg, "consensus.reactor")
    psh = basic.PartSetHeader(3, b"\x11" * 32)
    bid = basic.BlockID(b"\x22" * 32, psh)
    ps = cr.PeerState(StubPeer())
    out = []

    def snap():
        psh_ = ps.proposal_psh
        out.append((ps.height, ps.round_, ps.step, ps.proposal,
                    None if psh_ is None else (psh_.total, psh_.hash),
                    list(ps.proposal_parts), ps.proposal_pol_round, list(ps.proposal_pol),
                    {r: list(b) for r, b in sorted(ps.prevotes.items())},
                    {r: list(b) for r, b in sorted(ps.precommits.items())},
                    ps.last_commit_round, list(ps.last_commit), ps.start_time))

    steps = [
        lambda: ps.apply_new_round_step(cm.NewRoundStepMessage(5, 0, ct.STEP_PROPOSE, 2, 0)),
        lambda: ps.set_has_proposal(5, 0, psh),
        lambda: ps.set_has_part(5, 0, 1),
        lambda: ps.set_has_part(5, 0, 7),  # out of range: ignored
        lambda: ps.set_has_vote(5, 0, basic.PREVOTE_TYPE, 2),
        lambda: ps.set_has_vote(5, 0, basic.PRECOMMIT_TYPE, 0),
        lambda: ps.set_has_vote(5, 0, basic.PRECOMMIT_TYPE, 3),
        lambda: ps.apply_vote_set_bits(cm.VoteSetBitsMessage(
            5, 0, basic.PREVOTE_TYPE, bid, [True, False, False, True])),
        lambda: ps.apply_new_round_step(cm.NewRoundStepMessage(5, 1, ct.STEP_PREVOTE, 4, 0)),
        lambda: ps.apply_new_round_step(cm.NewRoundStepMessage(5, 0, ct.STEP_PROPOSE, 0, 0)),
        lambda: ps.apply_new_valid_block(cm.NewValidBlockMessage(
            5, 1, psh, [True, False, True], False)),
        lambda: ps.set_has_vote(5, 1, basic.PRECOMMIT_TYPE, 1),
        lambda: ps.apply_new_round_step(cm.NewRoundStepMessage(6, 0, ct.STEP_NEW_HEIGHT, 1, 1)),
        lambda: ps.set_has_vote(5, 1, basic.PRECOMMIT_TYPE, 2),  # last commit
        lambda: ps.set_has_vote(5, 0, basic.PRECOMMIT_TYPE, 2),  # another round: ignored
        lambda: ps.apply_new_round_step(cm.NewRoundStepMessage(9, 0, ct.STEP_NEW_HEIGHT, 0, 0)),
    ]
    for step in steps:
        step()
        snap()
    return out


def test_peer_state_after_the_same_messages(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    assert _peer_state_script(P) == _peer_state_script(J)


# -- consensus gossip ---------------------------------------------------------


def _round_state(pkg):
    """Height 3 of the chain, proposed and partly voted, over the chain's
    stores (heights 1-2)."""
    c = tc.Chain(pkg, **(CPU if pkg == P else {}))
    for h in (1, 2):
        c.apply(c.make_block(h, tc.txs_at(h, 8, c.seed)), absent=(3,))
    m, ct = c.m, mod(pkg, "consensus.types")
    vs_mod = mod(pkg, "types.vote_set")
    block = c.make_block(3, tc.txs_at(3, 40, c.seed))
    parts = block.make_part_set(512)
    bid = m.basic.BlockID(block.hash(), parts.header)
    proposer = c.by_addr[c.state.validators.get_proposer().address]
    prop = m.vote.Proposal(3, 0, -1, bid, m.basic.Timestamp(tc.T0 + 3, 5))
    prop.signature = proposer.sign(prop.sign_bytes(tc.CHAIN_ID))
    hvs = ct.HeightVoteSet(tc.CHAIN_ID, 3, c.state.validators)
    ts = m.basic.Timestamp(tc.T0 + 3, 9)
    for i in range(3):
        v = tc.signed_vote(m, c.privs[i], c.state.validators, 3, bid, ts)
        v.type_ = m.basic.PREVOTE_TYPE
        v.signature = c.privs[i].sign(v.sign_bytes(tc.CHAIN_ID))
        hvs.prevotes(0).add_vote(v, verify=False)
    hvs.precommits(0).add_vote(tc.signed_vote(m, c.privs[0], c.state.validators, 3, bid, ts),
                               verify=False)
    last = vs_mod.VoteSet(tc.CHAIN_ID, 2, 0, m.basic.PRECOMMIT_TYPE, c.state.last_validators)
    for i in range(len(c.last_commit.signatures)):
        v = m.block.commit_vote(c.last_commit, i)
        if v is not None:
            last.add_vote(v, verify=False)
    rs = ct.RoundState(height=3, round_=0, step=ct.STEP_PREVOTE, proposal=prop,
                       proposal_block=block, proposal_block_parts=parts, votes=hvs,
                       last_commit=last, validators=c.state.validators)
    cs = SimpleNamespace(rs=rs, _mtx=threading.RLock(), state=c.state, broadcast_hook=None,
                         _started=True, add_step_listener=lambda fn: None,
                         add_vote_listener=lambda fn: None)
    return c, cs


@pytest.mark.parametrize("peer_height", [3, 2, 1])
def test_gossip_sends_the_same_messages(peer_height):
    out = []
    for pkg in PKGS:
        c, cs = _round_state(pkg)
        cm, ct = mod(pkg, "consensus.messages"), mod(pkg, "consensus.types")
        r = mod(pkg, "consensus.reactor").ConsensusReactor(cs, c.block_store)
        peer = StubPeer()
        ps = mod(pkg, "consensus.reactor").PeerState(peer)
        ps.apply_new_round_step(cm.NewRoundStepMessage(
            peer_height, 0, ct.STEP_PROPOSE, 0, 0 if peer_height > 1 else -1))
        sends = []
        for routine in (r._gossip_data_once, r._gossip_votes_once):
            for _ in range(200):
                if not routine(peer, ps):
                    break
            else:
                raise AssertionError(f"{routine.__name__} never ran dry")
            sends.append(list(peer.sent))
            peer.sent.clear()
        out.append((sends, ps.proposal, list(ps.proposal_parts),
                    {r_: list(b) for r_, b in ps.prevotes.items()},
                    {r_: list(b) for r_, b in ps.precommits.items()}, list(ps.last_commit)))
    assert out[0] == out[1]
    data, votes = out[1][0]
    if peer_height == 3:
        # the proposal, then every part; three prevotes, one precommit
        assert data[0][0] == 0x21 and len(data) >= 3 and len(votes) == 4
    elif peer_height == 2:
        assert data and len(votes) == 3  # block 2's part, our last commit's votes
    else:
        assert data and len(votes) == 3  # block 1's part, its commit's votes


# -- the mempool reactor -------------------------------------------------------


TXS = [b"k%d=%s" % (i, b"v" * (i % 7)) for i in range(12)]
INCOMING = [b"n1=1", TXS[0], b"no-equals", b"n2=2", b"n1=1"]


def _mempool_run(pkg):
    cm, cfg = mod(pkg, "mempool.clist_mempool"), mod(pkg, "config.config")
    mr = mod(pkg, "mempool.reactor")
    app = mod(pkg, "abci.kvstore").KVStoreApplication()
    mp = cm.CListMempool(cfg.MempoolConfig(), app, height=1)
    peer = StubPeer("bb" * 20)
    for i, tx in enumerate(TXS):
        mp.check_tx(tx, sender=peer.id if i % 4 == 0 else "")
    r = mr.MempoolReactor(cfg.MempoolConfig(), mp)
    assert [d.id for d in r.get_channels()] == [0x30]
    r.start()
    try:
        r.add_peer(peer)
        want = len([i for i in range(len(TXS)) if i % 4])
        _wait(lambda: len(peer.sent) >= want, "the broadcast")
        time.sleep(0.05)  # nothing more may come
        r.remove_peer(peer, "done")
        for tx in INCOMING:
            r.receive(0x30, peer, tx)
        return (list(peer.sent), r.peer_ingest_stats(), mp.size(),
                mp.reap_max_txs(-1))
    finally:
        r.stop()


def test_mempool_reactor_bytes_and_stats():
    want, got = _mempool_run(J), _mempool_run(P)
    assert got == want
    assert got[1] == {"bb" * 20: {"accepted": 2, "dedup": 2, "rejected": 1, "error": 0}}


# -- the evidence reactor ------------------------------------------------------


class StubSwitch:
    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, err):
        self.stopped.append((peer.id, type(err).__name__))


def _evidence_run(pkg):
    er, codec = mod(pkg, "evidence.reactor"), mod(pkg, "types.codec")
    chains = []
    for _ in range(2):
        c = tc.Chain(pkg, **(CPU if pkg == P else {}))
        for h in (1, 2):
            c.apply(c.make_block(h, tc.txs_at(h, 4, c.seed)), absent=(3,))
        chains.append(c)
    a, b = chains
    ev = tc.duplicate_vote(a.m, a.privs, a.state_store, a.block_store, 1, 2)
    a.pool.add_evidence(ev)
    ra, rb = er.EvidenceReactor(a.pool), er.EvidenceReactor(b.pool)
    sw = StubSwitch()
    rb.set_switch(sw)
    peer = StubPeer("cc" * 20)
    ra.start()
    try:
        ra.add_peer(peer)
        _wait(lambda: peer.sent, "the evidence")
        time.sleep(0.15)  # one more pass of the routine: nothing new
        ra.remove_peer(peer, "done")
    finally:
        ra.stop()
    for _, raw in peer.sent:
        rb.receive(0x38, peer, raw)
    rb.receive(0x38, peer, b"\xff\x00garbage")
    return (peer.sent, codec.encode_evidence(ev), [e.hash() for e in b.pool.all_pending()],
            sw.stopped)


def test_evidence_reactor_bytes():
    want, got = _evidence_run(J), _evidence_run(P)
    assert got == want
    sent, enc, pending, stopped = got
    assert sent == [(0x38, enc)] and len(pending) == 1 and len(stopped) == 1


@pytest.mark.parametrize("pkg", [J, P])
def test_mempool_walk_follows_a_changing_pool(pkg):
    """The broadcast walk, in both packages, sends every tx that is in the
    pool while it walks exactly once, in pool order, carries on past
    removed txs and a removed tail, and never sends a tx again after the
    block that committed it."""
    cm, cfg = mod(pkg, "mempool.clist_mempool"), mod(pkg, "config.config")
    at = mod(pkg, "abci.types")
    app = mod(pkg, "abci.kvstore").KVStoreApplication()
    mp = cm.CListMempool(cfg.MempoolConfig(recheck=False), app, height=1)
    r = mod(pkg, "mempool.reactor").MempoolReactor(cfg.MempoolConfig(), mp)
    peer = StubPeer("dd" * 20)
    first = [b"a%d=1" % k for k in range(6)]
    for tx in first:
        mp.check_tx(tx)
    r.start()
    try:
        r.add_peer(peer)
        _wait(lambda: len(peer.sent) == 6, "the first txs")
        ok = [at.ExecTxResult(code=0) for _ in range(3)]
        with mp._mtx:  # a block commits the tail and one in the middle
            mp.update(2, [first[5], first[2], first[4]], ok)
        second = [b"b%d=2" % k for k in range(4)]
        for tx in second:
            mp.check_tx(tx)
        _wait(lambda: len(peer.sent) == 10, "the second txs")
        with mp._mtx:  # every tx committed: the lane is empty
            mp.update(3, [t for t in first + second if t not in (first[5], first[2], first[4])],
                      [at.ExecTxResult(code=0)] * 7)
        third = [b"c%d=3" % k for k in range(3)]
        for tx in third:
            mp.check_tx(tx)
        _wait(lambda: len(peer.sent) == 13, "the third txs")
        time.sleep(0.1)  # nothing more may come
    finally:
        r.remove_peer(peer, "done")
        r.stop()
    assert [m for _, m in peer.sent] == first + second + third


def test_internal_message_past_a_full_queue(tmp_path, monkeypatch):
    """The consensus thread queues its own proposal or vote even when
    peers filled the input queue (the consumer would otherwise wait on
    itself); it lands last, in FIFO order, and the bound still holds
    for peer messages."""
    import queue

    sn = mod(P, "sim.node")
    privs, gdoc = sn.make_genesis(1, "queue-chain")
    h = sn.build_node(0, privs[0], gdoc, tmp_path, threaded=False, device="cpu")
    try:
        q = h.cs._queue
        while not q.full():
            q.put_nowait(("peer", "filler"))
        n = q.qsize()
        done = threading.Event()
        threading.Thread(target=lambda: (h.cs._add_internal_message("mine"), done.set()),
                         daemon=True).start()
        assert done.wait(10), "the internal message blocked on the full queue"
        assert q.qsize() == n + 1
        with pytest.raises(queue.Full):
            q.put(("peer", "late"), timeout=0.05)
        items = [q.get_nowait() for _ in range(n + 1)]
        assert items[-1][0] == "internal" and items[-1][1].msg == "mine"
    finally:
        h.app_conns.stop()
