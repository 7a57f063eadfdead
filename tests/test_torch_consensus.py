"""The consensus core's modules held against the JAX package's, case by case.

The same keys (from a numpy seed), votes, messages, timeouts and txs go
through both packages: ``types/vote_set`` (two thirds, conflicts,
``make_commit``/``make_extended_commit``), every consensus message's wire
and WAL encoding (byte-equal, with round trips), ``consensus/ticker`` and
``sim/clock.SimTicker``, ``privval/file_pv`` (signatures, the
refuse-to-double-sign rule, its files byte for byte), ``config/config``
(defaults and TOML), ``consensus/wal`` (files byte-equal, replay, rotation,
a torn-tail repair, and the port's C++-only writer) and
``mempool/clist_mempool`` (admission, reap, update and the serial recheck,
against the JAX mempool with ingestion off).

Both packages run on the host here: ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``
keeps both verify schedulers' gates closed, so a vote is checked by
``verify_now`` in each, and no JAX program is compiled.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import threading
import time

import numpy as np
import pytest

J = "cometbft_tpu"
P = "cometbft_tpu_torch"
CHAIN = "consensus-test-chain"
PKGS = (J, P)


@pytest.fixture(autouse=True)
def _host_only(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("COMETBFT_TPU_TXINGEST", "0")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def privs(pkg: str, n: int, seed: int = 11):
    keys = mod(pkg, "crypto.keys")
    rng = np.random.default_rng(seed)
    return [keys.Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]


def valset(pkg: str, ps, powers):
    v = mod(pkg, "types.validator")
    return v.ValidatorSet([v.Validator(p.pub_key(), w) for p, w in zip(ps, powers)])


def block_id(pkg: str, tag: int):
    b = mod(pkg, "types.basic")
    if tag == 0:
        return b.BlockID()
    return b.BlockID(bytes([tag]) * 32, b.PartSetHeader(1 + tag % 3, bytes([tag + 1]) * 32))


def make_vote(pkg, ps, vs, i, type_, tag, height=5, round_=1, ext=b"", sign=True):
    b, vote = mod(pkg, "types.basic"), mod(pkg, "types.vote")
    p = ps[i]
    idx, _ = vs.get_by_address(p.pub_key().address())
    v = vote.Vote(type_=type_, height=height, round_=round_, block_id=block_id(pkg, tag),
                  timestamp=b.Timestamp(1_700_000_000 + i, 1000 * i),
                  validator_address=p.pub_key().address(), validator_index=idx)
    if ext and type_ == b.PRECOMMIT_TYPE and tag:
        v.extension = ext
        v.extension_signature = p.sign(v.extension_sign_bytes(CHAIN))
    if sign:
        v.signature = p.sign(v.sign_bytes(CHAIN))
    return v


def outcome(fn):
    """The result of ``fn()``, or the name of the error it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class is what we compare
        return ("raised", type(e).__name__)


# -- types/vote_set -----------------------------------------------------------

VOTE_SCRIPTS = {
    # (powers, [(validator, tag)]); tag 0 is nil
    "all-for-a": ([10, 10, 10, 10], [(0, 7), (1, 7), (2, 7), (3, 7)]),
    "three-of-four": ([10, 10, 10, 10], [(0, 7), (1, 7), (2, 7)]),
    "two-of-four": ([10, 10, 10, 10], [(0, 7), (3, 7)]),
    "split-then-nil": ([10, 10, 10, 10], [(0, 7), (1, 9), (2, 0), (3, 0)]),
    "nil-majority": ([10, 10, 10, 10], [(0, 0), (1, 0), (2, 0)]),
    "weighted": ([50, 10, 10, 5], [(1, 7), (2, 7), (0, 7)]),
    "weighted-short": ([50, 10, 10, 5], [(1, 7), (2, 7), (3, 7)]),
    "seven-mixed": ([3, 5, 7, 11, 13, 17, 19],
                    [(6, 4), (5, 4), (0, 0), (4, 4), (3, 4), (1, 4), (2, 0)]),
}


def _vote_set_run(pkg, script, type_name, ext):
    powers, script_votes = VOTE_SCRIPTS[script]
    b, vsm, codec = mod(pkg, "types.basic"), mod(pkg, "types.vote_set"), mod(pkg, "types.codec")
    type_ = getattr(b, type_name)
    ps = privs(pkg, len(powers))
    vs = valset(pkg, ps, powers)
    s = vsm.VoteSet(CHAIN, 5, 1, type_, vs)
    log = []
    for i, tag in script_votes:
        v = make_vote(pkg, ps, vs, i, type_, tag, ext=ext)
        added = s.add_vote(v)
        maj = s.two_thirds_majority()
        log.append((added, maj.encode() if maj is not None else None,
                    s.has_two_thirds_majority(), s.has_two_thirds_any(), s.has_all(),
                    s.bit_array(), s.bit_array_by_block_id(block_id(pkg, tag)), s.sum))
        # a duplicate is not added again
        log.append(s.add_vote(v))
    commit = outcome(lambda: codec.encode_commit(s.make_commit()))
    ext_commit = outcome(lambda: codec.encode_extended_commit(s.make_extended_commit()))
    chash = outcome(lambda: s.make_commit().hash())
    return log, commit, ext_commit, chash


@pytest.mark.parametrize("script", sorted(VOTE_SCRIPTS))
@pytest.mark.parametrize("type_name", ["PREVOTE_TYPE", "PRECOMMIT_TYPE"])
def test_vote_set_two_thirds_and_commits(script, type_name):
    ext = b"ext-bytes" if type_name == "PRECOMMIT_TYPE" else b""
    got = [_vote_set_run(pkg, script, type_name, ext) for pkg in PKGS]
    assert got[0] == got[1]


def _conflict_run(pkg, claim_peer_maj23):
    b, vsm, codec = mod(pkg, "types.basic"), mod(pkg, "types.vote_set"), mod(pkg, "types.codec")
    ps = privs(pkg, 4)
    vs = valset(pkg, ps, [10] * 4)
    s = vsm.VoteSet(CHAIN, 5, 1, b.PRECOMMIT_TYPE, vs)
    for i in (0, 1):
        s.add_vote(make_vote(pkg, ps, vs, i, b.PRECOMMIT_TYPE, 7))
    if claim_peer_maj23:
        s.set_peer_maj23("peer-a", block_id(pkg, 9))
    second = make_vote(pkg, ps, vs, 0, b.PRECOMMIT_TYPE, 9)
    try:
        res = ("added", s.add_vote(second))
    except vsm.ConflictingVoteError as e:
        res = ("conflict", codec.encode_vote(e.existing), codec.encode_vote(e.conflicting))
    for i in (2, 3):
        s.add_vote(make_vote(pkg, ps, vs, i, b.PRECOMMIT_TYPE, 9))
    maj = s.two_thirds_majority()
    return (res, s.sum, s.bit_array_by_block_id(block_id(pkg, 7)),
            s.bit_array_by_block_id(block_id(pkg, 9)),
            maj.encode() if maj is not None else None,
            outcome(lambda: codec.encode_commit(s.make_commit())))


@pytest.mark.parametrize("claim_peer_maj23", [False, True])
def test_vote_set_conflicting_votes(claim_peer_maj23):
    got = [_conflict_run(pkg, claim_peer_maj23) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[0][0][0] == ("added" if claim_peer_maj23 else "conflict")


def _reject_run(pkg, case):
    b, vsm = mod(pkg, "types.basic"), mod(pkg, "types.vote_set")
    ps = privs(pkg, 4)
    vs = valset(pkg, ps, [10] * 4)
    s = vsm.VoteSet(CHAIN, 5, 1, b.PREVOTE_TYPE, vs)
    v = make_vote(pkg, ps, vs, 1, b.PREVOTE_TYPE, 7)
    if case == "bad-signature":
        v.signature = bytes([v.signature[0] ^ 1]) + v.signature[1:]
    elif case == "other-height":
        v = make_vote(pkg, ps, vs, 1, b.PREVOTE_TYPE, 7, height=6)
    elif case == "other-type":
        v = make_vote(pkg, ps, vs, 1, b.PRECOMMIT_TYPE, 7)
    elif case == "index-out-of-range":
        v.validator_index = 9
    elif case == "address-mismatch":
        v.validator_index = (v.validator_index + 1) % 4
    elif case == "unsigned":
        v.signature = b""
    elif case == "prevote-with-extension":
        v.extension = b"x"
    try:
        return ("ok", s.add_vote(v), s.sum)
    except vsm.VoteError as e:
        return (type(e).__name__, str(e), s.sum)


@pytest.mark.parametrize("case", ["bad-signature", "other-height", "other-type",
                                  "index-out-of-range", "address-mismatch",
                                  "unsigned", "prevote-with-extension", "good"])
def test_vote_set_rejections(case):
    got = [_reject_run(pkg, case) for pkg in PKGS]
    assert got[0] == got[1]
    assert (got[0][0] == "ok") == (case == "good")


def test_height_vote_set_rounds_and_pol():
    def run(pkg):
        b, ct = mod(pkg, "types.basic"), mod(pkg, "consensus.types")
        ps = privs(pkg, 4)
        vs = valset(pkg, ps, [10] * 4)
        hvs = ct.HeightVoteSet(CHAIN, 5, vs)
        hvs.set_round(3)
        out = []
        for r in (0, 2):
            for i in range(3):
                v = make_vote(pkg, ps, vs, i, b.PREVOTE_TYPE, 4 + r, round_=r)
                out.append(hvs.add_vote(v, "p"))
        pol_round, pol_id = hvs.pol_info()
        rs = ct.RoundState()
        return out, pol_round, pol_id.encode(), rs.step_name(), rs.proposal_complete()
    got = [run(pkg) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[0][1] == 2


# -- consensus/messages -------------------------------------------------------

def _messages(pkg):
    b, vote, msgs, ps_mod = (mod(pkg, "types.basic"), mod(pkg, "types.vote"),
                             mod(pkg, "consensus.messages"), mod(pkg, "types.part_set"))
    ps = privs(pkg, 4)
    vs = valset(pkg, ps, [10] * 4)
    parts = ps_mod.PartSet.from_data(bytes(range(256)) * 40, 4096)
    prop = vote.Proposal(height=9, round_=2, pol_round=1, block_id=b.BlockID(
        b"\x55" * 32, parts.header), timestamp=b.Timestamp(1_700_000_123, 456))
    prop.signature = ps[2].sign(prop.sign_bytes(CHAIN))
    return {
        "proposal": msgs.ProposalMessage(prop),
        "block-part-0": msgs.BlockPartMessage(9, 2, parts.get_part(0)),
        "block-part-last": msgs.BlockPartMessage(9, 2, parts.get_part(parts.header.total - 1)),
        "prevote": msgs.VoteMessage(make_vote(pkg, ps, vs, 1, b.PREVOTE_TYPE, 7)),
        "prevote-nil": msgs.VoteMessage(make_vote(pkg, ps, vs, 2, b.PREVOTE_TYPE, 0)),
        "precommit-ext": msgs.VoteMessage(
            make_vote(pkg, ps, vs, 3, b.PRECOMMIT_TYPE, 7, ext=b"vote-ext")),
        "new-round-step": msgs.NewRoundStepMessage(9, 2, 4, 17, 1),
        "new-round-step-first": msgs.NewRoundStepMessage(1, 0, 1),
        "new-valid-block": msgs.NewValidBlockMessage(
            9, 2, parts.header, [True, False, True, True, False], True),
        "has-vote": msgs.HasVoteMessage(9, 2, b.PRECOMMIT_TYPE, 3),
        "has-vote-first": msgs.HasVoteMessage(9, 0, b.PREVOTE_TYPE, 0),
        "vote-set-maj23": msgs.VoteSetMaj23Message(9, 2, b.PREVOTE_TYPE, block_id(pkg, 7)),
        "vote-set-bits": msgs.VoteSetBitsMessage(
            9, 2, b.PRECOMMIT_TYPE, block_id(pkg, 7), [True] * 9 + [False] * 3),
        "vote-set-bits-nil": msgs.VoteSetBitsMessage(9, 2, b.PREVOTE_TYPE),
        "proposal-pol": msgs.ProposalPOLMessage(9, 1, [False, True, True]),
    }


WAL_KINDS = ("proposal", "block-part-0", "block-part-last", "prevote", "prevote-nil",
             "precommit-ext")


@pytest.mark.parametrize("name", [
    "proposal", "block-part-0", "block-part-last", "prevote", "prevote-nil",
    "precommit-ext", "new-round-step", "new-round-step-first", "new-valid-block",
    "has-vote", "has-vote-first", "vote-set-maj23", "vote-set-bits",
    "vote-set-bits-nil", "proposal-pol"])
def test_message_encodings_byte_equal(name):
    enc = {}
    for pkg in PKGS:
        msgs = mod(pkg, "consensus.messages")
        msg = _messages(pkg)[name]
        raw = msgs.encode_gossip_msg(msg)
        back = msgs.decode_gossip_msg(raw)
        assert msgs.encode_gossip_msg(back) == raw
        wal = None
        if name in WAL_KINDS:
            wal = msgs.encode_msg(msg)
            assert msgs.encode_msg(msgs.decode_msg(wal)) == wal
        enc[pkg] = (raw, wal)
    assert enc[J] == enc[P]
    # each package decodes the other's bytes to the same message
    for a, b in (PKGS, PKGS[::-1]):
        raw = enc[a][0]
        assert mod(b, "consensus.messages").encode_gossip_msg(
            mod(b, "consensus.messages").decode_gossip_msg(raw)) == raw


@pytest.mark.parametrize("ti", [(0.0, 1, 0, 1), (3.25, 9, 2, 6), (1e-3, 7, 0, 3),
                                (600.0, 2**40, 17, 8)])
def test_timeout_wal_encoding(ti):
    raws = [mod(pkg, "consensus.messages").encode_timeout_wal(*ti) for pkg in PKGS]
    assert raws[0] == raws[1]
    for pkg in PKGS:
        assert mod(pkg, "consensus.messages").decode_timeout_wal(raws[0]) == \
            mod(J, "consensus.messages").decode_timeout_wal(raws[0])


# -- consensus/ticker and sim/clock --------------------------------------------

TICKS = [(0.5, 1, 0, 1), (0.2, 1, 0, 3), (0.1, 1, 0, 2), (0.3, 2, 0, 1),
         (0.05, 1, 5, 1), (0.4, 2, 1, 4)]


def _sim_ticker_run(pkg, stop_after=None):
    clock_mod, ticker = mod(pkg, "sim.clock"), mod(pkg, "consensus.ticker")
    clock = clock_mod.VirtualClock()
    fired = []
    t = clock_mod.SimTicker(clock, lambda ti: fired.append((clock.now(), ti)), name="n0")
    t.start()
    labels = []
    for k, ti in enumerate(TICKS):
        clock.call_later(0.01 * k, lambda ti=ti: t.schedule_timeout(
            ticker.TimeoutInfo(*ti)), label="sched%d" % k)
    while True:
        timer = clock.tick()
        if timer is None:
            break
        labels.append((timer.when, timer.label))
        if stop_after is not None and len(labels) == stop_after:
            t.stop()
    return [(round(w, 9), (ti.duration, ti.height, ti.round_, ti.step)) for w, ti in fired], labels


@pytest.mark.parametrize("stop_after", [None, 3, 7])
def test_sim_ticker_schedule(stop_after):
    got = [_sim_ticker_run(pkg, stop_after) for pkg in PKGS]
    assert got[0] == got[1]


def _timeout_ticker_run(pkg):
    ticker = mod(pkg, "consensus.ticker")
    fired, done = [], threading.Event()

    def tock(ti):
        fired.append((ti.height, ti.round_, ti.step))
        if ti.height == 3:
            done.set()

    t = ticker.TimeoutTicker(tock)
    t.start()
    t.schedule_timeout(ticker.TimeoutInfo(0.2, 2, 0, 3))
    t.schedule_timeout(ticker.TimeoutInfo(0.01, 2, 0, 1))  # stale: dropped
    t.schedule_timeout(ticker.TimeoutInfo(0.05, 2, 1, 1))  # replaces (2,0,3)
    time.sleep(0.3)
    t.schedule_timeout(ticker.TimeoutInfo(0.02, 3, 0, 1))
    assert done.wait(5.0)
    t.schedule_timeout(ticker.TimeoutInfo(0.05, 4, 0, 1))
    t.stop()  # the pending (4, 0, 1) never fires
    time.sleep(0.15)
    return fired


def test_timeout_ticker_replaces_and_stops():
    got = [_timeout_ticker_run(pkg) for pkg in PKGS]
    assert got[0] == got[1] == [(2, 1, 1), (3, 0, 1)]


def test_timeout_info_order():
    for pkg in PKGS:
        ti = mod(pkg, "consensus.ticker").TimeoutInfo
        assert ti(9.0, 1, 0, 3) < ti(0.1, 1, 1, 1) < ti(0.1, 2, 0, 0)


# -- privval/file_pv ------------------------------------------------------------

def _pv_run(pkg, root, steps):
    b, vote, fpv = mod(pkg, "types.basic"), mod(pkg, "types.vote"), mod(pkg, "privval.file_pv")
    ps = privs(pkg, 4, seed=5)
    vs = valset(pkg, ps, [10] * 4)
    d = root / pkg
    d.mkdir()
    kp, sp = str(d / "pv_key.json"), str(d / "pv_state.json")
    pv = fpv.FilePV(ps[0], kp, sp)
    pv.save()
    log = []
    for kind, h, r, tag, ts in steps:
        if kind == "reload":
            pv = fpv.FilePV.load(kp, sp)
            log.append(("reload", open(kp, "rb").read(), open(sp, "rb").read()))
            continue
        if kind == "proposal":
            obj = vote.Proposal(height=h, round_=r, pol_round=-1, block_id=block_id(pkg, tag),
                                timestamp=b.Timestamp(1_700_000_000 + ts, 0))
            res = outcome(lambda: pv.sign_proposal(CHAIN, obj))
        else:
            type_ = b.PREVOTE_TYPE if kind == "prevote" else b.PRECOMMIT_TYPE
            obj = make_vote(pkg, ps, vs, 0, type_, tag, height=h, round_=r, sign=False)
            obj.timestamp = b.Timestamp(1_700_000_000 + ts, 0)
            if kind == "precommit-ext":
                obj.extension = b"ext"
            res = outcome(lambda: pv.sign_vote(CHAIN, obj, sign_extension=kind == "precommit-ext"))
        log.append((kind, res, obj.signature, getattr(obj, "extension_signature", b""),
                    open(sp, "rb").read()))
    return log, open(kp, "rb").read(), open(sp, "rb").read()


PV_SCRIPTS = {
    "votes-and-proposal": [("proposal", 1, 0, 7, 0), ("prevote", 1, 0, 7, 1),
                           ("precommit", 1, 0, 7, 2), ("prevote", 2, 0, 8, 3)],
    "double-sign-refused": [("prevote", 3, 0, 7, 0), ("prevote", 3, 0, 9, 0),
                            ("precommit", 3, 0, 9, 1)],
    "timestamp-only-resign": [("precommit", 4, 1, 7, 0), ("precommit", 4, 1, 7, 5),
                              ("precommit", 4, 1, 9, 5)],
    "regression-refused": [("precommit", 5, 2, 7, 0), ("prevote", 5, 2, 7, 1),
                           ("prevote", 5, 1, 7, 1), ("prevote", 4, 9, 7, 1)],
    "survives-restart": [("prevote", 6, 0, 7, 0), ("reload", 0, 0, 0, 0),
                         ("prevote", 6, 0, 9, 0), ("precommit", 6, 0, 7, 1),
                         ("reload", 0, 0, 0, 0), ("prevote", 6, 0, 7, 2)],
    "extension": [("precommit-ext", 7, 0, 7, 0), ("precommit-ext", 8, 0, 0, 0)],
}


@pytest.mark.parametrize("script", sorted(PV_SCRIPTS))
def test_file_pv_signs_refuses_and_persists(tmp_path, script):
    got = [_pv_run(pkg, tmp_path, PV_SCRIPTS[script]) for pkg in PKGS]
    assert got[0] == got[1]
    results = [e[1][0] for e in got[0][0] if e[0] != "reload"]
    if script in ("double-sign-refused", "regression-refused"):
        assert "raised" in results


def test_file_pv_torn_state_is_fatal(tmp_path):
    for pkg in PKGS:
        fpv = mod(pkg, "privval.file_pv")
        d = tmp_path / pkg
        d.mkdir()
        pv = fpv.FilePV(privs(pkg, 1)[0], str(d / "k.json"), str(d / "s.json"))
        pv.save()
        (d / "s.json").write_bytes(b'{"height": "3", "rou')
        with pytest.raises(fpv.PrivValStateError):
            fpv.FilePV.load(str(d / "k.json"), str(d / "s.json"))


# -- config/config ----------------------------------------------------------------

def test_consensus_and_mempool_defaults():
    for cls in ("ConsensusConfig", "MempoolConfig"):
        a, b = (getattr(mod(pkg, "config.config"), cls)() for pkg in PKGS)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    c = mod(P, "config.config").ConsensusConfig()
    assert (c.timeout_propose_ms, c.timeout_propose_delta_ms, c.timeout_vote_ms,
            c.timeout_vote_delta_ms, c.timeout_commit_ms) == (3000, 500, 1000, 500, 1000)
    assert [c.propose_timeout(r) for r in range(3)] == [3.0, 3.5, 4.0]
    assert c.vote_timeout(2) == 2.0 and c.commit_timeout() == 1.0
    m = mod(P, "config.config").MempoolConfig()
    assert (m.size, m.recheck, m.cache_size) == (5000, True, 10_000)


@pytest.mark.parametrize("which", ["default", "test"])
def test_toml_written_by_the_jax_package_loads(which):
    jc, pc = mod(J, "config.config"), mod(P, "config.config")
    cfg = jc.default_config() if which == "default" else jc.test_config("/x")
    text = jc.dumps(cfg)
    got = pc.loads(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(jc.loads(text))
    assert got.validate_basic() is None
    # the port writes the same TOML apart from its one comment line
    assert pc.dumps(got).splitlines()[1:] == text.splitlines()[1:]


@pytest.mark.parametrize("backend,ok", [("auto", True), ("cpu", True), ("gpu", True),
                                        ("tpu", True), ("cuda", False), ("", False)])
def test_crypto_backend_values(backend, ok, monkeypatch):
    c = mod(P, "config.config").CryptoConfig(backend=backend)
    assert (c.validate_basic() is None) == ok
    if ok:
        # the same values as the batch seam's environment variable
        monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", backend)
        assert mod(P, "crypto.batch").env_backend() in (None, "cpu", "gpu")


# -- consensus/wal -----------------------------------------------------------------

def _wal_records(pkg):
    msgs = _messages(pkg)
    cm = mod(pkg, "consensus.messages")
    seq = [("sync", cm.encode_msg(msgs["proposal"])),
           ("write", cm.encode_msg(msgs["block-part-0"])),
           ("write", cm.encode_msg(msgs["prevote"])),
           ("sync", cm.encode_timeout_wal(3.0, 9, 2, 3)),
           ("end", 9),
           ("write", cm.encode_msg(msgs["precommit-ext"])),
           ("sync", cm.encode_msg(msgs["prevote-nil"])),
           ("end", 10),
           ("write", cm.encode_msg(msgs["block-part-last"]))]
    return seq


def _wal_write(pkg, path, head_limit=None):
    walm = mod(pkg, "consensus.wal")
    kw = {} if head_limit is None else {"head_size_limit": head_limit}
    w = walm.WAL(str(path), **kw)
    for kind, x in _wal_records(pkg):
        if kind == "end":
            w.write_end_height(x)
        elif kind == "sync":
            w.write_sync(x)
        else:
            w.write(x)
    return w


def _wal_files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("head_limit", [None, 300])
def test_wal_files_byte_equal_and_replay(tmp_path, head_limit):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        w = _wal_write(pkg, d / "cs.wal", head_limit)
        replay = (w.replay_after_height(9), w.replay_after_height(10),
                  w.replay_after_height(3), w.search_for_end_height(10),
                  w.search_for_end_height(11), w.scan_end_heights(0),
                  [(r.kind, r.payload) for r in w.iter_records()])
        w.close()
        out[pkg] = (_wal_files(d), replay)
    assert out[J] == out[P]
    files = out[P][0]
    assert (len(files) > 1) == (head_limit is not None)
    assert out[P][1][3] and not out[P][1][4]


@pytest.mark.parametrize("tail", [b"\x00" * 8, b"\x12\x34", b"\x00\x00\x00\x07\x00\x00\x00\x30ab"])
def test_wal_torn_tail_repair(tmp_path, tail):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        w = _wal_write(pkg, d / "cs.wal")
        w.close()
        with open(d / "cs.wal", "ab") as f:
            f.write(tail)
        w2 = mod(pkg, "consensus.wal").WAL(str(d / "cs.wal"))
        w2.write_end_height(11)
        rep = dict(w2.last_repair)
        rep.pop("path")
        out[pkg] = (rep, w2.replay_after_height(10), _wal_files(d))
        w2.close()
    assert out[J] == out[P]
    assert out[P][0]["dropped_bytes"] == len(tail)


def test_wal_mid_stream_corruption_refused(tmp_path):
    try:
        for pkg in PKGS:
            walm = mod(pkg, "consensus.wal")
            d = tmp_path / pkg
            _wal_write(pkg, d / "cs.wal").close()
            raw = bytearray((d / "cs.wal").read_bytes())
            raw[20] ^= 0xFF  # inside the first frame; valid frames follow
            (d / "cs.wal").write_bytes(bytes(raw))
            with pytest.raises(walm.WALCorruptionError):
                walm.WAL(str(d / "cs.wal"))
            assert mod(pkg, "libs.storage_stats").snapshot()["totals"]["fatal"]
    finally:
        # the refusal records a fail-stop fatal in each package's
        # process-wide storage stats: a later test in this process (a
        # node's health route) must not see it
        for pkg in PKGS:
            mod(pkg, "libs.storage_stats").reset()


def test_wal_writes_through_the_cpp_library(tmp_path, monkeypatch):
    native, walm = mod(P, "native"), mod(P, "consensus.wal")
    w = walm.WAL(str(tmp_path / "a" / "cs.wal"))
    assert w._nlib is native.lib() and w._nh is not None
    assert not hasattr(walm, "_frame")  # no Python writer
    w.write_sync(b"x")
    assert w._head_size() == os.path.getsize(w.path) == 10
    w.close()

    def broken():
        raise OSError("host library failed to build")

    monkeypatch.setattr(native, "lib", broken)
    with pytest.raises(OSError, match="failed to build"):
        walm.WAL(str(tmp_path / "b" / "cs.wal"))


def test_wal_open_failure_raises(tmp_path):
    walm = mod(P, "consensus.wal")
    (tmp_path / "cs.wal").mkdir()  # a directory where the head file goes
    with pytest.raises(OSError, match="wal_open"):
        walm.WAL(str(tmp_path / "cs.wal"))


def test_wal_kill_keeps_synced_records(tmp_path):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        w = _wal_write(pkg, d / "cs.wal")
        w.kill()
        w2 = mod(pkg, "consensus.wal").WAL(str(d / "cs.wal"))
        out[pkg] = (w2.replay_after_height(9), _wal_files(d))
        w2.close()
    assert out[J] == out[P]


# -- mempool/clist_mempool ---------------------------------------------------------

class _RecheckApp:
    """The KVStore app's CheckTx, refusing txs that hold ``bad`` on
    recheck (a state change between the two checks)."""

    def __init__(self, pkg):
        self.at = mod(pkg, "abci.types")
        self.app = mod(pkg, "abci.kvstore").KVStoreApplication()
        self.calls = []

    def check_tx(self, req):
        self.calls.append((req.tx, req.type_))
        if req.type_ == self.at.CHECK_TX_TYPE_RECHECK and b"bad" in req.tx:
            return self.at.CheckTxResponse(code=3, log="stale")
        return self.app.check_tx(req)


MEMPOOL_TXS = [b"a=1", b"b=2", b"bad1=3", b"c=4", b"a=1", b"no-equals", b"d=" + b"5" * 40,
               b"bad2=6", b"e=7", b"f=8"]


def _mempool_run(pkg, recheck, cfg_kw):
    cm, cfgm, at = mod(pkg, "mempool.clist_mempool"), mod(pkg, "config.config"), mod(pkg, "abci.types")
    app = _RecheckApp(pkg)
    mp = cm.CListMempool(cfgm.MempoolConfig(recheck=recheck, **cfg_kw), app, height=3)
    log = []
    for i, tx in enumerate(MEMPOOL_TXS):
        r = outcome(lambda: mp.check_tx(tx, sender=f"peer{i % 3}"))
        log.append((r[0], r[1].code if r[0] == "ok" else r[1]))
    log.append((mp.size(), mp.size_bytes(), mp.is_empty(),
                mp.contains(mp.tx_key(b"a=1")), mp.get_tx_by_hash(mp.tx_key(b"c=4"))))
    log.append(mp.reap_max_bytes_max_gas(-1, -1))
    log.append(mp.reap_max_bytes_max_gas(40, -1))
    log.append(mp.reap_max_bytes_max_gas(-1, 2))
    log.append(mp.reap_max_txs(3))
    committed = [b"b=2", b"e=7", b"zz=9"]
    results = [at.ExecTxResult(), at.ExecTxResult(code=5), at.ExecTxResult()]
    mp.lock()
    mp.update(4, committed, results)
    mp.unlock()
    log.append((mp.size(), mp.size_bytes(), mp.reap_max_txs(-1)))
    log.append([outcome(lambda tx=tx: mp.check_tx(tx).code) for tx in (b"b=2", b"e=7", b"zz=9")])
    log.append(app.calls)
    mp.flush()
    log.append((mp.size(), mp.reap_max_txs(-1)))
    return log


@pytest.mark.parametrize("recheck", [True, False])
@pytest.mark.parametrize("cfg_kw", [{}, {"size": 4}, {"cache_size": 0},
                                    {"max_tx_bytes": 20},
                                    {"keep_invalid_txs_in_cache": True}],
                         ids=["defaults", "size-4", "no-cache", "max-tx-20", "keep-invalid"])
def test_clist_mempool_against_the_jax_mempool(recheck, cfg_kw):
    got = [_mempool_run(pkg, recheck, cfg_kw) for pkg in PKGS]
    assert got[0] == got[1]


def test_clist_mempool_lanes_and_nop():
    def run(pkg):
        cm, cfgm, at = mod(pkg, "mempool.clist_mempool"), mod(pkg, "config.config"), mod(pkg, "abci.types")

        class LaneApp:
            def check_tx(self, req):
                lane = "hi" if req.tx.startswith(b"h") else ""
                return at.CheckTxResponse(code=0, gas_wanted=2, lane_id=lane)

        mp = cm.CListMempool(cfgm.MempoolConfig(), LaneApp(), lane_priorities={"hi": 9, "lo": 1},
                             default_lane="lo")
        for tx in (b"l1=1", b"h1=1", b"l2=1", b"h2=1", b"h3=1", b"l3=1"):
            mp.check_tx(tx)
        nop = cm.NopMempool()
        return (mp.sorted_lanes, mp.reap_max_txs(-1), mp.reap_max_bytes_max_gas(-1, 7),
                outcome(lambda: nop.check_tx(b"x=1")), nop.reap_max_txs(5))
    got = [run(pkg) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[0][0] == ["hi", "lo"] and len(got[0][1]) == 6


# -- libs and txingest copies --------------------------------------------------------

def test_clist_and_service_and_ingest_stats():
    def run(pkg):
        clist, service, stats = mod(pkg, "libs.clist"), mod(pkg, "libs.service"), mod(pkg, "txingest.stats")
        cl = clist.CList()
        els = [cl.push_back(i) for i in range(5)]
        cl.remove(els[1])
        cl.remove(els[4])
        walk, e = [], cl.front()
        while e is not None:
            walk.append(e.value)
            e = e.next()

        class S(service.BaseService):
            def __init__(self):
                super().__init__("s")
                self.events = []

            def on_start(self):
                self.events.append("start")

            def on_stop(self):
                self.events.append("stop")

        s = S()
        s.start()
        run1 = s.is_running
        second = outcome(s.start)
        s.stop()
        stats.reset()
        stats.record_cache(True)
        stats.record_cache(False)
        stats.record_error("full")
        stats.record_reject(3)
        return walk, len(cl), run1, second, s.is_running, s.events, stats.snapshot()
    got = [run(pkg) for pkg in PKGS]
    assert got[0] == got[1]
