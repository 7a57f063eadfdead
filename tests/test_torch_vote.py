"""The port's ``Vote`` (``cometbft_tpu_torch/types/vote.py``) against the
JAX package's: sign bytes byte for byte, ``validate_basic`` messages,
``Vote.verify`` verdicts (with the port's verify scheduler off, and on
over its supervisor's host-backed runner seam), and the gossip rule: a
commit built from votes verified at gossip time needs no verify.
"""

import hashlib
import types

import numpy as np
import pytest

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.basic import (
    BLOCK_ID_FLAG_COMMIT,
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
    PartSetHeader,
    Timestamp,
)
from cometbft_tpu.types.block import Commit
from cometbft_tpu.types.validator import Validator, ValidatorSet
from cometbft_tpu.types.vote import CommitSig, Vote
from cometbft_tpu_torch import convert
from cometbft_tpu_torch import verifysched as tvs
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.verifysched import service as tservice

CHAIN = "torch-vote-chain"
HEIGHT = 9
N = 8
TAMPERED = (2, 5)


def _block_id(tag=b"blk"):
    return BlockID(
        hashlib.sha256(tag).digest(),
        PartSetHeader(2, hashlib.sha256(tag + b"-parts").digest()),
    )


@pytest.fixture(scope="module")
def gossip():
    """N validators and their signed precommits (two tampered), built with
    the JAX package's types and keys."""
    rng = np.random.default_rng(909)
    privs = [jkeys.Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(N)]
    vals = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    votes = []
    for i, v in enumerate(vals.validators):
        vote = Vote(PRECOMMIT_TYPE, HEIGHT, 0, _block_id(),
                    Timestamp(1_700_000_000 + i, 7 * i), v.address, i)
        vote.signature = by_addr[v.address].sign(vote.sign_bytes(CHAIN))
        if i in TAMPERED:
            s = vote.signature
            vote.signature = s[:32] + bytes([s[32] ^ 1]) + s[33:]
        votes.append(vote)
    return types.SimpleNamespace(
        vals=vals, votes=votes, tvals=convert.validator_set_from(vals),
        tvotes=[convert.vote_from(v) for v in votes])


VARIANTS = {
    "precommit": {},
    "prevote": dict(type_=PREVOTE_TYPE),
    "nil": dict(block_id=BlockID()),
    "zero_time": dict(timestamp=Timestamp(0, 0)),
    "late_round": dict(round_=3, height=2**40),
    "other_chain": {},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_sign_bytes_match_jax(gossip, name):
    v = Vote(**{**gossip.votes[1].__dict__, **VARIANTS[name]})
    chain = "another-chain" if name == "other_chain" else CHAIN
    assert convert.vote_from(v).sign_bytes(chain) == v.sign_bytes(chain)
    assert convert.vote_from(v).is_nil() == v.is_nil()


BROKEN = {
    "ok": {},
    "type": dict(type_=32),
    "height": dict(height=-1),
    "round": dict(round_=-1),
    "address": dict(validator_address=b"\x01" * 19),
    "index": dict(validator_index=-1),
    "no_signature": dict(signature=b""),
    "big_signature": dict(signature=b"\x01" * 97),
    "prevote_extension": dict(type_=PREVOTE_TYPE, extension=b"x"),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_validate_basic_matches_jax(gossip, name):
    v = Vote(**{**gossip.votes[0].__dict__, **BROKEN[name]})
    got = convert.vote_from(v).validate_basic()
    assert got == v.validate_basic()
    assert (got is None) == (name == "ok")


@pytest.fixture
def port_scheduler(monkeypatch):
    """The port's scheduler active on the CPU over a host-backed device
    runner, which logs every flush it verifies."""
    log = []

    def runner(backend, pubs, msgs, sigs, lanes):
        log.append(len(pubs))
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [ref.verify_zip215(*t) for t in zip(pubs, msgs, sigs)]
        return out

    monkeypatch.setattr(tservice, "backend_trusted", lambda: True)
    real = tservice.VerifyScheduler
    monkeypatch.setattr(tservice, "VerifyScheduler",
                        lambda **kw: real(**{"device": "cpu", **kw}))
    for reset in (tvs.reset_scheduler, tsc.reset_cache, tvs.stats.reset, tbh.reset):
        reset()
    tsup.set_device_runner(runner)
    yield log
    tvs.reset_scheduler()
    tsup.clear_device_runner()
    tsc.reset_cache()
    tvs.stats.reset()


@pytest.mark.parametrize("scheduled", [False, True])
def test_verify_matches_jax(gossip, monkeypatch, request, scheduled):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")  # JAX: host path
    log = request.getfixturevalue("port_scheduler") if scheduled else None
    tsc.reset_cache()
    want = [v.verify(CHAIN, gossip.vals.validators[v.validator_index].pub_key)
            for v in gossip.votes]
    got = [v.verify(CHAIN, gossip.tvals.validators[v.validator_index].pub_key)
           for v in gossip.tvotes]
    assert got == want == [i not in TAMPERED for i in range(N)]
    snap = tvs.stats.snapshot()
    if scheduled:
        assert snap["submitted"]["consensus"] == N and sum(log) == N
    else:
        assert snap["verdicts_total"] == 0
    tsc.reset_cache()


def test_commit_of_gossiped_votes_needs_no_verify(gossip, port_scheduler):
    """Votes verified at gossip time (through the scheduler) make the
    commit built from them free: every triple is a cache hit through
    byte-identical sign bytes, and nothing reaches the device tier."""
    good = [(v, tv) for i, (v, tv) in enumerate(zip(gossip.votes, gossip.tvotes))
            if i not in TAMPERED]
    for _, tv in good:
        assert tv.verify(CHAIN, gossip.tvals.validators[tv.validator_index].pub_key)
    flushed = list(port_scheduler)
    sigs = [CommitSig() for _ in range(N)]
    for v, _ in good:
        sigs[v.validator_index] = CommitSig(BLOCK_ID_FLAG_COMMIT, v.validator_address,
                                            v.timestamp, v.signature)
    commit = Commit(HEIGHT, 0, _block_id(), sigs)
    jval.verify_commit(CHAIN, gossip.vals, _block_id(), HEIGHT, commit)
    hits = tsc.get_cache().stats()["hits"]
    calls = tds.snapshot()["verify_calls"]
    tval.verify_commit(CHAIN, gossip.tvals, convert.block_id_from(_block_id()),
                       HEIGHT, convert.commit_from(commit), backend="gpu")
    assert port_scheduler == flushed  # no new flush: nothing verified again
    assert tsc.get_cache().stats()["hits"] - hits == len(good)
    assert tvs.stats.snapshot()["submitted"]["consensus"] == len(good)
    assert tds.snapshot()["verify_calls"] == calls + 1  # its latency recorded

