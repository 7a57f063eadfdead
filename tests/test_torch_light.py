"""Light-client header verification in the port (``light/verifier.py``,
``types/light.py``, ``Header``/``Commit.hash``, the validator-set updates
and hash) against the JAX package.

A small chain (6 validators, 6 headers, one set change at height 4: one
validator leaves, one joins, one changes power) is built with the JAX
types, as ``tests/test_verify_stream.py``'s ``_make_light_chain`` builds
its chain, and carried into the port's types by ``convert.py``.  Keys and
header contents come from a numpy seed.

* Types: every header, commit and validator-set hash, and every
  ``simple_encode``, byte-equal to the JAX package's; ``update_with_change_set``
  equal in validators, priorities, hash and errors.
* Verification: ``verify_adjacent``, ``verify_adjacent_chain``,
  ``verify_non_adjacent`` and ``verify`` raise the JAX package's error
  classes (and signature indices) on every case of the chip phase: a
  valid chain, a forged signature, a wrong ``validators_hash``, an
  expired trusted header, a target the trusted set cannot vouch for.  The
  sequential paths run on ``backend="cpu"``; the chain path (the port's
  in-flight ``verify_batches_overlapped``) runs on ``device="cpu"`` with
  the supervisor's device-runner seam answering from the oracle, and once
  on the plain PyTorch version itself.  The JAX package runs on its CPU
  backend (``COMETBFT_TPU_CRYPTO_BACKEND=cpu``), which keeps its tree
  hashes off its executable cache.
* Where the header checks hash: a caller that names the CPU gets no tree
  pass on the card even with the trust gate open, and an entry point with
  nothing named opens the gate (a stand-in self-check) before its first
  header's hashes, so they are the card's.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest

from cometbft_tpu.crypto.keys import Ed25519PrivKey
from cometbft_tpu.light import verifier as jlv
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.basic import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    PartSetHeader,
    Timestamp,
)
from cometbft_tpu.types.block import Commit, ConsensusVersion, Header
from cometbft_tpu.types.light import LightBlock, SignedHeader
from cometbft_tpu.types.validator import Validator, ValidatorSet
from cometbft_tpu.types.vote import CommitSig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.light import verifier as tlv
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import sha256_tree as ttree
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.types import validation as tval

CHAIN = "light-test-chain"
SEED = 20261017
T0 = 1_700_000_000
PERIOD = 10_000
NOW = T0 + 500.0
N_VALS = 6
HEADERS = 6
CHANGE_AT = 4  # the first height signed by the new set


@pytest.fixture(autouse=True)
def _cpu_backends(monkeypatch):
    """The JAX package on its CPU backend; the port's cache, counters and
    breakers fresh for each test."""
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()
    yield
    tsup.clear_device_runner()
    for reset in (tsc.reset_cache, tds.reset, tbh.reset):
        reset()


def _copy_commit(c, sigs=None):
    return Commit(c.height, c.round_, c.block_id,
                  [dataclasses.replace(s) for s in (sigs or c.signatures)])


def _light_block(privs, vals, nxt, h, last_bid):
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = vals.copy_increment_proposer_priority(h)
    header = Header(
        version=ConsensusVersion(11, 1),
        chain_id=CHAIN,
        height=h,
        time=Timestamp(T0 + h, 0),
        last_block_id=last_bid,
        data_hash=hash_from_byte_slices([b"tx-%d" % h]),
        validators_hash=vals.hash(),
        next_validators_hash=nxt.hash(),
        app_hash=bytes([h]) * 32,
        proposer_address=vals.get_proposer().address,
    )
    bid = BlockID(header.hash(), PartSetHeader(1, bytes([h ^ 0x5A]) * 32))
    commit = Commit(h, 0, bid, [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp(T0 + h, 1 + i), b"")
        for i, v in enumerate(vals.validators)])
    for i, (v, cs) in enumerate(zip(vals.validators, commit.signatures)):
        cs.signature = by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN, i))
    return LightBlock(SignedHeader(header, commit), vals), bid


@pytest.fixture(scope="module")
def chain():
    """(privs, [JAX light blocks at heights 1..HEADERS], set before, set
    after the change)."""
    rng = np.random.default_rng(SEED)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(N_VALS + 1)]
    before = ValidatorSet([Validator(p.pub_key(), 10) for p in privs[:N_VALS]])
    after = before.copy()
    after.update_with_change_set([
        Validator(privs[0].pub_key(), 0),  # leaves
        Validator(privs[N_VALS].pub_key(), 10),  # joins
        Validator(privs[1].pub_key(), 20),  # changes power
    ])
    lbs, bid = [], BlockID()
    for h in range(1, HEADERS + 1):
        vals = before if h < CHANGE_AT else after
        nxt = before if h + 1 < CHANGE_AT else after
        lb, bid = _light_block(privs, vals, nxt, h, bid)
        lbs.append(lb)
    return privs, lbs, before, after


# -- the bad cases, built on the JAX side ----------------------------------------


def _forged_index(lb, trusted_vals):
    """The first commit index whose validator the trusted set knows too, so
    both the light and the trusting checks reach it."""
    return next(i for i, v in enumerate(lb.validator_set.validators)
                if trusted_vals.has_address(v.address))


def _forged(lb, trusted_vals):
    i = _forged_index(lb, trusted_vals)
    commit = _copy_commit(lb.signed_header.commit)
    sig = commit.signatures[i].signature
    commit.signatures[i].signature = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    return LightBlock(SignedHeader(lb.signed_header.header, commit), lb.validator_set)


def _bad_validators_hash(lb):
    """A header naming another validator set; its commit's block id follows
    the header, so ``validate_basic`` reaches the validator-set check."""
    header = dataclasses.replace(lb.signed_header.header, validators_hash=b"\x11" * 32)
    old = lb.signed_header.commit
    commit = Commit(old.height, old.round_,
                    BlockID(header.hash(), old.block_id.part_set_header),
                    old.signatures)
    return LightBlock(SignedHeader(header, commit), lb.validator_set)


def _untrusted(lb, trusted_vals):
    """Only two of the target's signers are in the trusted set: 20 of its
    60, not more than a third."""
    keep = [i for i, v in enumerate(lb.validator_set.validators)
            if trusted_vals.has_address(v.address)][:2]
    sigs = [cs if i in keep else CommitSig()
            for i, cs in enumerate(lb.signed_header.commit.signatures)]
    commit = _copy_commit(lb.signed_header.commit, sigs)
    return LightBlock(SignedHeader(lb.signed_header.header, commit), lb.validator_set)


def _cases(lbs):
    """name -> (calls, expected JAX error class or None).  A call is
    (entry point, trusted, new or news, now)."""
    trusted, news, last = lbs[0], lbs[1:], lbs[-1]
    tv = trusted.validator_set
    forged = _forged(lbs[4], tv)
    bad = _bad_validators_hash(lbs[2])
    late = T0 + 1 + PERIOD + 1.0
    return {
        "valid": ([("chain", trusted, news, NOW), ("adjacent", trusted, news, NOW),
                   ("non_adjacent", trusted, last, NOW), ("verify", trusted, lbs[1], NOW),
                   ("verify", trusted, last, NOW)], None),
        "forged": ([("chain", trusted, news[:3] + [forged] + news[4:], NOW),
                    ("adjacent", trusted, news[:3] + [forged], NOW),
                    ("non_adjacent", trusted, forged, NOW)], "InvalidSignatureError"),
        "bad_validators_hash": ([("chain", trusted, news[:1] + [bad] + news[2:], NOW),
                                 ("adjacent", trusted, news[:1] + [bad], NOW),
                                 ("non_adjacent", trusted, bad, NOW),
                                 ("verify", trusted, bad, NOW)], "ErrInvalidHeader"),
        "expired": ([("chain", trusted, news, late), ("adjacent", trusted, news, late),
                     ("non_adjacent", trusted, last, late),
                     ("verify", trusted, lbs[1], late)], "ErrOldHeaderExpired"),
        "untrusted": ([("non_adjacent", trusted, _untrusted(last, tv), NOW),
                       ("verify", trusted, _untrusted(last, tv), NOW)],
                      "ErrNewValSetCantBeTrusted"),
    }


def _call(lv, kind, trusted, new, now, **kw):
    if kind == "chain":
        return lv.verify_adjacent_chain(CHAIN, trusted, new, PERIOD, now, **kw)
    if kind == "adjacent":
        current = trusted
        for lb in new:
            lv.verify_adjacent(CHAIN, current, lb, PERIOD, now, **kw)
            current = lb
        return None
    if kind == "non_adjacent":
        return lv.verify_non_adjacent(CHAIN, trusted, new, PERIOD, now, **kw)
    return lv.verify(CHAIN, trusted, new, PERIOD, now, **kw)


def _outcome(fn):
    try:
        fn()
    except (jlv.LightClientError, jval.CommitVerificationError,
            tlv.LightClientError, tval.CommitVerificationError) as e:
        return type(e).__name__, getattr(e, "index", None)
    return None


def _port(obj):
    return (convert.light_block_from(obj) if isinstance(obj, LightBlock)
            else [convert.light_block_from(x) for x in obj])


def _oracle_runner(backend, pubs, msgs, sigs, lanes):
    out = np.zeros(lanes, dtype=bool)
    out[: len(pubs)] = [len(p) == 32 and len(s) == 64 and ref.verify_zip215(p, m, s)
                        for p, m, s in zip(pubs, msgs, sigs)]
    return out


# -- types -------------------------------------------------------------------------


def test_hashes_and_encodings_equal_jax(chain):
    _, lbs, before, after = chain
    for lb in lbs:
        tb = convert.light_block_from(lb)
        h, th = lb.signed_header.header, tb.signed_header.header
        assert th.hash() == h.hash() and len(h.hash()) == 32
        assert th.validate_basic() == h.validate_basic() is None
        assert tb.signed_header.commit.hash() == lb.signed_header.commit.hash()
        assert tb.validator_set.hash() == lb.validator_set.hash()
        assert [v.simple_encode() for v in tb.validator_set.validators] == [
            v.simple_encode() for v in lb.validator_set.validators]
        assert tb.validate_basic(CHAIN) == lb.validate_basic(CHAIN) is None
        assert tb.hash() == lb.hash() and tb.height == lb.height
    assert before.hash() != after.hash()


def test_validator_set_hash_at_the_plane_width_equals_jax():
    """40 validators reach the tree plane: the JAX package hashes them on
    its host path (CPU backend), the port on the host (gate closed) and on
    its plain tree version, all equal."""
    rng = np.random.default_rng(SEED + 1)
    jvals = ValidatorSet([Validator(Ed25519PrivKey.from_seed(rng.bytes(32)).pub_key(),
                                    1 + i) for i in range(40)])
    tvals = convert.validator_set_from(jvals)
    assert tvals.hash() == jvals.hash()
    leaves = [v.simple_encode() for v in tvals.validators]
    assert ttree.tree_root(leaves, device="cpu") == jvals.hash()
    assert tds.tier_counts("merkle")["host"] == (1, 40)
    assert tds.tier_counts("merkle")["torch"] == (1, 40)


def _state(vals):
    return ([(v.address, v.voting_power, v.proposer_priority) for v in vals.validators],
            vals.total_voting_power(), vals.hash())


def test_update_with_change_set_equals_jax(chain):
    privs, lbs, before, _ = chain
    extra = [Ed25519PrivKey.from_seed(bytes([i]) * 32).pub_key() for i in (1, 2)]
    changes = [
        [Validator(privs[2].pub_key(), 0), Validator(extra[0], 7)],
        [Validator(privs[3].pub_key(), 35)],
        [Validator(extra[1], 1000), Validator(privs[4].pub_key(), 0),
         Validator(privs[5].pub_key(), 1)],
        [],
    ]
    jv = before.copy()
    tv = convert.validator_set_from(before)
    for change in changes:
        jv.update_with_change_set(change)
        tv.update_with_change_set([_tval(c) for c in change])
        assert _state(tv) == _state(jv)
        jv = jv.copy_increment_proposer_priority(3)
        tv = tv.copy_increment_proposer_priority(3)
        assert _state(tv) == _state(jv)
        assert tv.get_proposer().address == jv.get_proposer().address
    assert tv.has_address(extra[1].address()) and not tv.has_address(b"\x00" * 20)


def _tval(c):
    from cometbft_tpu_torch.crypto.keys import pub_key_from_type
    from cometbft_tpu_torch.types.validator import Validator as TValidator

    return TValidator(pub_key_from_type(c.pub_key.type_, c.pub_key.bytes()),
                      c.voting_power)


@pytest.mark.parametrize("case", ["duplicate", "negative", "absent", "empty"])
def test_update_with_change_set_errors_equal_jax(chain, case):
    privs, _, before, _ = chain
    stranger = Ed25519PrivKey.from_seed(b"\x77" * 32).pub_key()
    change = {
        "duplicate": [Validator(privs[1].pub_key(), 3), Validator(privs[1].pub_key(), 4)],
        "negative": [Validator(privs[1].pub_key(), -1)],
        "absent": [Validator(stranger, 0)],
        "empty": [Validator(p.pub_key(), 0) for p in privs[:N_VALS]],
    }[case]

    def run(vals, ch):
        try:
            vals.update_with_change_set(ch)
        except (ValueError, OverflowError) as e:
            return type(e).__name__, str(e)
        return None

    want = run(before.copy(), change)
    assert want is not None
    assert run(convert.validator_set_from(before), [_tval(c) for c in change]) == want


# -- verification ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["valid", "forged", "bad_validators_hash",
                                  "expired", "untrusted"])
def test_errors_equal_jax_on_every_path(chain, case):
    _, lbs, _, _ = chain
    calls, want_class = _cases(lbs)[case]
    tsup.set_device_runner(_oracle_runner)
    for kind, trusted, new, now in calls:
        want = _outcome(lambda: _call(jlv, kind, trusted, new, now))
        kw = {"device": "cpu"} if kind == "chain" else {"backend": "cpu"}
        tsc.reset_cache()
        got = _outcome(lambda: _call(tlv, kind, _port(trusted), _port(new), now, **kw))
        assert got == want, (case, kind)
        assert (want and want[0]) == want_class, (case, kind)


def test_chain_path_judges_in_order_at_the_forged_header(chain):
    """The chain path (in flight, on the runner seam) raises at the forged
    header: the run before it passes, the run through it raises the JAX
    package's error, and the good headers' verdicts stay cached."""
    _, lbs, _, _ = chain
    tsup.set_device_runner(_oracle_runner)
    trusted = _port(lbs[0])
    news = _port(lbs[1:4]) + [_port(_forged(lbs[4], lbs[0].validator_set))]
    want = _outcome(lambda: _call(jlv, "adjacent", lbs[0],
                                  lbs[1:4] + [_forged(lbs[4], lbs[0].validator_set)], NOW))
    assert _outcome(lambda: _call(tlv, "chain", trusted, news, NOW, device="cpu")) == want
    assert want[0] == "InvalidSignatureError"
    served = tds.tier_counts()["torch"]
    assert served[0] == len(news)  # one overlapped batch per header
    _call(tlv, "chain", trusted, news[:3], NOW, device="cpu")
    assert tds.tier_counts()["torch"] == served  # written back before judging


def test_chain_on_the_plain_version(chain):
    """Two headers through ``verify_batches_overlapped`` on the plain
    PyTorch version (two CPU verifies), then warm: no verify at all."""
    _, lbs, _, _ = chain
    trusted, news = _port(lbs[0]), _port(lbs[1:3])
    tlv.verify_adjacent_chain(CHAIN, trusted, news, PERIOD, NOW, device="cpu")
    batches, sigs = tds.tier_counts()["torch"]
    needed = 2 * N_VALS // 3 + 1  # light: stop past 2/3 of equal powers
    assert batches == 2 and sigs == 2 * needed
    tlv.verify_adjacent_chain(CHAIN, trusted, news, PERIOD, NOW, device="cpu")
    assert tds.tier_counts()["torch"] == (batches, sigs)


@pytest.fixture
def tree_plane_on(monkeypatch):
    """The port's own routing (the variable unset), with the six-validator
    sets and the 14-field headers wide enough for the tree plane."""
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    monkeypatch.setenv("COMETBFT_TPU_MERKLE_MIN_BATCH", "4")


@pytest.mark.parametrize("kw", [{"device": "cpu"}, {"backend": "cpu"}])
def test_a_caller_naming_the_cpu_hashes_on_the_cpu(chain, monkeypatch, tree_plane_on, kw):
    """The trust gate open (a card passed its self-check), a sync that
    names the CPU hashes its headers and validator sets on the CPU."""
    _, lbs, _, _ = chain
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda:0"})
    assert ttree.device_active()
    tsup.set_device_runner(_oracle_runner)
    _call(tlv, "chain", _port(lbs[0]), _port(lbs[1:3]), NOW, **kw)
    tree = tds.tier_counts("merkle")
    assert tree["cuda"] == (0, 0) and tree["host"] == (0, 0)
    assert tree["torch"][0] == 2 * 2  # each header's hash and its set's


def test_a_fresh_process_hashes_its_first_header_on_the_card(chain, monkeypatch,
                                                            tree_plane_on):
    """No self-check has run yet: the entry point runs it (a stand-in that
    trusts a stand-in card) before the header checks, so the first
    header's hashes are the card's, not the host's."""
    _, lbs, _, _ = chain
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    monkeypatch.setattr(tbatch, "default_backend",
                        lambda: tbatch._SELF_CHECKED.add("cuda:0") or "gpu")
    monkeypatch.setattr(ttree, "device_root",
                        lambda items, device=None: hash_from_byte_slices(items))
    monkeypatch.setattr(tlv, "_verify_own_commit", lambda *a: None)
    assert not ttree.device_active()
    tlv.verify_adjacent(CHAIN, _port(lbs[0]), _port(lbs[1]), PERIOD, NOW)
    tree = tds.tier_counts("merkle")
    assert tree["cuda"][0] == 2 and tree["host"] == tree["torch"] == (0, 0)


def test_trust_options_and_expiry():
    opts = tlv.TrustOptions(PERIOD, 1, b"\x00" * 32)
    opts.validate()
    for bad in (tlv.TrustOptions(0, 1, b"\x00" * 32), tlv.TrustOptions(1, 0, b"\x00" * 32),
                tlv.TrustOptions(1, 1, b"\x00")):
        with pytest.raises(tlv.LightClientError):
            bad.validate()
    from cometbft_tpu_torch.types.basic import Timestamp as TTimestamp

    for now in (T0 + PERIOD - 1.0, T0 + PERIOD, T0 + PERIOD + 1.0):
        assert tlv.header_expired(TTimestamp(T0, 0), PERIOD, now) == jlv.header_expired(
            Timestamp(T0, 0), PERIOD, now)
    assert tlv.DEFAULT_TRUST_LEVEL == jlv.DEFAULT_TRUST_LEVEL == Fraction(1, 3)
