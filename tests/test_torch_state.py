"""A node's apply path in the port against the JAX package's:
``state/execution.BlockExecutor`` over the stores, the KVStore app through
``LocalClient``, the evidence pool and the event bus.

* Apply path: the same 4-validator chain of 4 heights
  (``tests/torch_chain.drive``: a validator update at height 2, a
  duplicate-vote evidence at height 3, one absent signer in every commit)
  through both packages; at every height the ``State`` (its JSON, byte
  for byte), the app hash, the results hash, both validator-set hashes
  and the published events (tags and kinds) are equal.  The port runs on
  ``device="cpu"`` (its LastCommits through the kernel's plain version),
  the JAX package on its CPU backend (``COMETBFT_TPU_CRYPTO_BACKEND=cpu``,
  no jit).
* Rejections: every rule of ``validate_block`` (JAX
  ``state/execution.py:241-333``) gives the same error class and message
  in both, on the same block and state, and leaves the stores as they
  were.
* Evidence verdicts: a valid duplicate vote, a wrong power, a bad
  signature, expired evidence, an unknown validator, a timestamp
  mismatch, evidence already committed, a valid lunatic
  ``LightClientAttackEvidence`` and one naming the wrong byzantine
  validators: both packages' pools give the same verdict.
* The device rule: with no device and no card a ``BlockExecutor`` or an
  ``EvidencePool`` raises; on a stand-in card (CUDA reported available,
  the device tier on the runner seam) the duplicate vote's pair rides one
  flush of the verify scheduler at ``PRIO_EVIDENCE``, and a flush the
  kernel did not serve reaches ``validate_block``'s caller as
  ``BackendError``, not as a verdict on the block.

All tolerances are exact.  Outside the apply-path test the port's
signature batches run on the supervisor's device-runner seam answering
from the pure-Python oracle, so no other plain verify runs.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import torch_chain as tc
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.crypto.backend_health import BackendError
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch import verifysched as tvs
from cometbft_tpu_torch.verifysched import service as tservice
from cometbft_tpu_torch.verifysched import stats as tvstats

PKGS = ("cometbft_tpu", "cometbft_tpu_torch")
CPU = {"executor_kw": {"device": "cpu"}, "pool_kw": {"device": "cpu"}}


def _kw(pkg):
    return CPU if pkg.endswith("_torch") else {}


def _oracle_runner(log=None, fail_width=None):
    def run(backend, pubs, msgs, sigs, lanes):
        if log is not None:
            log.append(len(pubs))
        if fail_width is not None and len(pubs) == fail_width:
            raise RuntimeError("injected: the kernel did not serve this flush")
        out = np.zeros(lanes, dtype=bool)
        out[: len(pubs)] = [len(p) == 32 and len(s) == 64 and ref.verify_zip215(p, m, s)
                            for p, m, s in zip(pubs, msgs, sigs)]
        return out
    return run


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    for reset in (tsc.reset_cache, tds.reset, tbh.reset, tvstats.reset):
        reset()
    yield
    tsup.clear_device_runner()
    tvs.reset_scheduler()
    tsc.reset_cache()


@pytest.fixture
def own_tiers(monkeypatch):
    """The Ed25519 batches served on the test's own thread, by tier:
    {tier: [batches, signatures]}.  The per-tier counter is process-wide,
    and a thread an earlier test of the same worker left running can
    record a batch into it while this test runs: ``Node.stop`` does not
    join a node's threads, and a port follower's ``blocksync-pool``
    thread (``test_torch_node.py``'s cross-package follow) was seen
    finishing a plain verify of a one-validator window in a later test.
    The batches this test's calls serve are recorded on its thread (the
    supervisor records the tier on the caller's thread)."""
    me = threading.get_ident()
    own: dict = {}
    record = tds.record_tier

    def counted(tier, n, key_type="ed25519"):
        if key_type == "ed25519" and threading.get_ident() == me:
            got = own.setdefault(tier, [0, 0])
            got[0] += 1
            got[1] += n
        record(tier, n, key_type)

    monkeypatch.setattr(tds, "record_tier", counted)
    return own


# -- the apply path ----------------------------------------------------------


def test_apply_path_equals_jax_at_every_height(own_tiers):
    """The port's LastCommits through the plain version on the CPU (3
    batches), every other step as in the JAX package."""
    runs = [tc.drive(pkg, **_kw(pkg)) for pkg in PKGS]
    (jc, jrec), (tcn, trec) = runs
    assert len(trec) == 4
    for h, (want, got) in enumerate(zip(jrec, trec), start=1):
        assert got[:5] == want[:5], h
        assert [e for e in got[5]] == [e for e in want[5]], h
        assert len(got[5]) > 3
    assert own_tiers == {"torch": [3, 9]}
    kinds = [k for _, k in trec[0][5]] + [k for r in trec[1:] for _, k in r[5]]
    assert kinds.count("EventDataNewBlock") == 4
    assert kinds.count("EventDataValidatorSetUpdates") == 1
    vals = tcn.state.validators
    assert sorted(v.voting_power for v in vals.validators) == [10, 10, 10, 20]
    assert tcn.app.app_hash == jc.app.app_hash == tcn.state.app_hash
    assert tcn.pool.occupancy() == (0, 0)


# -- rejections --------------------------------------------------------------


def _refill(b):
    b.header.last_commit_hash = b.header.data_hash = b""
    b.fill_header_hashes()


def _mut(c, b, st, rule):
    """Break ``rule`` of validate_block in block ``b`` (or state ``st``),
    in package ``c.m``; returns the state to validate against."""
    m, h = c.m, b.header
    if rule == "data_hash":
        b.data.txs.append(b"x=1")
    elif rule == "block_protocol":
        h.version = m.block.ConsensusVersion(10, h.version.app)
    elif rule == "app_version":
        h.version = m.block.ConsensusVersion(h.version.block, 7)
    elif rule == "chain_id":
        h.chain_id = "another-chain"
    elif rule == "height":
        h.height += 1
    elif rule == "last_block_id":
        h.last_block_id = m.basic.BlockID()
    elif rule in ("app_hash", "last_results_hash", "validators_hash",
                  "next_validators_hash", "consensus_hash"):
        setattr(h, rule, bytes(32))
    elif rule == "commit_size":
        b.last_commit.signatures.pop()
        _refill(b)
    elif rule == "commit_block_id":
        b.last_commit.block_id = m.basic.BlockID(bytes(32), b.last_commit.block_id.part_set_header)
        _refill(b)
    elif rule == "bad_signature":
        cs = b.last_commit.signatures[0]
        cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
        _refill(b)
    elif rule == "not_enough_power":
        for i in (0, 1):
            b.last_commit.signatures[i] = m.vote.CommitSig.absent_sig()
        _refill(b)
    elif rule == "proposer":
        h.proposer_address = bytes(20)
    elif rule == "evidence_bytes":
        params = st.consensus_params.update(evidence=dataclasses.replace(
            st.consensus_params.evidence, max_bytes=100))
        st = dataclasses.replace(st, consensus_params=params)
        h.consensus_hash = params.hash()
    elif rule == "evidence_invalid":
        b.evidence[0].validator_power += 1
        h.evidence_hash = m.evidence.evidence_list_hash(b.evidence)
    return st


RULES = ["data_hash", "block_protocol", "app_version", "chain_id", "height",
         "last_block_id", "app_hash", "last_results_hash", "validators_hash",
         "next_validators_hash", "consensus_hash", "commit_size",
         "commit_block_id", "bad_signature", "not_enough_power", "proposer",
         "evidence_bytes", "evidence_invalid", "initial_last_commit"]


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class and message are compared
        return type(e).__name__, str(e)
    return None


def _rejection(pkg, rule):
    c, _ = tc.drive(pkg, heights=2, **_kw(pkg))
    if rule == "initial_last_commit":
        c0 = tc.Chain(pkg, **_kw(pkg))
        b = c0.make_block(1, tc.txs_at(1, 3, c0.seed))
        b.last_commit = c.last_commit
        _refill(b)
        return _outcome(lambda: c0.executor.validate_block(c0.state, b)), None
    ev = tc.duplicate_vote(c.m, c.privs, c.state_store, c.block_store, 2, 0)
    b = c.make_block(3, tc.txs_at(3, 5, c.seed), [ev])
    st = _mut(c, b, c.state, rule)
    before = list(c.db.iterate())
    got = _outcome(lambda: c.executor.apply_block(st, c.m.basic.BlockID(), b))
    return got, list(c.db.iterate()) == before


@pytest.mark.parametrize("rule", RULES)
def test_validate_block_rejections_equal_jax(rule):
    tsup.set_device_runner(_oracle_runner())
    want, _ = _rejection("cometbft_tpu", rule)
    got, unchanged = _rejection("cometbft_tpu_torch", rule)
    assert got == want and got is not None
    assert unchanged in (None, True)
    if rule not in ("bad_signature", "commit_block_id", "not_enough_power"):
        assert got[0] == "InvalidBlockError"


# -- evidence verdicts -------------------------------------------------------


def _lunatic(c, byzantine_ok=True):
    """A conflicting header at height 2 (another app hash: a lunatic
    attack) signed by every validator of the common set at height 1."""
    m = c.m
    vals = c.state_store.load_validators(1)
    trusted = c.block_store.load_block_meta(2).header
    hdr = dataclasses.replace(trusted, app_hash=bytes(range(32)))
    bid = m.basic.BlockID(hdr.hash(), m.basic.PartSetHeader(1, bytes(32)))
    commit = tc.sign_commit(m, c.by_addr, vals, 2, bid)
    lb = m.light.LightBlock(m.light.SignedHeader(hdr, commit), vals)
    byz = list(vals.validators) if byzantine_ok else list(vals.validators[:1])
    return m.evidence.LightClientAttackEvidence(
        conflicting_block=lb, common_height=1, byzantine_validators=byz,
        total_voting_power=vals.total_voting_power(),
        timestamp=c.block_store.load_block_meta(1).header.time)


EVIDENCE_CASES = ["valid", "wrong_power", "bad_signature", "expired",
                  "unknown_validator", "timestamp_mismatch", "committed",
                  "lunatic", "lunatic_wrong_byzantine"]


def _verdict(pkg, case):
    c, _ = tc.drive(pkg, heights=3, **_kw(pkg))
    m, st = c.m, c.state
    if case == "committed":
        ev = c.block_store.load_block(3).evidence[0]
    elif case.startswith("lunatic"):
        ev = _lunatic(c, case == "lunatic")
    else:  # at height 1 when it is to expire: 2 blocks before the state
        ev = tc.duplicate_vote(m, c.privs, c.state_store, c.block_store,
                               1 if case == "expired" else 2, 0)
    if case == "wrong_power":
        ev.validator_power += 1
    elif case == "bad_signature":
        s = ev.vote_b.signature
        ev.vote_b.signature = s[:10] + bytes([s[10] ^ 4]) + s[11:]
    elif case == "expired":
        st = dataclasses.replace(st, consensus_params=st.consensus_params.update(
            evidence=dataclasses.replace(st.consensus_params.evidence,
                                         max_age_num_blocks=1, max_age_duration_ns=1)))
    elif case == "unknown_validator":
        stranger = m.keys.Ed25519PrivKey.from_seed(bytes(range(32)))
        for v in (ev.vote_a, ev.vote_b):
            v.validator_address = stranger.pub_key().address()
            v.signature = stranger.sign(v.sign_bytes(tc.CHAIN_ID))
    elif case == "timestamp_mismatch":
        ev.timestamp = m.basic.Timestamp(ev.timestamp.seconds + 1, 0)
    return _outcome(lambda: c.pool.check_evidence(st, [ev]))


@pytest.mark.parametrize("case", EVIDENCE_CASES)
def test_evidence_verdicts_equal_jax(case):
    tsup.set_device_runner(_oracle_runner())
    want = _verdict("cometbft_tpu", case)
    got = _verdict("cometbft_tpu_torch", case)
    assert got == want
    assert (got is None) == (case in ("valid", "lunatic"))


# -- the device rule ---------------------------------------------------------


def test_no_card_no_device_raises(monkeypatch):
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.state.execution import BlockExecutor

    c, _ = tc.drive("cometbft_tpu_torch", heights=1, **CPU)
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    assert not torch.cuda.is_available()
    for make in (lambda **kw: BlockExecutor(c.state_store, c.block_store, c.client,
                                            None, **kw),
                 lambda **kw: EvidencePool(c.db, c.state_store, c.block_store, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda")
        assert make(device="cpu").device == "cpu"
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert BlockExecutor(c.state_store, c.block_store, c.client, None).device is None


@pytest.fixture
def stand_in_card(monkeypatch):
    """CUDA reported available, no library loaded, the trust gate open
    and the cuda tier on the runner seam: the card's rules run here."""
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    monkeypatch.delenv("COMETBFT_TPU_VERIFY_SCHED", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsup, "_load_libraries", lambda dev: None)
    monkeypatch.setattr(tbatch, "default_backend", lambda: "gpu")
    monkeypatch.setattr(tservice, "backend_trusted", lambda: True)
    tvs.reset_scheduler()


def _card_chain():
    """A chain at height 2 on the CPU, then its executor and pool on the
    (stand-in) card, and block 3 carrying a duplicate vote."""
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.state.execution import BlockExecutor

    c, _ = tc.drive("cometbft_tpu_torch", heights=2, **CPU)
    ev = tc.duplicate_vote(c.m, c.privs, c.state_store, c.block_store, 2, 0)
    block = c.make_block(3, tc.txs_at(3, 5, c.seed), [ev])
    pool = EvidencePool(c.db, c.state_store, c.block_store)
    ex = BlockExecutor(c.state_store, c.block_store, c.client, c.m.mempool.NopMempool(),
                       evidence_pool=pool, event_bus=c.bus)
    return c, ex, block


def test_card_evidence_rides_one_scheduler_flush(stand_in_card):
    c, ex, block = _card_chain()
    log = []
    tsup.set_device_runner(_oracle_runner(log))
    tsc.reset_cache()
    ex.validate_block(c.state, block)
    assert sorted(log) == [2, 3]  # the LastCommit's 3 signatures, the pair
    snap = tvstats.snapshot()
    assert snap["submitted"]["evidence_light"] == 2
    assert tds.tier_counts()["cuda"][0] == 2


def test_card_flush_not_served_raises_backend_error(stand_in_card):
    c, ex, block = _card_chain()
    tsup.set_device_runner(_oracle_runner(fail_width=2))
    tsc.reset_cache()
    before = list(c.db.iterate())
    with pytest.raises(BackendError):
        ex.apply_block(c.state, c.m.basic.BlockID(), block)
    assert list(c.db.iterate()) == before
    assert c.block_store.height() == 2
