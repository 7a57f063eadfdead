"""The port's node types against the JAX package's: the codec, blocks,
part sets, evidence, consensus params and the genesis document.

Every object is built twice from one numpy seed, once from each package's
classes (``tests/torch_chain.modules``), so both sign and hash the same
bytes.  All tolerances are exact:

* Codec: every encoder of ``types/codec`` (block, header, data, commit,
  extended commit, vote, proposal, validator set, signed header, light
  block, both evidence types) gives the JAX package's bytes; the port's
  decoder reads the JAX bytes back to an object that encodes to them
  again; ``convert.block_from`` and ``evidence_from`` carry a JAX object
  to one with the same bytes.
* Types: ``Block.hash`` and its filled header hashes, ``PartSet`` root
  and every proof field below and above the plane's 32 leaves,
  ``add_part``'s verdicts (a good part, a forged part, a forged proof, a
  duplicate, an index out of range), ``ConsensusParams.hash`` and
  ``validate`` messages, the genesis JSON, its hash (SHA-256 of the JSON,
  as a node records it), ``from_json`` and ``validate_and_complete``
  errors.

Both hashing gates stay closed (``COMETBFT_TPU_CRYPTO_BACKEND=cpu``); the
JAX calls that would build a tree of 32 or more leaves run with
``COMETBFT_TPU_PROOFSERVE=0`` so that no JAX tree program is compiled.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

import torch_chain as tc
from cometbft_tpu_torch import convert

JAX = tc.modules("cometbft_tpu")
PORT = tc.modules("cometbft_tpu_torch")
SEEDS = (20261031, 7)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")


def _ts(m, rng):
    return m.basic.Timestamp(tc.T0 + int(rng.integers(1, 10**6)),
                             int(rng.integers(0, 10**9)))


def _bid(m, rng):
    return m.basic.BlockID(rng.bytes(32),
                           m.basic.PartSetHeader(int(rng.integers(1, 70)), rng.bytes(32)))


def objects(m, seed: int) -> dict:
    """One object of every encodable kind, from ``seed``, in package ``m``."""
    rng = np.random.default_rng(seed)
    privs = [m.keys.Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(4)]
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = m.validator.ValidatorSet(
        [m.validator.Validator(p.pub_key(), 10 + 5 * i) for i, p in enumerate(privs)])
    height = int(rng.integers(2, 10**6))
    bid = _bid(m, rng)
    header = m.block.Header(
        version=m.block.ConsensusVersion(11, int(rng.integers(0, 3))),
        chain_id=tc.CHAIN_ID, height=height, time=_ts(m, rng),
        last_block_id=_bid(m, rng),
        validators_hash=vals.hash(), next_validators_hash=vals.hash(),
        consensus_hash=rng.bytes(32), app_hash=rng.bytes(32),
        last_results_hash=rng.bytes(32),
        proposer_address=vals.validators[0].address)
    commit = tc.sign_commit(m, by_addr, vals, height - 1, header.last_block_id,
                            absent=(2,))
    ext = m.block.ExtendedCommit(
        height=commit.height, round_=commit.round_, block_id=commit.block_id,
        extended_signatures=[
            m.vote.ExtendedCommitSig.absent_ext_sig() if cs.absent() else
            m.vote.ExtendedCommitSig(cs.block_id_flag, cs.validator_address,
                                     cs.timestamp, cs.signature,
                                     extension=rng.bytes(int(rng.integers(0, 40))),
                                     extension_signature=rng.bytes(64))
            for cs in commit.signatures])
    vote = tc.signed_vote(m, privs[1], vals, height, bid, _ts(m, rng))
    vote.extension, vote.extension_signature = rng.bytes(9), rng.bytes(64)
    nil_vote = tc.signed_vote(m, privs[3], vals, height, m.basic.BlockID(), _ts(m, rng))
    proposal = m.vote.Proposal(height=height, round_=2, pol_round=1, block_id=bid,
                               timestamp=_ts(m, rng))
    proposal.signature = privs[0].sign(proposal.sign_bytes(tc.CHAIN_ID))
    sh_commit = tc.sign_commit(m, by_addr, vals, height,
                               m.basic.BlockID(header.hash(), bid.part_set_header))
    light = m.light.LightBlock(m.light.SignedHeader(header, sh_commit), vals)
    other = tc.signed_vote(m, privs[1], vals, height, _bid(m, rng), vote.timestamp)
    dup = m.evidence.DuplicateVoteEvidence.from_votes(
        vote, other, _ts(m, rng), 15, vals.total_voting_power())
    lca = m.evidence.LightClientAttackEvidence(
        conflicting_block=light, common_height=height - 3,
        byzantine_validators=vals.validators[:2],
        total_voting_power=vals.total_voting_power(), timestamp=_ts(m, rng))
    txs = [rng.bytes(int(rng.integers(0, 80))) for _ in range(int(rng.integers(1, 20)))]
    block = m.block.Block(header=dataclasses.replace(header),
                          data=m.block.Data(txs=txs), last_commit=commit,
                          evidence=[dup, lca])
    return {
        "block": block, "header": header, "data": block.data, "commit": commit,
        "extended_commit": ext, "vote": vote, "nil_vote": nil_vote,
        "proposal": proposal, "validator_set": vals,
        "signed_header": light.signed_header, "light_block": light,
        "duplicate_vote": dup, "light_client_attack": lca,
    }


CODEC = {  # kind -> (encoder, decoder) names of types/codec
    "block": ("encode_block", "decode_block"),
    "header": ("encode_header", "decode_header"),
    "data": ("encode_data", "decode_data"),
    "commit": ("encode_commit", "decode_commit"),
    "extended_commit": ("encode_extended_commit", "decode_extended_commit"),
    "vote": ("encode_vote", "decode_vote"),
    "nil_vote": ("encode_vote", "decode_vote"),
    "proposal": ("encode_proposal", "decode_proposal"),
    "validator_set": ("encode_validator_set", "decode_validator_set"),
    "signed_header": ("encode_signed_header", "decode_signed_header"),
    "light_block": ("encode_light_block", "decode_light_block"),
    "duplicate_vote": ("encode_evidence", "decode_evidence"),
    "light_client_attack": ("encode_evidence", "decode_evidence"),
}


@pytest.fixture(scope="module", params=SEEDS)
def both(request):
    return objects(JAX, request.param), objects(PORT, request.param)


# -- the codec ---------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CODEC))
def test_codec_bytes_equal_jax_and_decode_its_bytes(both, kind):
    jobj, tobj = both[0][kind], both[1][kind]
    enc, dec = CODEC[kind]
    want = getattr(JAX.codec, enc)(jobj)
    assert getattr(PORT.codec, enc)(tobj) == want and len(want) > 0
    back = getattr(PORT.codec, dec)(want)
    assert getattr(PORT.codec, enc)(back) == want
    assert getattr(JAX.codec, enc)(getattr(JAX.codec, dec)(want)) == want


def test_codec_primitives_equal_jax(both):
    j, t = both[0]["vote"], both[1]["vote"]
    for m, v in ((JAX, j), (PORT, t)):
        assert m.codec.decode_block_id(v.block_id.encode()) == v.block_id
        assert m.codec.decode_timestamp(v.timestamp.encode()) == v.timestamp
    for i, (jcs, tcs) in enumerate(zip(both[0]["commit"].signatures,
                                       both[1]["commit"].signatures)):
        want = JAX.codec.encode_commit_sig(jcs)
        assert PORT.codec.encode_commit_sig(tcs) == want, i
        assert PORT.codec.decode_commit_sig(want) == tcs, i


def test_convert_carries_blocks_and_evidence(both):
    jb = both[0]["block"]
    tb = convert.block_from(jb)
    assert PORT.codec.encode_block(tb) == JAX.codec.encode_block(jb)
    for jev in jb.evidence:
        tev = convert.evidence_from(jev)
        assert tev.bytes_() == jev.bytes_() and tev.hash() == jev.hash()
        assert tev.abci() == convert_misbehavior(jev.abci())


def convert_misbehavior(ms):
    return [PORT.at.Misbehavior(
        type_=m.type_, validator=PORT.at.Validator(m.validator.address, m.validator.power),
        height=m.height, time_unix_ns=m.time_unix_ns,
        total_voting_power=m.total_voting_power) for m in ms]


# -- blocks ------------------------------------------------------------------


def test_block_hash_and_filled_header_equal_jax(both):
    hashes = []
    for objs in both:
        b = objs["block"]
        b.header.last_commit_hash = b.header.data_hash = b.header.evidence_hash = b""
        hashes.append((b.hash(), b.header.last_commit_hash, b.header.data_hash,
                       b.header.evidence_hash, b.validate_basic()))
    assert hashes[0] == hashes[1]
    assert hashes[1][4] is None and len(hashes[1][0]) == 32


@pytest.mark.parametrize("field", ["data", "last_commit_hash", "evidence"])
def test_block_validate_basic_messages_equal_jax(both, field):
    got = []
    for objs in both:
        b = objs["block"]
        b.hash()
        if field == "data":
            b.data.txs.append(b"late tx")
        elif field == "last_commit_hash":
            b.header.last_commit_hash = bytes(32)
        else:
            b.evidence = b.evidence[:1]
        got.append(b.validate_basic())
    assert got[0] == got[1] and got[1]


def test_commit_helpers_equal_jax(both):
    jc, tcm = both[0]["commit"], both[1]["commit"]
    for i in range(len(jc.signatures)):
        jv, tv = JAX.block.commit_vote(jc, i), PORT.block.commit_vote(tcm, i)
        assert (jv is None) == (tv is None)
        if jv is not None:
            assert PORT.codec.encode_vote(tv) == JAX.codec.encode_vote(jv)
            assert tv.block_id == convert.block_id_from(jv.block_id)
            assert PORT.vote.CommitSig.from_vote(tv) == tcm.signatures[i]
        assert (tcm.signatures[i].block_id(tcm.block_id)
                == convert.block_id_from(jc.signatures[i].block_id(jc.block_id)))
    je, te = both[0]["extended_commit"], both[1]["extended_commit"]
    assert PORT.codec.encode_commit(te.to_commit()) == JAX.codec.encode_commit(je.to_commit())
    assert len(PORT.block.commit_sigs(te)) == len(JAX.block.commit_sigs(je))
    assert PORT.block.empty_commit().hash() == JAX.block.empty_commit().hash()
    jv, tv = both[0]["vote"], both[1]["vote"]
    assert tv.extension_sign_bytes(tc.CHAIN_ID) == jv.extension_sign_bytes(tc.CHAIN_ID)
    assert tv.copy() == tv and tv.copy() is not tv
    jp, tp = both[0]["proposal"], both[1]["proposal"]
    assert tp.sign_bytes(tc.CHAIN_ID) == jp.sign_bytes(tc.CHAIN_ID)
    assert tp.validate_basic() == jp.validate_basic()


# -- part sets ---------------------------------------------------------------


def _proof_fields(ps):
    return [(p.index, p.bytes_, p.proof.total, p.proof.index, p.proof.leaf_hash,
             list(p.proof.aunts)) for p in ps.parts]


@pytest.mark.parametrize("n_bytes,part_size", [
    (0, 64), (1, 64), (64 * 5 - 3, 64), (64 * 31, 64), (64 * 32, 64),
    (64 * 33 + 1, 64), (64 * 70 + 9, 64), (65536 * 2 + 5, 65536)])
def test_part_set_root_and_proofs_equal_jax(monkeypatch, n_bytes, part_size):
    data = np.random.default_rng(n_bytes).bytes(n_bytes)
    tps = PORT.part_set.PartSet.from_data(data, part_size)
    with monkeypatch.context() as mp:
        mp.setenv("COMETBFT_TPU_PROOFSERVE", "0")
        jps = JAX.part_set.PartSet.from_data(data, part_size)
    assert tps.header == convert.block_id_from(
        JAX.basic.BlockID(b"", jps.header)).part_set_header
    assert _proof_fields(tps) == _proof_fields(jps)
    assert (tps.count, tps.byte_size, tps.bit_array()) == (
        jps.count, jps.byte_size, jps.bit_array())
    assert tps.assemble() == jps.assemble() == data


def test_full_parts_are_one_tree_pass_on_the_card(monkeypatch):
    """A full 64 KiB part is 1,025 SHA-256 blocks once prefixed and padded,
    one over the JAX bucket ladder: on the card (the gate open, a stand-in
    for the kernel's pass) the part set is one tree pass all the same,
    with the JAX package's root.  A leaf over the card's own bound still
    goes to the host, counted as oversize."""
    from cometbft_tpu_torch.crypto import batch as tbatch
    from cometbft_tpu_torch.crypto import merkle as tmerkle
    from cometbft_tpu_torch.ops import dispatch_stats as tds
    from cometbft_tpu_torch.ops import sha256_tree as ttree

    data = np.random.default_rng(33).bytes(65536 * 33 + 7)
    with monkeypatch.context() as mp:
        mp.setenv("COMETBFT_TPU_PROOFSERVE", "0")
        jps = JAX.part_set.PartSet.from_data(data, 65536)
    chunks = [p.bytes_ for p in jps.parts]
    assert ttree._bucket_shape(chunks) is None  # the JAX ladder's verdict
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda:0"})
    monkeypatch.setattr(ttree, "device_levels",
                        lambda items, device=None: ttree.host_levels(items))
    tds.reset()
    try:
        tps = PORT.part_set.PartSet.from_data(data, 65536)
        assert tds.tier_counts(ttree.MERKLE)["cuda"] == (1, 34)
        assert tds.tier_counts(ttree.MERKLE_OVERSIZE)["host"] == (0, 0)
        assert tps.header.hash == jps.header.hash
        assert _proof_fields(tps) == _proof_fields(jps)
        too_long = [b"a" * (64 * ttree._CARD_MAX_BLOCKS)] + chunks
        assert ttree.tree_root(too_long) == tmerkle.hash_from_byte_slices(too_long)
        assert tds.tier_counts(ttree.MERKLE_OVERSIZE)["host"] == (1, 35)
        assert tds.tier_counts(ttree.MERKLE)["cuda"] == (1, 34)
    finally:
        tds.reset()


def _add_part_verdicts(m, data, part_size):
    src = m.part_set.PartSet.from_data(data, part_size)
    dst = m.part_set.PartSet(src.header)
    good = src.parts[3]
    forged = m.part_set.Part(good.index, b"X" + good.bytes_[1:], good.proof)
    other = src.parts[4]
    bad_proof = m.part_set.Part(good.index, good.bytes_, other.proof)
    aunts = list(good.proof.aunts)
    aunts[0] = bytes(32)
    bad_aunt = m.part_set.Part(
        good.index, good.bytes_,
        m.merkle.Proof(good.proof.total, good.proof.index, good.proof.leaf_hash, aunts))
    out = [dst.add_part(forged), dst.add_part(bad_proof), dst.add_part(bad_aunt),
           dst.add_part(m.part_set.Part(src.header.total, b"", good.proof)),
           dst.add_part(good), dst.add_part(good), dst.is_complete()]
    for p in src.parts:
        dst.add_part(p)
    return out + [dst.is_complete(), dst.assemble() == data]


@pytest.mark.parametrize("parts", [9, 40])
def test_add_part_verdicts_equal_jax(monkeypatch, parts):
    data = np.random.default_rng(parts).bytes(64 * parts - 5)
    got = _add_part_verdicts(PORT, data, 64)
    with monkeypatch.context() as mp:
        mp.setenv("COMETBFT_TPU_PROOFSERVE", "0")
        want = _add_part_verdicts(JAX, data, 64)
    assert got == want
    assert got[0] == (False, "invalid part proof") and got[4] == (True, None)
    assert got[-2:] == [True, True]


# -- consensus params --------------------------------------------------------

PARAM_CASES = [
    {},
    {"block": {"max_bytes": 1 << 20, "max_gas": 10**7}},
    {"block": {"max_bytes": -1}},
    {"block": {"max_bytes": 0}},
    {"block": {"max_bytes": 200 * 1024 * 1024}},
    {"block": {"max_gas": -2}},
    {"evidence": {"max_age_num_blocks": 0}},
    {"evidence": {"max_age_duration_ns": -1}},
    {"evidence": {"max_bytes": 4096}},
    {"validator": {"pub_key_types": ()}},
    {"validator": {"pub_key_types": ("ed25519", "secp256k1")}},
    {"feature": {"vote_extensions_enable_height": -1}},
    {"feature": {"pbts_enable_height": 5, "vote_extensions_enable_height": 3}},
    {"synchrony": {"precision_ns": -1}},
]


def _params(m, case):
    p = m.params.default_consensus_params()
    for section, kw in case.items():
        p = p.update(**{section: dataclasses.replace(getattr(p, section), **kw)})
    return p


@pytest.mark.parametrize("case", range(len(PARAM_CASES)))
def test_params_hash_and_validate_equal_jax(case):
    j, t = _params(JAX, PARAM_CASES[case]), _params(PORT, PARAM_CASES[case])
    assert t.hash() == j.hash() and len(t.hash()) == 32
    assert t.validate() == j.validate()
    assert t.vote_extensions_enabled(4) == j.vote_extensions_enabled(4)
    assert t.pbts_enabled(4) == j.pbts_enabled(4)
    assert convert.params_from(j) == t
    if case == 0:
        assert t.block.max_bytes == 4 << 20 and t.evidence.max_bytes == 1 << 20


# -- genesis -----------------------------------------------------------------


def _genesis(m, **kw):
    privs = [m.keys.Ed25519PrivKey.from_seed(s) for s in tc.seeds(5, SEEDS[0])]
    doc = dict(chain_id=tc.CHAIN_ID, genesis_time=m.basic.Timestamp(tc.T0, 123),
               validators=[m.genesis.GenesisValidator(p.pub_key(), 10 * (i + 1), f"v{i}")
                           for i, p in enumerate(privs)],
               app_hash=bytes(range(32)), app_state=b'{"k": "v"}')
    doc.update(kw)
    return m.genesis.GenesisDoc(**doc)


def test_genesis_json_hash_and_state_equal_jax():
    j, t = _genesis(JAX), _genesis(PORT)
    j.validate_and_complete()
    t.validate_and_complete()
    assert t.to_json() == j.to_json()
    assert (hashlib.sha256(t.to_json().encode()).digest()
            == hashlib.sha256(j.to_json().encode()).digest())
    back = PORT.genesis.GenesisDoc.from_json(j.to_json())
    assert back.to_json() == j.to_json()
    assert convert.genesis_from(j).to_json() == j.to_json()
    assert t.validator_set().hash() == j.validator_set().hash()
    js, ts = JAX.state.state_from_genesis(j), PORT.state.state_from_genesis(t)
    assert ts.to_json() == js.to_json()
    assert convert.state_from(js).to_json() == js.to_json()
    assert PORT.state.State.from_json(js.to_json()).to_json() == js.to_json()


GENESIS_ERRORS = [
    {"chain_id": ""},
    {"chain_id": "c" * 51},
    {"initial_height": -1},
    {"initial_height": 0},
    {"consensus_params": {"block": {"max_bytes": 0}}},
    {"consensus_params": {"evidence": {"max_age_num_blocks": -3}}},
    {"validators": -1},
]


@pytest.mark.parametrize("case", range(len(GENESIS_ERRORS)))
def test_genesis_validate_and_complete_errors_equal_jax(case):
    out = []
    for m in (JAX, PORT):
        kw = dict(GENESIS_ERRORS[case])
        if "consensus_params" in kw:
            kw["consensus_params"] = _params(m, kw["consensus_params"])
        if kw.get("validators") == -1:
            pk = m.keys.Ed25519PrivKey.from_seed(bytes(32)).pub_key()
            kw["validators"] = [m.genesis.GenesisValidator(pk, -5)]
        g = _genesis(m, **kw)
        try:
            g.validate_and_complete()
            out.append(("ok", g.to_json()))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
