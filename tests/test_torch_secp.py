"""secp256k1 in the port against the JAX package, on the CPU.

* keys, addresses and RFC 6979 signatures (``crypto/secp256k1.py``) byte
  for byte against the JAX module's ``from_secret``/``_sign_pure``, and the
  pure-Python RIPEMD-160 against ``hashlib``;
* host prep: the port's ``prepare_batch`` (the device's inputs) against
  the JAX ``prepare_batch``;
* the plain version of the ECDSA kernel (``ops/secp_verify.verify_core``)
  on mixed lanes — flipped bytes, the wrong message, the wrong key, every
  structural reject including high-S, and the x >= n branch of the
  compare at the ladder's own inputs — against the JAX
  ``Secp256k1PubKey.verify_signature`` and the port's oracle: one plain
  verify, shared by the module; the JAX XLA ladder on 4 of its lanes;
* the batch-verifier seam (routing, ``backend="cpu"`` through the
  signature cache, the self-check's refusal), cache keys across key
  types, validator sets of secp256k1 keys, gossip-time ``Vote.verify``,
  and a secp256k1 commit built with the JAX package's types, carried
  across by ``convert``, through ``verify_commit*`` of both packages with
  the same errors.
"""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.ops import secp_verify as jsv
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.basic import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    PartSetHeader,
    Timestamp,
)
from cometbft_tpu.types.block import Commit
from cometbft_tpu.types.validator import Validator, ValidatorSet
from cometbft_tpu.types.vote import CommitSig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import secp_verify as tsv
from cometbft_tpu_torch.types import validation as tval

from test_torch_cuda_secp import mixed_lanes

CHAIN = "torch-secp-chain"
HEIGHT = 9


def _privs(n, tag=b"secp-test"):
    return [jsecp.Secp256k1PrivKey.from_secret(tag + b"-%d" % i) for i in range(n)]


def _jax_verdict(p, m, s):
    try:
        return jsecp.Secp256k1PubKey(p).verify_signature(m, s)
    except ValueError:
        return False


def _edge_lanes():
    """The x >= n branch of the compare at the ladder's own inputs: Q with
    x >= n, u1 = 0, u2 = 1 (so R' = Q) and r = x - n (accept) or x - n + 1
    (reject)."""
    x = tsv.N
    while tsv.decompress_pubkey(b"\x02" + x.to_bytes(32, "big")) is None:
        x += 1
    row = lambda v: list(v.to_bytes(32, "big"))
    return x, {
        "q33": torch.tensor([list(b"\x02" + x.to_bytes(32, "big"))] * 2, dtype=torch.uint8),
        "u1": torch.zeros(2, 32, dtype=torch.uint8),
        "u2": torch.tensor([row(1)] * 2, dtype=torch.uint8),
        "r": torch.tensor([row(x - tsv.N), row(x - tsv.N + 1)], dtype=torch.uint8),
        "ok": torch.ones(2, dtype=torch.uint8),
    }


@pytest.fixture(scope="module")
def plain():
    """One plain verify on the CPU for the module: the 16 mixed lanes and
    the two x >= n lanes in one batch."""
    pubs, msgs, sigs = mixed_lanes()
    t = tsv.batch_to_device(tsv.prepare_batch(pubs, msgs, sigs), "cpu")
    x, edge = _edge_lanes()
    both = {k: torch.cat([t[k], edge[k]]) for k in tsv.KEYS}
    bits = tsv.verify_core(**both).tolist()
    return (pubs, msgs, sigs), bits[:16], bits[16:], x


# -- keys ---------------------------------------------------------------------


@pytest.mark.parametrize("secret", [b"secp-test-0", b"\x01" * 32, b"\xff" * 31, b"k"])
def test_keys_addresses_and_signatures_equal_jax(secret):
    jp, tp = jsecp.Secp256k1PrivKey.from_secret(secret), tsecp.Secp256k1PrivKey.from_secret(secret)
    jpub, tpub = jp.pub_key(), tp.pub_key()
    assert tpub.bytes() == jpub.bytes() and tpub.address() == jpub.address()
    for msg in (b"", b"vote", bytes(range(200))):
        sig = tp.sign(msg)
        assert sig == jp._sign_pure(msg)
        assert jpub.verify_signature(msg, sig) and tpub.verify_signature(msg, sig)
        assert int.from_bytes(sig[32:], "big") <= tsv.N // 2


def test_ripemd160_pure_equals_hashlib():
    rng = np.random.default_rng(3)
    for n in (0, 1, 55, 56, 63, 64, 65, 119, 120, 200):
        data = rng.bytes(n)
        assert tsecp.ripemd160_pure(data) == hashlib.new("ripemd160", data).digest()
    assert tsecp.ripemd160_pure(b"abc").hex() == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"


def test_key_registry():
    pub = tsecp.Secp256k1PrivKey.from_secret(b"reg").pub_key()
    assert tkeys.supported_key_types() == ["ed25519", "secp256k1", "bls12_381"]
    assert tkeys.supported_key_types() == jkeys.supported_key_types()
    assert tkeys.pub_key_from_type("secp256k1", pub.bytes()) == pub
    assert tkeys.pub_key_from_type("ed25519", b"\x01" * 32).type_ == "ed25519"
    with pytest.raises(ValueError):
        tkeys.pub_key_from_type("bls12_381", b"\x00" * 48)  # 96 bytes
    with pytest.raises(ValueError):
        tkeys.pub_key_from_type("sr25519", b"\x00" * 32)
    with pytest.raises(ValueError):
        tsecp.Secp256k1PubKey(b"\x02" * 32)
    assert jkeys.SECP256K1_KEY_TYPE == tkeys.SECP256K1_KEY_TYPE


# -- host prep and verify -------------------------------------------------------


def test_prepare_batch_equals_jax():
    """The same scalars and targets; the port leaves decompression to the
    device, so its ``ok`` differs only at lane 12 (x off the curve)."""
    pubs, msgs, sigs = mixed_lanes()
    got = tsv.prepare_batch(pubs, msgs, sigs)
    points, u1s, u2s, rs, ok = jsv.prepare_batch(pubs, msgs, sigs)
    assert [i for i in range(16) if got["ok"][i] != ok[i]] == [12]
    assert tsv.decompress_pubkey(got["q33"][12].tobytes()) is None
    big = lambda row: int.from_bytes(row.tobytes(), "big")
    for i in np.flatnonzero(ok):
        assert tsv.decompress_pubkey(got["q33"][i].tobytes()) == points[i]
        assert (big(got["u1"][i]), big(got["u2"][i]), big(got["r"][i])) == (
            u1s[i], u2s[i], rs[i])
    bad = ~got["ok"]
    assert not got["q33"][bad].any() and not got["u1"][bad].any()
    assert not got["u2"][bad].any() and not got["r"][bad].any()


def test_plain_verify_equals_jax_and_oracle(plain):
    (pubs, msgs, sigs), bits, _, _ = plain
    assert bits == [_jax_verdict(*t) for t in zip(pubs, msgs, sigs)]
    assert bits == [len(p) == 33 and tsecp.Secp256k1PubKey(p).verify_signature(m, s)
                    for p, m, s in zip(pubs, msgs, sigs)]
    assert bits == [True] * 4 + [False] * 12


def test_x_at_least_n_compare_branch(plain):
    _, _, edge, x = plain
    assert x >= tsv.N and x - tsv.N < tsv.P - tsv.N
    assert edge == [True, False]


def test_decompress_on_the_device_equals_host():
    pubs, _, _ = mixed_lanes()
    keys = [p for p in pubs if len(p) == 33]
    q = torch.tensor([list(p) for p in keys], dtype=torch.uint8)
    on_curve, x, y = tsv.decompress(q)
    for k, p in enumerate(keys):
        want = tsv.decompress_pubkey(p)
        assert bool(on_curve[k]) == (want is not None)
        if want is not None:
            assert (tsv.FIELD.unpack(x)[k], tsv.FIELD.unpack(y)[k]) == want


def test_plain_verify_equals_jax_xla_ladder(plain, monkeypatch):
    """The JAX ladder through plain ``jax.jit`` (``COMETBFT_TPU_AOT=0``):
    an executable that the JAX package's exec cache stored in another
    process can refuse to run here, and the ladder is what is compared."""
    (pubs, msgs, sigs), bits, _, _ = plain
    monkeypatch.setenv("COMETBFT_TPU_AOT", "0")
    assert jsv.verify_batch(pubs[:4], msgs[:4], sigs[:4]).tolist() == bits[:4]


def test_verify_batch_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.verify_batch([b"\x02" * 33], [b"m"], [b"\x01" * 64])
    assert tsv.verify_batch([], [], [], device="cpu").shape == (0,)


# -- the batch-verifier seam ------------------------------------------------------


def test_create_batch_verifier_routes_by_key_type():
    pub = tsecp.Secp256k1PrivKey.from_secret(b"route").pub_key()
    assert tbatch.supports_batch_verifier(pub)
    bv = tbatch.create_batch_verifier(pub)
    assert isinstance(bv, tbatch.Secp256k1BatchVerifier) and bv.device is None
    assert tbatch.create_batch_verifier(pub, backend="cpu").device == "cpu"
    assert tbatch.create_batch_verifier(pub, device="cpu").device == "cpu"
    with pytest.raises(ValueError):
        tbatch.create_batch_verifier(pub, backend="tpu")
    assert not tbatch.supports_batch_verifier(object())


def test_cpu_backend_runs_the_plain_version_through_the_cache():
    tsc.reset_cache()
    tds.reset()
    privs = [tsecp.Secp256k1PrivKey.from_secret(b"cpu-%d" % i) for i in range(3)]
    msgs = [b"m%d" % i for i in range(3)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[1] = sigs[0]

    def run():
        bv = tbatch.create_batch_verifier(privs[0].pub_key(), backend="cpu")
        for p, m, s in zip(privs, msgs, sigs):
            bv.add(p.pub_key(), m, s)
        return bv.verify()

    assert run() == (False, [True, False, True])
    assert tds.tier_counts("secp256k1") == {"cuda": (0, 0), "torch": (1, 3), "host": (0, 0)}
    assert run() == (False, [True, False, True])  # every verdict cached
    assert tds.tier_counts("secp256k1")["torch"] == (1, 3)
    tsc.reset_cache()


def test_failed_self_check_refuses_the_card(monkeypatch):
    """A card whose secp256k1 kernel gets the known answers wrong is
    refused with ``SelfCheckError``; nothing answers in its place and
    nothing is cached.  (A stand-in card: CUDA reported available, the
    kernel's ``verify_batch`` replaced by one that accepts everything.)"""
    tsc.reset_cache()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbatch, "_SECP_SELF_CHECKED", set())
    monkeypatch.setattr(tsv, "verify_batch",
                        lambda p, m, s, device=None: np.ones(len(p), bool))
    with pytest.raises(tbatch.SelfCheckError, match="secp256k1"):
        tbatch.secp_self_check()
    priv = tsecp.Secp256k1PrivKey.from_secret(b"self")
    bv = tbatch.create_batch_verifier(priv.pub_key())
    bv.add(priv.pub_key(), b"m", priv.sign(b"m"))
    with pytest.raises(tbatch.SelfCheckError):
        bv.verify()
    assert len(tsc.get_cache()) == 0


def test_cache_keys_do_not_collide_across_key_types():
    ed = b"\x11" * 32
    secp = ed + b"\x22"
    assert tsc._key(ed, b"\x22msg", b"s" * 64) != tsc._key(secp, b"msg", b"s" * 64)
    tsc.reset_cache()
    priv = tsecp.Secp256k1PrivKey.from_secret(b"cache")
    pub, sig = priv.pub_key(), priv.sign(b"vote")
    calls = []
    orig = tsecp.Secp256k1PubKey.verify_signature

    def counted(self, m, s):
        calls.append(m)
        return orig(self, m, s)

    tsecp.Secp256k1PubKey.verify_signature = counted
    try:
        assert tsc.verify_with_cache(pub, b"vote", sig)
        assert tsc.verify_with_cache(pub, b"vote", sig)
        assert not tsc.verify_with_cache(pub, b"vote!", sig)
    finally:
        tsecp.Secp256k1PubKey.verify_signature = orig
    assert calls == [b"vote", b"vote!"]  # the key's own verify, once each
    tsc.reset_cache()


# -- types, gossip and the commit ---------------------------------------------------


def _jax_commit(privs, bad=(), nil=(), absent=()):
    vals = ValidatorSet([Validator(p.pub_key(), 10 + i) for i, p in enumerate(privs)])
    by_addr = {p.pub_key().address(): p for p in privs}
    block_id = BlockID(hashlib.sha256(b"secp block").digest(),
                       PartSetHeader(2, hashlib.sha256(b"secp parts").digest()))
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in absent:
            sigs.append(CommitSig.absent_sig())
            continue
        flag = BLOCK_ID_FLAG_NIL if i in nil else BLOCK_ID_FLAG_COMMIT
        sigs.append(CommitSig(flag, v.address, Timestamp(1_700_000_000 + i, 7 * i), b""))
    commit = Commit(HEIGHT, 0, block_id, sigs)
    for i, v in enumerate(vals.validators):
        cs = commit.signatures[i]
        if cs.absent():
            continue
        priv = by_addr[v.address]
        msg = commit.vote_sign_bytes(CHAIN, i)
        sig = priv._sign_pure(msg) if hasattr(priv, "_sign_pure") else priv.sign(msg)
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        cs.signature = sig
    return vals, commit, block_id


SECP_CASES = {
    "valid": dict(nil=(2,)),
    "bad_sig": dict(bad=(3, 6)),
    "not_enough_power": dict(absent=(0, 1, 2, 4, 5)),
    "wrong_height": dict(),
}


def _outcome(fn):
    try:
        fn()
    except (jval.CommitVerificationError, tval.CommitVerificationError) as e:
        return (type(e).__name__, str(e), getattr(e, "index", None),
                getattr(e, "got", None), getattr(e, "needed", None))
    return None


@pytest.fixture(scope="module")
def secp_commits():
    out = {}
    for name, kw in SECP_CASES.items():
        jv, jc, jb = _jax_commit(_privs(8, b"val"), **kw)
        out[name] = ((jv, jc, jb), (convert.validator_set_from(jv),
                                    convert.commit_from(jc), convert.block_id_from(jb)))
    return out


@pytest.mark.parametrize("fn", ["verify_commit", "verify_commit_light",
                                "verify_commit_light_trusting"])
@pytest.mark.parametrize("case", sorted(SECP_CASES))
def test_secp_commit_errors_equal_jax(secp_commits, monkeypatch, case, fn):
    """The port's plain version on the CPU (``device="cpu"``) against the
    JAX package's host path (its device ladder switched off)."""
    monkeypatch.setenv("COMETBFT_TPU_SECP_DEVICE", "0")
    (jv, jc, jb), (tv, tc, tb) = secp_commits[case]
    height = HEIGHT + 1 if case == "wrong_height" else HEIGHT
    assert tval._should_batch(tv, tc) == jval._should_batch(jv, jc)

    def run(pkg, vals, commit, block_id, **kw):
        if fn == "verify_commit_light_trusting":
            from fractions import Fraction

            return _outcome(lambda: pkg.verify_commit_light_trusting(
                CHAIN, vals, commit, Fraction(1, 3), **kw))
        return _outcome(lambda: getattr(pkg, fn)(CHAIN, vals, block_id, height,
                                                 commit, **kw))

    want = run(jval, jv, jc, jb, backend="cpu")
    assert run(tval, tv, tc, tb, device="cpu") == want
    if case == "bad_sig" and fn == "verify_commit":
        assert want[0] == "InvalidSignatureError" and want[2] == 3
    if case == "valid":
        assert want is None


def test_validator_sets_of_secp_keys(secp_commits):
    (jv, _, _), (tv, tc, _) = secp_commits["valid"]
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert all(isinstance(v.pub_key, tsecp.Secp256k1PubKey) for v in tv.validators)
    assert [v.address for v in tv.validators] == sorted(v.address for v in tv.validators)
    v3 = tv.validators[3]
    assert tv.get_by_address(v3.address) == (3, v3) and len(v3.address) == 20
    assert tval._should_batch(tv, tc)


def test_mixed_key_set_verifies_one_by_one_as_jax(monkeypatch):
    """A set of Ed25519 and secp256k1 keys is not batched (one key type
    per batch verifier): both packages verify signature by signature."""
    monkeypatch.setenv("COMETBFT_TPU_SECP_DEVICE", "0")
    rng = np.random.default_rng(4)
    privs = _privs(3, b"mix") + [jkeys.Ed25519PrivKey.from_seed(rng.bytes(32))
                                 for _ in range(3)]
    for bad in ((), (4,)):
        jv, jc, jb = _jax_commit(privs, bad=bad)
        tv, tc, tb = (convert.validator_set_from(jv), convert.commit_from(jc),
                      convert.block_id_from(jb))
        assert not tval._should_batch(tv, tc) and not jval._should_batch(jv, jc)
        want = _outcome(lambda: jval.verify_commit(CHAIN, jv, jb, HEIGHT, jc,
                                                   backend="cpu"))
        got = _outcome(lambda: tval.verify_commit(CHAIN, tv, tb, HEIGHT, tc))
        assert got == want and (got is None) == (not bad)


def test_fused_verify_stays_ed25519_only(secp_commits, monkeypatch):
    monkeypatch.setattr(tbatch, "default_backend", lambda: "gpu")
    _, (tv, _, _) = secp_commits["valid"]
    assert not tval.fused_verify_eligible([tv])
    assert tval.fused_verify_eligible([])


def test_vote_verify_with_a_secp_key_is_cache_through_on_the_host():
    from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.basic import BlockID as TBlockID
    from cometbft_tpu_torch.types.basic import Timestamp as TTimestamp
    from cometbft_tpu_torch.types.vote import Vote

    tsc.reset_cache()
    tds.reset()
    priv = tsecp.Secp256k1PrivKey.from_secret(b"gossip")
    vote = Vote(PRECOMMIT_TYPE, 3, 0, TBlockID(), TTimestamp(5, 6),
                priv.pub_key().address(), 0)
    vote.signature = priv.sign(vote.sign_bytes(CHAIN))
    assert vote.verify(CHAIN, priv.pub_key())
    assert tsc.get_cache().get(priv.pub_key().bytes(), vote.sign_bytes(CHAIN),
                               vote.signature) is True
    vote.signature = vote.signature[:63] + bytes([vote.signature[63] ^ 1])
    assert not vote.verify(CHAIN, priv.pub_key())
    assert tds.snapshot()["dispatches"] == 0  # no device batch, no scheduler
    tsc.reset_cache()
