"""BLS12-381 in the port against the JAX package, on the CPU.

* the port's pure-Python oracle (``crypto/bls12381.py``) and its host
  library (``csrc/bls12381.cpp``) against the JAX package's module and
  library, byte for byte: keys, signatures, hashes to G2, G1 and G2 scalar
  multiplications, aggregates, and pairing verdicts (a false product too);
* ``ops/fp381`` against Python integers and the JAX ``fp381``, its
  ``F2`` ops against the JAX ``f2_*`` called eagerly at 8 lanes;
  ``wcurve.Curve.scalar_mul`` over it against the JAX ``g1.scalar_mul``
  called eagerly on packed points (equal canonical X, Y, Z);
  ``bls_g1.batch_scalar_mul``, ``msm`` and ``sum_points`` on the CPU
  against the oracle at 128 bits;
  the G1 kernel's source built for the host (``csrc/bls_g1.cu``) against
  the same JAX call, as points;
* ``BlsBatchVerifier`` verdicts against the JAX class on the cases of
  ``tests/test_bls_batch.py``; a BLS commit built with the JAX package's
  types, carried across by ``convert``, through ``verify_commit*`` of both
  packages with the same errors; gossip-time ``Vote.verify``;
* the card's rule: a CUDA request without a card raises; on the
  device-runner seam a G1 fault raises ``BackendError`` for a CUDA device
  (a stand-in card) and is answered by the host library, and counted, on
  the CPU; a failed self-check refuses the card.

The JAX package's ``g1.batch_scalar_mul``/``msm``/``sum_points`` are never
called: they read the shared ``.exec_cache/``.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu import native as jnative
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.ops import bls_g1 as jg1
from cometbft_tpu.ops import fp381 as jfp
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
from cometbft_tpu_torch import convert, native
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import sigcache as tsc
from cometbft_tpu_torch.ops import bls_g1 as tg1
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import fp381 as tfp
from cometbft_tpu_torch.ops import supervisor as tsup
from cometbft_tpu_torch.types import validation as tval

P = tbls.P
CHAIN = "torch-bls-chain"
HEIGHT = 11


def _buf(lib, fn, *args):
    import ctypes

    out = ctypes.create_string_buffer(96)
    assert getattr(lib, fn)(*args, out) == 0
    return out.raw


@pytest.fixture(autouse=True)
def _fresh_cache():
    tsc.reset_cache()
    yield
    tsc.reset_cache()


@pytest.fixture(scope="module")
def libs():
    """(the port's host library, the JAX package's)."""
    jlib = jnative.bls()
    assert jlib is not None
    return native.bls(), jlib


SKS = [tbls.gen_privkey_from_secret(b"bls-op-%d" % i) for i in range(3)]
MSGS = [b"", b"vote", bytes(range(200))]
K128 = [1, 0xB7E151628AED2A6ABF7158809CF4F3C7, (1 << 128) - 1]


def _library(lib, op):
    if op == "pubkey":
        return [_buf(lib, "bls_pubkey_from_sk", sk.to_bytes(32, "big")) for sk in SKS]
    if op == "sign":
        return [_buf(lib, "bls_sign", sk.to_bytes(32, "big"), m, len(m))
                for sk, m in zip(SKS, MSGS)]
    if op == "hash_to_g2":
        return [_buf(lib, "bls_hash_to_g2", m, len(m)) for m in MSGS]
    pubs = [_buf(lib, "bls_pubkey_from_sk", sk.to_bytes(32, "big")) for sk in SKS]
    sigs = [_buf(lib, "bls_sign", sk.to_bytes(32, "big"), m, len(m))
            for sk, m in zip(SKS, MSGS)]
    if op == "g1_mul":
        return [_buf(lib, "bls_g1_scalar_mul", p, k.to_bytes(16, "big"), 16)
                for p, k in zip(pubs + [tg1.INFINITY], K128 + [5])]
    if op == "g2_mul":
        return [_buf(lib, "bls_g2_scalar_mul_compressed", s, k.to_bytes(16, "big"), 16)
                for s, k in zip(sigs, K128)]
    assert op == "aggregate"
    return [_buf(lib, "bls_aggregate_sigs", b"".join(sigs[:k]), k) for k in (0, 1, 3)]


def _oracle(b, op):
    """The same values from the pure-Python module ``b`` (port or JAX)."""
    if op == "pubkey":
        return [b.g1_serialize(b.E1.mul_scalar(b.G1_GEN, sk)) for sk in SKS]
    if op == "sign":
        return [b.g2_compress(b.E2.mul_scalar(b.hash_to_g2(m), sk))
                for sk, m in zip(SKS, MSGS)]
    if op == "hash_to_g2":
        return [b.g2_compress(b.hash_to_g2(m)) for m in MSGS]
    pks = [b.E1.mul_scalar(b.G1_GEN, sk) for sk in SKS]
    if op == "g1_mul":
        return [b.g1_serialize(b.E1.mul_scalar(p, k))
                for p, k in zip(pks + [b.E1.infinity()], K128 + [5])]
    hs = [b.hash_to_g2(m) for m in MSGS]
    sigs = [b.E2.mul_scalar(h, sk) for h, sk in zip(hs, SKS)]
    if op == "g2_mul":
        return [b.g2_compress(b.E2.mul_scalar(s, k)) for s, k in zip(sigs, K128)]
    acc, out = b.E2.infinity(), []
    for k in (0, 1, 3):
        acc = b.E2.infinity()
        for s in sigs[:k]:
            acc = b.E2.add_pts(acc, s)
        out.append(b.g2_compress(acc))
    return out


@pytest.mark.parametrize("op", ["pubkey", "sign", "hash_to_g2", "g1_mul",
                                "g2_mul", "aggregate"])
def test_library_and_oracle_equal_jax(libs, op):
    port_lib, jax_lib = libs
    got = _library(port_lib, op)
    assert got == _library(jax_lib, op)
    assert got == _oracle(tbls, op) == _oracle(jbls, op)


def test_api_equals_jax_and_oracle():
    sk = SKS[0]
    pub, sig = tbls.pubkey(sk), tbls.sign(sk, b"m")
    assert pub == jbls.pubkey(sk) == tbls.pubkey_py(sk)
    assert sig == jbls.sign(sk, b"m") == tbls.sign_py(sk, b"m")
    sigs = [tbls.sign(s, b"agg %d" % i) for i, s in enumerate(SKS)]
    assert tbls.aggregate_signatures(sigs) == jbls.aggregate_signatures(sigs)
    assert tbls.aggregate_signatures([sigs[0][:40]]) is None
    lib = tbls._nat()
    for key in (pub, tg1.INFINITY, pub[:48], tbls.g1_negate_serialized(pub)):
        want = jbls.pubkey_validate(key)
        assert (lib.bls_pubkey_validate(key, len(key)) == 1) == want
    assert jbls.pubkey_validate(pub) and not jbls.pubkey_validate(tg1.INFINITY)


def test_pairing_verdicts_equal_jax_and_oracle(libs):
    """Verify (host library), the pure-Python verify and the JAX verify on a
    good signature, the wrong message, the wrong key, the identity as the
    signature and short inputs; and a false pairing product in the library
    against the oracle's."""
    port_lib, _ = libs
    sk, other = SKS[1], SKS[2]
    pub, sig = tbls.pubkey(sk), tbls.sign(sk, b"msg")
    inf_sig = b"\xc0" + bytes(95)
    cases = [(pub, b"msg", sig), (pub, b"msh", sig), (tbls.pubkey(other), b"msg", sig),
             (pub, b"msg", inf_sig), (pub[:48], b"msg", sig), (pub, b"msg", sig[:95])]
    want = [True, False, False, False, False, False]
    for case, w in zip(cases, want):
        assert tbls.verify(*case) == jbls.verify(*case) == w
    for case, w in zip(cases[:4], want):
        assert tbls.verify_py(*case) == w
    # e(-pk, H(m)) * e(G1, sig) over the wrong message: false in both
    neg = tbls.g1_negate_serialized(pub)
    g1cat = neg + tbls.g1_serialize(tbls.G1_GEN)
    g2cat = tbls.g2_compress(tbls.hash_to_g2(b"msh")) + sig
    assert port_lib.bls_pairing_product_is_one_serialized(g1cat, g2cat, 2) == 0
    pk, s = tbls.g1_deserialize(pub), tbls.g2_uncompress(sig)
    assert not tbls._pairing_product_is_one(
        [(tbls.E1.neg_pt(pk), tbls.hash_to_g2(b"msh")), (tbls.G1_GEN, s)])
    g2good = tbls.g2_compress(tbls.hash_to_g2(b"msg")) + sig
    assert port_lib.bls_pairing_product_is_one_serialized(g1cat, g2good, 2) == 1


# -- keys -------------------------------------------------------------------------


def test_keys_addresses_and_registry_equal_jax():
    for secret in (b"k", b"\x01" * 32, b"bls-val-3"):
        tp, jp = tkeys.Bls12381PrivKey.from_secret(secret), jkeys.Bls12381PrivKey.from_secret(secret)
        assert tp.bytes() == jp.bytes()
        assert tp.pub_key().bytes() == jp.pub_key().bytes()
        assert tp.pub_key().address() == jp.pub_key().address()
        assert tp.sign(b"x") == jp.sign(b"x")
        assert tp.pub_key().verify_signature(b"x", tp.sign(b"x"))
        assert not tp.pub_key().verify_signature(b"x", tp.sign(b"x")[:64])
    pub = tkeys.Bls12381PrivKey.from_secret(b"k").pub_key()
    assert tkeys.pub_key_from_type("bls12_381", pub.bytes()) == pub
    assert tkeys.BLS12381_KEY_TYPE == jkeys.BLS12381_KEY_TYPE
    with pytest.raises(ValueError):
        tkeys.Bls12381PubKey(pub.bytes()[:48])
    assert len(tkeys.Bls12381PrivKey.generate().bytes()) == 32


# -- the field, the curve and the G1 kernel's plain version -------------------------


def _field_values(n, seed):
    rng = random.Random(seed)
    return [0, 1, 2, P - 1, P - 2, (P - 1) // 2] + [rng.randrange(P) for _ in range(n - 6)]


def test_fp381_equals_ints_and_jax():
    xs, ys = _field_values(8, 1), _field_values(8, 2)[::-1]
    a, b = tfp.pack(xs), tfp.pack(ys)
    assert tfp.unpack(tfp.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert tfp.unpack(tfp.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert tfp.unpack(tfp.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert tfp.unpack(tfp.neg(a)) == [-x % P for x in xs]
    assert tfp.unpack(tfp.mul_small(tfp.sub(a, b), 12)) == [
        12 * (x - y) % P for x, y in zip(xs, ys)]
    assert jfp.unpack(jfp.mul(jfp.pack(xs), jfp.pack(ys))) == tfp.unpack(tfp.mul(a, b))
    assert tfp.NLIMBS == 26 and tfp.R_INT == 1 << 416 and tfp.P_INT == jfp.P_INT


def test_f2_ops_equal_ints_and_jax():
    xs = list(zip(_field_values(8, 5), _field_values(8, 6)[::-1]))
    ys = list(zip(_field_values(8, 7)[::-1], _field_values(8, 8)))
    x, y = tfp.f2_pack(xs), tfp.f2_pack(ys)
    jx, jy = jfp.f2_pack(xs), jfp.f2_pack(ys)
    ints = {
        "f2_add": [((a + c) % P, (b + d) % P) for (a, b), (c, d) in zip(xs, ys)],
        "f2_sub": [((a - c) % P, (b - d) % P) for (a, b), (c, d) in zip(xs, ys)],
        "f2_mul": [((a * c - b * d) % P, (a * d + b * c) % P)
                   for (a, b), (c, d) in zip(xs, ys)],
        "f2_square": [((a * a - b * b) % P, 2 * a * b % P) for a, b in xs],
        "f2_neg": [(-a % P, -b % P) for a, b in xs],
    }
    for name, want in ints.items():
        args = ((x, y), (jx, jy)) if name in ("f2_add", "f2_sub", "f2_mul") else ((x,), (jx,))
        got = tfp.f2_unpack(getattr(tfp, name)(*args[0]))
        assert got == jfp.f2_unpack(getattr(jfp, name)(*args[1])) == want, name
    assert tfp.f2_unpack(tfp.f2_mul_small(x, 12)) == jfp.f2_unpack(
        jfp.f2_mul_small(jx, 12)) == [(12 * a % P, 12 * b % P) for a, b in xs]


def _points(n, seed):
    rng = random.Random(seed)
    return [jbls.E1.affine(jbls.E1.mul_scalar(jbls.G1_GEN, rng.randrange(1, jbls.R)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_ladder():
    """The JAX ``g1.scalar_mul``, called eagerly on packed points, on 8
    lanes at 12 bits (an identity lane and scalars 0 and 1 among them):
    (points, scalars, bit rows, its output)."""
    pts = _points(7, 3) + [None]
    ks = [random.Random(4).getrandbits(12) for _ in pts]
    ks[1], ks[2] = 0, 1
    jp = jg1.pack_points(pts)
    bits = jg1.pack_scalar_bits(ks, 12, jp.x.v.shape[1])
    return pts, ks, bits, jg1.scalar_mul(jp, jnp.asarray(bits))


def test_scalar_mul_equals_jax_ladder(jax_ladder):
    """The plain ladder (``wcurve.Curve.scalar_mul`` over ``ops.fp381``,
    behind ``bls_g1.batch_scalar_mul_plain`` on raw bytes) and the JAX
    ``g1.scalar_mul``, called eagerly on packed points, give the same
    canonical (X, Y, Z) on 8 lanes at 12 bits (an identity lane and
    scalars 0 and 1 among them)."""
    pts, ks, bits, jout = jax_ladder
    want = list(zip(*(jfp.unpack(c) for c in jout)))
    sc = torch.from_numpy(tg1.scalars_to_bytes(ks, 12).copy())
    assert (tg1.scalar_bits(sc, 12).numpy() == bits).all()
    raw = tg1.batch_scalar_mul_plain(
        torch.from_numpy(tg1.points_to_bytes(pts).copy()), sc, 12)
    assert tg1._coords(raw.numpy()) == want
    assert tg1.affine(raw.numpy()) == jg1.unpack_points(jout)


def test_kernel_host_build_equals_jax_ladder(jax_ladder, tmp_path):
    """The G1 kernel's source built for the host (``csrc/bls_g1.cu``
    without ``__CUDACC__``: its schedule, formulas and field, the group's
    threads in turn) against the JAX ``g1.scalar_mul`` on the same lanes:
    the same points (the kernel's Jacobian representative differs from
    the JAX ladder's projective one, so not the same bytes)."""
    import ctypes
    import shutil
    import subprocess

    from cometbft_tpu_torch.ops import _build

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    lib = tmp_path / "libbls_g1_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
                    "-o", str(lib), str(_build.CSRC_DIR / "bls_g1.cu")],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.bls_g1_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    pts, ks, _, jout = jax_ladder
    raw = tg1.points_to_bytes(pts).copy()
    sc = tg1.scalars_to_bytes(ks, 12).copy()
    out = np.zeros((len(pts), 144), np.uint8)
    assert so.bls_g1_host(raw.ctypes.data, sc.ctypes.data, out.ctypes.data,
                          len(pts), 12) == 0
    jxyz = np.array([[b for c in xyz for b in c.to_bytes(48, "big")]
                     for xyz in zip(*(jfp.unpack(c) for c in jout))], np.uint8)
    assert tg1.points_equal(out, jxyz).all()
    assert tg1.affine(out) == jg1.unpack_points(jout)


def test_batch_scalar_mul_on_the_cpu_equals_oracle():
    pts = _points(5, 5) + [None, jbls.E1.affine(jbls.G1_GEN)]
    ks = [random.Random(6).getrandbits(128) for _ in pts]
    ks[1], ks[2], ks[3] = 0, 1, (1 << 128) - 1
    got = tg1.batch_scalar_mul(pts, ks, device="cpu")
    want = [None if p is None else jbls.E1.affine(jbls.E1.mul_scalar((p[0], p[1], 1), k))
            for p, k in zip(pts, ks)]
    assert got == want
    # the verifier's entry: negated and serialized
    pubs = [tg1.points_to_bytes([p])[0].tobytes() for p in pts[:3]]
    neg = tg1.neg_scaled_pubkeys(pubs, ks[:3], device="cpu")
    assert neg == [tbls.g1_negate_serialized(
        tbls.g1_serialize((w[0], w[1], 1)) if w else tg1.INFINITY) for w in want[:3]]
    assert tg1.batch_scalar_mul([], [], device="cpu") == []
    with pytest.raises(ValueError):
        tg1.batch_scalar_mul(pts[:1], [1 << 16], nbits=16, device="cpu")


def _oracle_sum(pts, ks):
    acc = jbls.E1.infinity()
    for p, k in zip(pts, ks):
        if p is not None:
            acc = jbls.E1.add_pts(acc, jbls.E1.mul_scalar((p[0], p[1], 1), k))
    return jbls.E1.affine(acc)


def test_msm_and_sum_points_on_the_cpu_equal_oracle():
    """``msm`` (the plain products, then ``lane_sum``) and ``sum_points``
    at 7 lanes (padded to 8: the identity, a point and its negation, the
    scalars 0 and 2^128 - 1 among them) against the oracle's sums."""
    pts = _points(5, 9) + [None]
    pts.append((pts[0][0], (P - pts[0][1]) % P))
    ks = [random.Random(10).getrandbits(128) for _ in pts]
    ks[1], ks[2] = 0, (1 << 128) - 1
    assert tg1.msm(pts, ks, device="cpu") == _oracle_sum(pts, ks)
    assert tg1.sum_points(pts, device="cpu") == _oracle_sum(pts, [1] * len(pts))
    assert tg1.sum_points([pts[0], pts[-1]], device="cpu") is None
    assert tg1.sum_points(pts[:1], device="cpu") == pts[0]
    assert tg1.msm([], [], device="cpu") is None and tg1.sum_points([]) is None
    with pytest.raises(ValueError):
        tg1.msm(pts, ks[:2], device="cpu")


def test_host_packing_round_trips():
    """The raw-bytes packing: points as ``g1_serialize`` writes them (0x40
    || 0... for infinity) and back through ``affine``; scalar rows to the
    bit rows of the JAX ``pack_scalar_bits``."""
    pts = _points(3, 7) + [None]
    rows = tg1.points_to_bytes(pts)
    assert [r.tobytes() for r in rows] == [
        tbls.g1_serialize((p[0], p[1], 1)) for p in pts[:3]] + [tg1.INFINITY]
    z = np.array([[0] * 47 + [p is not None] for p in pts], np.uint8)
    assert tg1.affine(np.concatenate([rows, z], 1)) == pts
    ks = [5, 0, (1 << 9) - 1]
    sc = tg1.scalars_to_bytes(ks, 9)
    assert [int.from_bytes(r.tobytes(), "big") for r in sc] == ks
    bits = tg1.scalar_bits(torch.from_numpy(sc.copy()), 9)
    assert (bits.numpy() == jg1.pack_scalar_bits(ks, 9, 3)).all()
    with pytest.raises(ValueError):
        tg1.scalars_to_bytes([1 << 9], 9)


# -- the batch verifier -----------------------------------------------------------


def _triples(n, tamper=()):
    privs = [jkeys.Bls12381PrivKey.from_secret(b"t-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes() for p in privs]
    msgs = [b"bls batch message %d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in tamper:
        sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
    return pubs, msgs, sigs


def _batch_cases():
    pubs, msgs, sigs = _triples(4)
    tampered = _triples(4, tamper=(2,))
    swapped = list(sigs)
    swapped[1], swapped[3] = sigs[3], sigs[1]  # valid points, wrong pairs
    same = [jkeys.Bls12381PrivKey.from_secret(b"r-%d" % i) for i in range(2)]
    return {
        "all_valid": (pubs, msgs, sigs),
        "tampered": tampered,
        "swapped": (pubs, msgs, swapped),
        "malformed": ([pubs[0][:40], pubs[1], pubs[2]], msgs[:3],
                      [sigs[0], sigs[1][:40], sigs[2]]),
        "infinity_pubkey": ([tg1.INFINITY] + pubs[1:3], msgs[:3], sigs[:3]),
        "single": (pubs[:1], msgs[:1], sigs[:1]),
        "repeated_message": ([p.pub_key().bytes() for p in same], [b"same"] * 2,
                             [p.sign(b"same") for p in same]),
    }


@pytest.mark.parametrize("case", sorted(_batch_cases()))
def test_batch_verifier_equals_jax(case):
    pubs, msgs, sigs = _batch_cases()[case]
    key = tkeys.Bls12381PrivKey.from_secret(b"route").pub_key()
    tv = tbatch.create_batch_verifier(key, backend="cpu")
    assert isinstance(tv, tbatch.BlsBatchVerifier) and tv.device == "cpu"
    jv = jbatch.BlsBatchVerifier(backend="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        tv.add(p, m, s)
        jv.add(p, m, s)
    want = jv.verify()
    assert tv.verify() == want
    if case in ("all_valid", "single", "repeated_message"):
        assert want[0]
    else:
        assert not want[0] and any(want[1])


def test_routing_and_the_cpu_tiers():
    tds.reset()
    pub = tkeys.Bls12381PrivKey.from_secret(b"route").pub_key()
    assert tbatch.supports_batch_verifier(pub)
    bv = tbatch.create_batch_verifier(pub)
    assert isinstance(bv, tbatch.BlsBatchVerifier) and bv.device is None
    assert tbatch.create_batch_verifier(pub, device="cpu").device == "cpu"
    with pytest.raises(ValueError):
        tbatch.create_batch_verifier(pub, backend="tpu")
    pubs, msgs, sigs = _triples(3)
    bv = tbatch.create_batch_verifier(pub, backend="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    assert bv.verify() == (True, [True] * 3)
    assert tds.tier_counts("bls12_381") == {"cuda": (0, 0), "torch": (1, 3),
                                            "host": (0, 0)}


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg1.batch_scalar_mul([None], [1])
    pubs, msgs, sigs = _triples(2)
    bv = tbatch.BlsBatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bv.verify()
    assert len(tsc.get_cache()) == 0


@pytest.fixture
def g1_fault():
    """A G1 fault on the device-runner seam: the runner, which stands in
    for the device, raises for the ``bls_g1`` breaker."""
    def runner(backend, *args):
        assert backend == tbh.BLS_G1
        raise RuntimeError("G1 device fault")

    tbh.reset()
    tds.reset()
    tsup.set_device_runner(runner)
    yield
    tsup.clear_device_runner()
    tbh.reset()


def test_g1_fault_raises_on_a_card(g1_fault, monkeypatch):
    """On a stand-in card (CUDA reported available, the self-check done) a
    G1 call the kernel did not serve raises ``BackendError``: no host
    arithmetic answers for a card, and nothing is cached."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbatch, "_BLS_SELF_CHECKED", {"cuda"})
    pubs, msgs, sigs = _triples(3)
    bv = tbatch.create_batch_verifier(tkeys.Bls12381PubKey(pubs[0]))
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with pytest.raises(tbh.BackendError, match="bls_g1"):
        bv.verify()
    assert len(tsc.get_cache()) == 0
    assert tds.tier_counts("bls12_381") == dict.fromkeys(tds.TIERS, (0, 0))


def test_g1_fault_is_answered_by_the_host_library_on_the_cpu(g1_fault):
    pubs, msgs, sigs = _triples(4, tamper=())
    sigs[0] = sigs[1]  # a valid point, the wrong pair: attribution runs
    bv = tbatch.create_batch_verifier(tkeys.Bls12381PubKey(pubs[0]), backend="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    assert bv.verify() == (False, [False, True, True, True])
    assert tds.tier_counts("bls12_381") == {"cuda": (0, 0), "torch": (0, 0),
                                            "host": (1, 4)}
    assert tbh.registry().breaker(tbh.BLS_G1).stats()["failures_total"] == 1


def test_failed_self_check_refuses_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbatch, "_BLS_SELF_CHECKED", set())
    monkeypatch.setattr(tg1, "batch_scalar_mul",
                        lambda pts, ks, nbits=128, device=None: [None] * len(pts))
    with pytest.raises(tbatch.SelfCheckError, match="BLS12-381"):
        tbatch.bls_self_check()
    pubs, msgs, sigs = _triples(2)
    bv = tbatch.create_batch_verifier(tkeys.Bls12381PubKey(pubs[0]))
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(p, m, s)
    with pytest.raises(tbatch.SelfCheckError):
        bv.verify()
    assert len(tsc.get_cache()) == 0


# -- types and the commit ---------------------------------------------------------


def _jax_commit(privs, bad=(), swap=(), nil=(), absent=()):
    vals = ValidatorSet([Validator(p.pub_key(), 10 + i) for i, p in enumerate(privs)])
    by_addr = {p.pub_key().address(): p for p in privs}
    block_id = BlockID(hashlib.sha256(b"bls block").digest(),
                       PartSetHeader(2, hashlib.sha256(b"bls parts").digest()))
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
        # a swapped lane signs its neighbour's bytes: a valid point, wrong
        msg = commit.vote_sign_bytes(CHAIN, (i + 1) % len(privs) if i in swap else i)
        sig = by_addr[v.address].sign(msg)
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        cs.signature = sig
    return vals, commit, block_id


BLS_CASES = {
    "valid": dict(nil=(2,)),
    "bad_sig": dict(bad=(3, 5)),
    "wrong_bytes": dict(swap=(1, 4)),
    "not_enough_power": dict(absent=(0, 1, 2, 4)),
}


def _outcome(fn):
    try:
        fn()
    except (jval.CommitVerificationError, tval.CommitVerificationError) as e:
        return (type(e).__name__, str(e), getattr(e, "index", None),
                getattr(e, "got", None), getattr(e, "needed", None))
    return None


@pytest.fixture(scope="module")
def bls_commits():
    privs = [jkeys.Bls12381PrivKey.from_secret(b"val-%d" % i) for i in range(6)]
    out = {}
    for name, kw in BLS_CASES.items():
        jv, jc, jb = _jax_commit(privs, **kw)
        out[name] = ((jv, jc, jb), (convert.validator_set_from(jv),
                                    convert.commit_from(jc), convert.block_id_from(jb)))
    return out


@pytest.mark.parametrize("fn", ["verify_commit", "verify_commit_light"])
@pytest.mark.parametrize("case", sorted(BLS_CASES))
def test_bls_commit_errors_equal_jax(bls_commits, case, fn):
    """The port on the CPU (``device="cpu"``: the plain G1 ladder and the
    host library) against the JAX package's host path (``backend="cpu"``:
    its native G1)."""
    (jv, jc, jb), (tv, tc, tb) = bls_commits[case]
    assert tval._should_batch(tv, tc) == jval._should_batch(jv, jc)
    want = _outcome(lambda: getattr(jval, fn)(CHAIN, jv, jb, HEIGHT, jc, backend="cpu"))
    got = _outcome(lambda: getattr(tval, fn)(CHAIN, tv, tb, HEIGHT, tc, device="cpu"))
    assert got == want
    if fn == "verify_commit":
        expect = {"valid": None, "bad_sig": 3, "wrong_bytes": 1,
                  "not_enough_power": "NotEnoughPowerError"}[case]
        if expect is None:
            assert want is None
        elif isinstance(expect, int):
            assert want[0] == "InvalidSignatureError" and want[2] == expect
        else:
            assert want[0] == expect


def test_validator_sets_of_bls_keys(bls_commits):
    (jv, _, _), (tv, tc, _) = bls_commits["valid"]
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert all(isinstance(v.pub_key, tkeys.Bls12381PubKey) for v in tv.validators)
    assert [v.pub_key.bytes() for v in tv.validators] == [
        v.pub_key.bytes() for v in jv.validators]
    assert tval._should_batch(tv, tc)


def test_vote_verify_with_a_bls_key():
    from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.basic import BlockID as TBlockID
    from cometbft_tpu_torch.types.basic import Timestamp as TTimestamp
    from cometbft_tpu_torch.types.vote import Vote

    tds.reset()
    priv = tkeys.Bls12381PrivKey.from_secret(b"gossip")
    vote = Vote(PRECOMMIT_TYPE, 3, 0, TBlockID(), TTimestamp(5, 6),
                priv.pub_key().address(), 0)
    vote.signature = priv.sign(vote.sign_bytes(CHAIN))
    assert vote.verify(CHAIN, priv.pub_key())
    assert tsc.get_cache().get(priv.pub_key().bytes(), vote.sign_bytes(CHAIN),
                               vote.signature) is True
    vote.signature = priv.sign(b"other bytes")
    assert not vote.verify(CHAIN, priv.pub_key())
    assert tds.snapshot()["dispatches"] == 0
