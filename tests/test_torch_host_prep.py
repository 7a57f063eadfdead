"""The port's host library (``cometbft_tpu_torch/csrc/host_prep.cpp``) on
the CPU: it is host code, so the real library is built with ``g++`` and
run here.  Byte for byte against the Python references and the JAX
package's own C++ path:

- ``ed25519_pack`` through ``prepare_batch``, against ``_pack_plain`` and
  the JAX package's ``prepare_batch``, on seeded triples that cover the
  SHA-512 padding edges (the 64-byte R||A prefix puts message lengths
  47/48 and 175/176 on either side of a block boundary), s in {0, L-1, L,
  2^256-1}, small-order and non-canonical points and wrong lengths;
- the mod-L reduction on digests that are multiples of L (h = 0 mod L);
- ``sha512`` against ``hashlib`` at every length 0-300;
- ``commit_sign_bytes`` through ``all_vote_sign_bytes``, against the
  per-index encoder and the JAX package, with COMMIT, NIL and ABSENT
  flags, zero and negative timestamps, and the light subset;
- a broken compiler makes every caller raise: no Python fallback.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import verify as jov
from cometbft_tpu.types.basic import BlockID, PartSetHeader, Timestamp
from cometbft_tpu_torch import convert, native
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import verify as tov

from test_torch_commit import CHAIN, _jax_commit
from test_torch_verify import edge_set, random_mix


def _edge_triples():
    """80 seeded triples: the verify tests' mixes, every SHA-512 padding
    edge, and the s edges."""
    pubs, msgs, sigs = random_mix(16, seed=31)
    for p, m, s in zip(*edge_set()):
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    rng = np.random.default_rng(7)
    lengths = (0, 1, 46, 47, 48, 49, 63, 64, 111, 112, 174, 175, 176, 177,
               239, 240, 255, 256, 300, 1000)
    for n in lengths:
        sk = rng.bytes(32)
        msg = rng.bytes(n)
        pubs.append(ref.pubkey_from_seed(sk))
        msgs.append(msg)
        sigs.append(ref.sign(sk, msg))
    for i, s in enumerate((0, 1, ref.L - 1, ref.L, ref.L + 1, 2**253,
                           2**255 - 19, 2**256 - 1)):
        sk = rng.bytes(32)
        msg = b"s edge %d" % i
        sig = ref.sign(sk, msg)
        pubs.append(ref.pubkey_from_seed(sk))
        msgs.append(msg)
        sigs.append(sig[:32] + s.to_bytes(32, "little"))
    # wrong lengths between valid entries: the packer sees a gap
    pubs += [b"\x01" * 31, pubs[40], b"", pubs[41]]
    msgs += [b"a", msgs[40], b"c", msgs[41]]
    sigs += [sigs[40], sigs[40][:63], sigs[41], sigs[41] + b"\x00"]
    # R and A at their largest encodings, and a message of zeros
    pubs += [b"\xff" * 32, bytes(32)]
    msgs += [bytes(48), bytes(175)]
    sigs += [b"\xff" * 32 + bytes(32), bytes(64)]
    return pubs, msgs, sigs


@pytest.fixture(scope="module")
def triples():
    out = _edge_triples()
    assert len(out[0]) >= 64
    return out


@pytest.mark.parametrize("min_bucket", [32, 128])
def test_pack_matches_plain_and_jax(triples, min_bucket):
    pubs, msgs, sigs = triples
    got, n, structural = tov.prepare_batch(pubs, msgs, sigs, min_bucket)
    lanes = got["s_ok"].shape[0]
    plain, plain_struct = tov._pack_plain(pubs, msgs, sigs, lanes)
    jax_arrays, jn, jax_struct = jov.prepare_batch(pubs, msgs, sigs, min_bucket)
    assert n == jn == len(pubs)
    np.testing.assert_array_equal(structural, plain_struct)
    np.testing.assert_array_equal(structural, jax_struct)
    assert sorted(got) == sorted(plain) == sorted(jax_arrays)
    for k in plain:
        assert got[k].dtype == plain[k].dtype == jax_arrays[k].dtype
        assert got[k].tobytes() == plain[k].tobytes(), k
        assert got[k].tobytes() == jax_arrays[k].tobytes(), k


def test_pack_s_edges(triples):
    """s >= L comes out as zero bytes with s_ok False; s < L as it is."""
    pubs, msgs, sigs = triples
    arrays, _, structural = tov.prepare_batch(pubs, msgs, sigs, 32)
    seen = set()
    for i, sig in enumerate(sigs):
        if not structural[i]:
            assert not arrays["s_ok"][i] and not arrays["s_bytes"][i].any()
            continue
        s = int.from_bytes(sig[32:], "little")
        assert bool(arrays["s_ok"][i]) == (s < ref.L)
        want = sig[32:] if s < ref.L else bytes(32)
        assert arrays["s_bytes"][i].tobytes() == want
        seen.add(s < ref.L)
    assert seen == {True, False}


def test_pack_host_tensors_are_what_prepare_batch_returns(triples):
    pubs, msgs, sigs = (x[:20] for x in triples)
    host, structural = tov._pack(pubs, msgs, sigs, 32)
    arrays, _, struct2 = tov.prepare_batch(pubs, msgs, sigs, 32)
    assert host["s_ok"].dtype == torch.bool and host["a_bytes"].dtype == torch.uint8
    np.testing.assert_array_equal(structural, struct2)
    for k, v in host.items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])


@pytest.fixture(scope="module")
def mod_l_harness(tmp_path_factory):
    """The library's mod-L reduction, exposed by a test harness that
    includes the source as it is."""
    d = tmp_path_factory.mktemp("mod_l")
    src = d / "harness.cpp"
    src.write_text(
        f'#include "{_build.CSRC_DIR / "host_prep.cpp"}"\n'
        'extern "C" void reduce_mod_l(const uint8_t* h, uint8_t* out) {\n'
        "    bn5 r;\n    bn_from_le64(r, h);\n    bn_to_le32(r, out);\n}\n"
    )
    so = d / "harness.so"
    subprocess.run([_build.gxx(), *_build.GXX_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.reduce_mod_l.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.reduce_mod_l.restype = None
    return lib


def test_digest_mod_l_edges(mod_l_harness):
    """h mod L for 64-byte digests on and around multiples of L: a digest
    that is 0 mod L reduces to 0 (the packer's m is then 0)."""
    rng = np.random.default_rng(11)
    values = [0, 1, ref.L - 1, ref.L, ref.L + 1, 2 * ref.L, 2**252, 2**253,
              2**256 - 1, 2**512 - 1]
    top = (2**512 - 1) // ref.L
    for k in [2, 3, 255, 256, 2**8 - 1, top, top - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(8)
    ]:
        values += [k * ref.L - 1, k * ref.L, k * ref.L + 1]
    values += [int.from_bytes(rng.bytes(64), "little") for _ in range(16)]
    out = ctypes.create_string_buffer(32)
    for v in values:
        v %= 2**512
        mod_l_harness.reduce_mod_l(v.to_bytes(64, "little"), out)
        assert int.from_bytes(out.raw, "little") == v % ref.L, hex(v)


def test_sha512_matches_hashlib():
    rng = np.random.default_rng(5)
    data = rng.bytes(300)
    for n in range(301):
        assert native.sha512(data[:n]) == hashlib.sha512(data[:n]).digest(), n


def _commit_variant(variant):
    """A 16-validator commit (JAX package objects) with COMMIT, NIL and
    ABSENT flags; ``variant`` changes its block id, height and round."""
    vals, commit, block_id = _jax_commit(absent=(2, 9), nil=(4, 11))
    commit.signatures[5].timestamp = Timestamp(0, 0)  # zero: omitted
    commit.signatures[6].timestamp = Timestamp(-5, 7)  # before 1970
    commit.signatures[7].timestamp = Timestamp(2**40, 999_999_999)
    if variant == "hash_only_block_id":
        commit.block_id = BlockID(hashlib.sha256(b"h").digest(), PartSetHeader())
    elif variant == "zero_height_round":
        commit.height, commit.round_ = 0, 0
    elif variant == "large_height":
        commit.height, commit.round_ = 2**62 + 3, 2**31
    return commit


@pytest.mark.parametrize(
    "variant", ["plain", "hash_only_block_id", "zero_height_round", "large_height"]
)
@pytest.mark.parametrize(
    "subset", [None, [0, 1, 3, 4, 5, 6, 7, 8, 10], [15], [9, 2, 4]],
    ids=["all", "light", "one", "unordered"],
)
def test_sign_bytes_match_encoder_and_jax(variant, subset):
    jc = _commit_variant(variant)
    tc = convert.commit_from(jc)
    got = tc.all_vote_sign_bytes(CHAIN, subset)
    idxs = range(tc.size()) if subset is None else subset
    assert got == [tc.vote_sign_bytes(CHAIN, i) for i in idxs]
    assert got == jc.all_vote_sign_bytes(CHAIN, subset)
    assert got == [jc.vote_sign_bytes(CHAIN, i) for i in idxs]


def test_sign_bytes_chain_ids():
    tc = convert.commit_from(_commit_variant("plain"))
    for chain_id in ("", "x", "c" * 50, "ünïcode-chain"):
        assert tc.all_vote_sign_bytes(chain_id) == [
            tc.vote_sign_bytes(chain_id, i) for i in range(tc.size())
        ]
    assert tc.all_vote_sign_bytes(CHAIN, []) == []
    with pytest.raises(RuntimeError, match="does not fit"):
        tc.all_vote_sign_bytes("c" * 300)


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path, request):
    """A fresh build directory and a ``g++`` that fails (or none at all):
    the host library cannot be built."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if request.param == "fails":
        fake = bindir / "g++"
        fake.write_text("#!/bin/sh\necho 'g++: broken on purpose' >&2\nexit 1\n")
        fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    native.lib.cache_clear()
    _build.load.cache_clear()
    yield "native build failed" if request.param == "fails" else "g\\+\\+ not found"
    native.lib.cache_clear()
    _build.load.cache_clear()


@pytest.mark.parametrize("broken_compiler", ["fails", "missing"], indirect=True)
def test_broken_compiler_raises_everywhere(broken_compiler, monkeypatch):
    pubs, msgs, sigs = edge_set()
    with pytest.raises(RuntimeError, match=broken_compiler):
        tov.prepare_batch(pubs, msgs, sigs)
    with pytest.raises(RuntimeError, match=broken_compiler):
        tov.verify_batch(pubs, msgs, sigs, device="cpu")
    tc = convert.commit_from(_commit_variant("plain"))
    with pytest.raises(RuntimeError, match=broken_compiler):
        tc.all_vote_sign_bytes(CHAIN)
    with pytest.raises(RuntimeError, match=broken_compiler):
        native.sha512(b"abc")
    # the card's path packs before it touches the card, and raises the same
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match=broken_compiler):
        tov.verify_batch(pubs, msgs, sigs)
    assert not os.path.exists(_build.lib_path(native.NAME))
