"""The transport plane's hand-written kernels
(cometbft_tpu_torch/csrc/chacha20_poly1305.cu, csrc/x25519_ladder.cu).

Without a card the kernels cannot run, but both sources also build for the
host (no ``__CUDACC__``): the AEAD build runs each CUDA block's threads in
turn between its barriers and each frame's warp-wide Poly1305 with the
warp's lanes held in arrays (a shuffle reads the array), the ladder build
each block's quads in lockstep the same way.  So their arithmetic is held
here against ``aead_ref`` (RFC 8439 and 7748), Python integers and the
plain PyTorch versions: at every MAC block count, at the largest clamped
r, on an h that lies in [p, 2^130) before the reduction (the host build
also fails a call whose limbs break their stated bounds), with tampered
inputs and at the lane counts around a block; and their op tallies
(``-DAEAD_TALLY``, ``-DX25519_TALLY``) against the wrappers' counts.  The
tests marked ``cuda`` run the kernels against their plain versions and the
entry points on the card, and skip where there is none.
"""

import ctypes
import hashlib
import os
import socket
import threading

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import aead_ref
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import chacha_aead as ca
from cometbft_tpu_torch.ops import cuda_aead
from cometbft_tpu_torch.ops import cuda_x25519
from cometbft_tpu_torch.ops import x25519_ladder as xl

from test_torch_cuda_verify import host_build

P = 2**255 - 19

# RFC 7748 5.2 and 6.1
RFC7748 = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]
ALICE_PRIV = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
ALICE_PUB = bytes.fromhex("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
BOB_PRIV = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
BOB_PUB = bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
SHARED = bytes.fromhex("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")

# RFC 8439 2.8.2's key, nonce and plaintext (transport frames carry empty
# AAD; the vector's ciphertext does not depend on the AAD, its tag does)
RFC8439_KEY = bytes(range(0x80, 0xA0))
RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
RFC8439_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
              b"only one tip for the future, sunscreen would be it.")

EDGE_LENS = (0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1023, 1024, 2047, 2048)


def vector_pairs():
    """(scalar, u) pairs holding the RFC vectors, u with bit 255 set, u >=
    p and the low-order points 0 and 1, with the reference's answers."""
    rng = np.random.default_rng(31)
    pairs = [(bytes.fromhex(s), bytes.fromhex(u)) for s, u, _ in RFC7748]
    pairs += [(ALICE_PRIV, xl.BASE_U), (BOB_PRIV, ALICE_PUB)]
    u_hi = bytearray(rng.bytes(32))
    u_hi[31] |= 0x80
    pairs += [(rng.bytes(32), bytes(u_hi)),
              (rng.bytes(32), (P + 5).to_bytes(32, "little")),
              (rng.bytes(32), bytes(32)),
              (rng.bytes(32), (1).to_bytes(32, "little"))]
    return pairs


AEAD_SRC = _build.CSRC_DIR / "chacha20_poly1305.cu"
LADDER_SRC = _build.CSRC_DIR / "x25519_ladder.cu"
LANE_COUNTS = (1, 7, 8, 9, 33, 63, 64, 65)


@pytest.fixture(scope="module")
def aead_lib(tmp_path_factory):
    lib = host_build(tmp_path_factory, AEAD_SRC, "-DAEAD_TALLY")
    lib.chacha20_poly1305_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    lib.chacha20_poly1305_host.restype = ctypes.c_int
    lib.chacha20_poly1305_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    lib.chacha20_poly1305_levels.restype = ctypes.c_longlong
    lib.poly1305_warp_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.poly1305_warp_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def ladder_lib(tmp_path_factory):
    lib = host_build(tmp_path_factory, LADDER_SRC, "-DX25519_TALLY",
                     f"-I{_build.CSRC_DIR}")
    lib.x25519_ladder_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.x25519_ladder_host.restype = ctypes.c_int
    lib.x25519_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 3
    return lib


def _tally(lib, fn, k):
    vals = [ctypes.c_longlong() for _ in range(k)]
    getattr(lib, fn)(*map(ctypes.byref, vals))
    return [v.value for v in vals]


def _aead_host(lib, packed, seal):
    key, nonce, data, nbytes = (np.ascontiguousarray(a) for a in packed)
    out = np.zeros_like(data)
    tag = np.zeros((key.shape[0], 4), np.int32)
    rc = lib.chacha20_poly1305_host(key.ctypes.data, nonce.ctypes.data,
                                    data.ctypes.data, nbytes.ctypes.data,
                                    data.shape[0], data.shape[1], int(seal),
                                    out.ctypes.data, tag.ctypes.data)
    return rc, out, tag


def _ladder_host(lib, scalars, us):
    out = np.zeros_like(scalars)
    rc = lib.x25519_ladder_host(scalars.ctypes.data, us.ctypes.data,
                                scalars.shape[0], out.ctypes.data)
    assert rc == 0
    return out


def _frames(seed, lens):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(32), rng.bytes(12), rng.bytes(n)) for n in lens]


# -- the AEAD's host build ------------------------------------------------------


@pytest.mark.parametrize("op", ["seal", "open"])
def test_aead_host_build_equals_reference_and_plain(aead_lib, op):
    lens = list(EDGE_LENS) + [int(n) for n in np.random.default_rng(3).integers(0, 2049, 17)]
    frames = _frames(4, lens)
    lanes, blocks = ca._bucket_shape(frames)
    packed = ca._pack_frames(frames, lanes, blocks)
    rc, out, tag = _aead_host(aead_lib, packed, op == "seal")
    assert rc == 0
    assert ca._unpack_outputs(out, tag, frames) == ca._host_pass(op, frames)
    pout, ptag = ca.aead_core(*map(torch.from_numpy, packed), op == "seal")
    assert np.array_equal(pout.numpy(), out) and np.array_equal(ptag.numpy(), tag)
    ops, products = _tally(aead_lib, "chacha20_poly1305_tally", 2)
    assert (ops, products) == cuda_aead.kernel_work(packed[3])
    assert aead_lib.chacha20_poly1305_levels() == sum(map(cuda_aead.mac_levels, lens))


def _mac_block_lengths():
    """A length for every MAC block count k = 1..129 (0, then one in
    (16 (k - 2), 16 (k - 1)], full and partial blocks in turn), and the 16-
    and 64-byte edges."""
    lens = [0] + [16 * (k - 1) - (k * 7) % 16 * (k % 2) for k in range(2, 130)]
    return lens + [1, 15, 17, 31, 33, 63, 65, 127, 129, 1023, 1025, 2047]


@pytest.mark.parametrize("op", ["seal", "open"])
def test_aead_host_build_every_mac_block_count(aead_lib, op):
    """The warp-wide MAC at every block count 1-129: every T and m of its
    padded interleave, seal and open, equal to the plain version and
    aead_ref, with every limb bound held."""
    lens = _mac_block_lengths()
    assert sorted({-(-n // 16) + 1 for n in lens}) == list(range(1, 130))
    frames = _frames(11, lens)
    lanes, blocks = ca._bucket_shape(frames)
    packed = ca._pack_frames(frames, lanes, blocks)
    rc, out, tag = _aead_host(aead_lib, packed, op == "seal")
    assert rc == 0
    assert ca._unpack_outputs(out, tag, frames) == ca._host_pass(op, frames)
    pout, ptag = ca.aead_core(*map(torch.from_numpy, packed), op == "seal")
    assert np.array_equal(pout.numpy(), out) and np.array_equal(ptag.numpy(), tag)
    _tally(aead_lib, "chacha20_poly1305_tally", 2)
    aead_lib.chacha20_poly1305_levels()


P1305 = 2**130 - 5


def _poly_warp(lib, otk: bytes, msg: bytes):
    """The host build's warp-wide Poly1305 of ``msg`` (the AEAD's MAC
    input, empty AAD) under the one-time key ``otk``: (rc, tag, h before
    the mod-p select)."""
    words = np.frombuffer(msg + bytes(-len(msg) % 16 + 16), dtype="<u4").copy()
    key = np.frombuffer(otk, dtype="<u4").copy()
    tag, pre = np.zeros(4, np.uint32), np.zeros(5, np.uint32)
    rc = lib.poly1305_warp_host(key.ctypes.data, words.ctypes.data, len(msg),
                                tag.ctypes.data, pre.ctypes.data)
    return rc, tag.tobytes(), sum(int(x) << (26 * i) for i, x in enumerate(pre))


def _ref_mac(otk: bytes, msg: bytes) -> bytes:
    """aead_ref's Poly1305 of the AEAD's MAC input (empty AAD)."""
    return aead_ref._poly1305(otk, msg + aead_ref._pad16(msg) + bytes(8)
                              + len(msg).to_bytes(8, "little"))


def test_poly1305_warp_at_the_largest_clamped_r(aead_lib):
    """r = 0x0ffffffc0ffffffc0ffffffc0fffffff (every bit clamping leaves)
    and all-ones messages: the largest limbs every step can see."""
    otk = b"\xff" * 16 + os.urandom(16)
    for n in (0, 1, 16, 17, 63, 64, 65, 496, 497, 1024, 1040, 2047, 2048):
        msg = b"\xff" * n
        rc, tag, _ = _poly_warp(aead_lib, otk, msg)
        assert rc == 0 and tag == _ref_mac(otk, msg), n
    _tally(aead_lib, "chacha20_poly1305_tally", 2)
    aead_lib.chacha20_poly1305_levels()


def test_poly1305_warp_reduces_an_h_in_p_to_2_130(aead_lib):
    """r = 1 and two message blocks m1, m2 chosen so that h = c1 + c2 +
    c3 (the length block) = p + v, v = 0..4: the warp's sum before the
    reduction lies in [p, 2^130) and the g = h + 5 - 2^130 select must
    take it to v."""
    otk = (1).to_bytes(16, "little") + os.urandom(16)
    s = int.from_bytes(otk[16:], "little")
    for v in range(5):
        m1 = 2**127
        m2 = P1305 + v - 3 * 2**128 - (32 << 64) - m1
        msg = m1.to_bytes(16, "little") + m2.to_bytes(16, "little")
        rc, tag, pre = _poly_warp(aead_lib, otk, msg)
        assert rc == 0 and P1305 <= pre < 2**130 and pre == P1305 + v
        assert tag == _ref_mac(otk, msg) == ((v + s) % 2**128).to_bytes(16, "little")
    _tally(aead_lib, "chacha20_poly1305_tally", 2)
    aead_lib.chacha20_poly1305_levels()


def test_poly1305_warp_carries_a_sum_past_2_130(aead_lib):
    """r = 1, m1 = 2^128 - 1 and m2 = 2^128 - 2^27: the lanes' sum has a
    carry out of limb 4 that leaves limb 0 at 2^26 + 4 after one carry
    pass, with limb 1's low bit set, so a single pass packs a wrong tag."""
    otk = (1).to_bytes(16, "little") + os.urandom(16)
    msg = (2**128 - 1).to_bytes(16, "little") + (2**128 - 2**27).to_bytes(16, "little")
    rc, tag, pre = _poly_warp(aead_lib, otk, msg)
    h = (2**128 - 1 + 2**128 - 2**27 + (32 << 64) + 3 * 2**128) % P1305
    assert rc == 0 and pre % P1305 == h and pre < 2**130
    assert tag == _ref_mac(otk, msg)
    _tally(aead_lib, "chacha20_poly1305_tally", 2)
    aead_lib.chacha20_poly1305_levels()


def test_aead_host_build_rfc8439_and_tampering(aead_lib):
    key, nonce = bytes(range(0x80, 0xA0)), bytes.fromhex("070000004041424344454647")
    pt = os.urandom(114)
    frames = [(key, nonce, pt)] + _frames(5, (64, 1024, 0))
    sealed = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, d, b"") for k, n, d in frames]
    packed = ca._pack_frames(frames, 8, 16)
    _, out, tag = _aead_host(aead_lib, packed, True)
    assert [c + t for c, t in ca._unpack_outputs(out, tag, frames)] == sealed
    # open a tampered ciphertext: its tag no longer matches, the others do
    opened = [(k, n, s[:-16]) for (k, n, _), s in zip(frames, sealed)]
    opened[1] = (opened[1][0], opened[1][1], bytes([opened[1][2][0] ^ 1]) + opened[1][2][1:])
    _, out, tag = _aead_host(aead_lib, ca._pack_frames(opened, 8, 16), False)
    res = ca._unpack_outputs(out, tag, opened)
    assert [r[1] == s[-16:] for r, s in zip(res, sealed)] == [True, False, True, True]
    assert res[0][0] == pt and res[2][0] == frames[2][2]
    _tally(aead_lib, "chacha20_poly1305_tally", 2)


def test_aead_host_build_refuses_lengths_past_its_blocks(aead_lib):
    packed = list(ca._pack_frames(_frames(6, (64,)), 8, 1))
    packed[3] = packed[3].copy()
    packed[3][0] = 65
    assert _aead_host(aead_lib, packed, True)[0] == 1


def test_aead_work_counts():
    assert cuda_aead.needed_work([0]) == (976, 25)
    assert cuda_aead.needed_work([1024]) == (976 + 16 * 992, 65 * 25)
    assert cuda_aead.needed_work([65]) == (976 + 2 * 992, 6 * 25)


def test_aead_mac_shape_and_kernel_work():
    """T, m and the dependent multiply levels of the warp-wide MAC, and
    the products its lanes compute (scan and Horner)."""
    assert [cuda_aead.mac_shape(n) for n in (0, 1, 16, 17, 48, 49, 1024, 2048)] == \
        [(1, 1), (2, 1), (2, 1), (4, 1), (4, 1), (8, 1), (32, 3), (32, 5)]
    assert [cuda_aead.mac_levels(n) for n in (0, 17, 1024, 2048)] == [1, 3, 8, 10]
    # 1 KiB: scan 31 + 30 + 28 + 24 + 16 products, Horner 32 lanes x 3
    assert cuda_aead.kernel_work([1024]) == (976 + 16 * 992, (129 + 96) * 25)
    assert cuda_aead.kernel_work([0]) == (976, 25)


def test_aead_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    frames = _frames(7, (10, 200))
    packed = [torch.from_numpy(a) for a in ca._pack_frames(frames, 8, 4)]
    before = cuda_aead.launches
    out, tag = cuda_aead.aead(*packed, seal=True)
    assert cuda_aead.launches == before
    want = ca.aead_core(*packed, seal=True)
    assert torch.equal(out, want[0]) and torch.equal(tag, want[1])
    with pytest.raises(ValueError):
        cuda_aead.aead(packed[0].long(), *packed[1:], seal=True)
    with pytest.raises(ValueError):
        cuda_aead.aead(*packed[:2], packed[2][:, :4], packed[3], seal=True)
    bad = packed[3].clone()
    bad[0] = 4 * 64 + 1
    with pytest.raises(ValueError):
        cuda_aead.aead(*packed[:3], bad, seal=True)


# -- the ladder's host build ------------------------------------------------------


def _ladder_int(k: int, u: int) -> int:
    """RFC 7748's ladder on Python integers (the scalar clamped)."""
    x1, x2, z2, x3, z3, swap = u % P, 1, 0, u % P, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b, c, d = x2 + z2, x2 - z2, x3 + z3, x3 - z3
        aa, bb, da, cb = a * a, b * b, d * a, c * b
        e = aa - bb
        x3, z3 = (da + cb) ** 2 % P, x1 * (da - cb) ** 2 % P
        x2, z2 = aa * bb % P, e * (aa + 121665 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def test_ladder_host_build_equals_reference_ints_and_plain(ladder_lib):
    pairs = vector_pairs() + [(os.urandom(32), os.urandom(32)) for _ in range(6)]
    scalars, us = xl._pack_pairs(pairs, 16)
    out = _ladder_host(ladder_lib, scalars, us)
    got = [out[i].tobytes() for i in range(len(pairs))]
    assert got == xl.host_exchange(pairs)
    for (s, u), g in zip(pairs, got):
        k = int.from_bytes(xl.clamp(s), "little")
        want = _ladder_int(k, int.from_bytes(u, "little") & ((1 << 255) - 1))
        assert g == want.to_bytes(32, "little")
    assert got[:2] == [bytes.fromhex(w) for _, _, w in RFC7748] and got[3] == SHARED
    plain = xl.ladder_plain(torch.from_numpy(scalars), torch.from_numpy(us)).numpy()
    assert np.array_equal(plain, out)
    muls, squares, smalls = _tally(ladder_lib, "x25519_tally", 3)
    assert (muls, squares, smalls) == (16 * cuda_x25519.KERNEL_MULS_PER_LANE,
                                       16 * cuda_x25519.KERNEL_SQUARES_PER_LANE,
                                       16 * cuda_x25519.KERNEL_SMALLS_PER_LANE)
    assert cuda_x25519.WIDE_PRODUCTS_PER_LANE == 201320
    assert cuda_x25519.KERNEL_PRODUCTS_PER_LANE == 247220
    assert (cuda_x25519.DEPENDENT_OPS_PER_LANE,
            cuda_x25519.ONE_THREAD_DEPENDENT_OPS_PER_LANE) == (1286, 2816)


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_ladder_host_build_lane_counts(ladder_lib, n):
    rng = np.random.default_rng(n)
    pairs = [(rng.bytes(32), rng.bytes(32)) for _ in range(n)]
    scalars, us = xl._pack_pairs(pairs, n)
    out = _ladder_host(ladder_lib, scalars, us)
    assert [out[i].tobytes() for i in range(n)] == xl.host_exchange(pairs)
    # padding quads (past n in the last block) run but are not counted
    assert _tally(ladder_lib, "x25519_tally", 3) == [
        n * cuda_x25519.KERNEL_MULS_PER_LANE, n * cuda_x25519.KERNEL_SQUARES_PER_LANE,
        n * cuda_x25519.KERNEL_SMALLS_PER_LANE]


def test_ladder_edge_u_values(ladder_lib):
    """u >= p (2^255 - 19 .. 2^255 - 1), with bit 255 set, and the
    low-order points 0, 1 and p - 1 (zero output for 0 and 1)."""
    us_int = [P, P + 1, P + 18, 2**255 - 1, 2**256 - 1, 0, 1, P - 1]
    pairs = [(os.urandom(32), u.to_bytes(32, "little")) for u in us_int]
    scalars, us = xl._pack_pairs(pairs, 8)
    out = _ladder_host(ladder_lib, scalars, us)
    got = [out[i].tobytes() for i in range(8)]
    assert got == xl.host_exchange(pairs)
    assert got[5] == got[6] == bytes(32)
    _tally(ladder_lib, "x25519_tally", 3)


def test_ladder_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    pairs = vector_pairs()[:2]
    scalars, us = (torch.from_numpy(a) for a in xl._pack_pairs(pairs, 2))
    before = cuda_x25519.launches
    out = cuda_x25519.ladder(scalars, us)
    assert cuda_x25519.launches == before
    assert [out[i].numpy().tobytes() for i in range(2)] == [bytes.fromhex(w) for _, _, w in RFC7748]
    with pytest.raises(ValueError):
        cuda_x25519.ladder(scalars.int(), us)
    with pytest.raises(ValueError):
        cuda_x25519.ladder(scalars, us[:1])


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["seal", "open"])
def test_aead_kernel_matches_plain_and_reference(card, op):
    lens = list(EDGE_LENS) + [int(n) for n in np.random.default_rng(8).integers(0, 1025, 1009)]
    frames = _frames(9, lens)
    lanes, blocks = ca._bucket_shape(frames)
    packed = [torch.from_numpy(a).to(card) for a in ca._pack_frames(frames, lanes, blocks)]
    before = cuda_aead.launches
    out, tag = cuda_aead.aead(*packed, seal=op == "seal")
    torch.cuda.synchronize()
    assert cuda_aead.launches - before == 1
    want = ca.aead_core(*packed, seal=op == "seal")
    assert torch.equal(out, want[0]) and torch.equal(tag, want[1])
    got = ca._unpack_outputs(out.cpu().numpy(), tag.cpu().numpy(), frames)
    assert got[:64] == ca._host_pass(op, frames[:64])


@pytest.mark.cuda
@pytest.mark.parametrize("n", (256,) + LANE_COUNTS)
def test_ladder_kernel_matches_plain_and_reference(card, n):
    pairs = (vector_pairs() + [(os.urandom(32), os.urandom(32)) for _ in range(n)])[:n]
    scalars, us = (torch.from_numpy(a).to(card) for a in xl._pack_pairs(pairs, n))
    out = cuda_x25519.ladder(scalars, us)
    torch.cuda.synchronize()
    assert torch.equal(out, xl.ladder_plain(scalars, us))
    got = out.cpu().numpy()
    sample = range(n) if n <= 33 else range(0, n, 16)
    for i in sample:
        assert got[i].tobytes() == aead_ref.x25519(*pairs[i])


@pytest.mark.cuda
def test_entry_points_on_the_card(card):
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.ops import dispatch_stats
    from cometbft_tpu_torch.p2p import handshake_pool
    from cometbft_tpu_torch.p2p.secret_connection import SecretConnection

    dispatch_stats.reset()
    frames = _frames(10, EDGE_LENS[:-2])
    sealed = ca.seal_frames(frames, device="cuda")
    assert sealed == [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, d, b"")
                      for k, n, d in frames]
    assert ca.open_frames([(k, n, s) for (k, n, _), s in zip(frames, sealed)],
                          device="cuda") == [d for _, _, d in frames]
    pairs = vector_pairs()
    assert xl.exchange_batch(pairs, device="cuda") == xl.host_exchange(pairs)
    privs = [Ed25519PrivKey.from_seed(hashlib.sha256(b"card-%d" % i).digest())
             for i in range(2)]
    s1, s2 = socket.socketpair()
    out = {}
    t = threading.Thread(target=lambda: out.__setitem__(
        "b", SecretConnection(s2, privs[1], device="cuda")))
    t.start()
    a = SecretConnection(s1, privs[0], device="cuda")
    t.join(60)
    datas = [os.urandom(1024) for _ in range(64)]
    a.write_frames(datas)
    assert [out["b"].read_frame() for _ in datas] == datas
    handshake_pool.reset_pool()
    assert dispatch_stats.tier_counts(ca.AEAD)["cuda"][0] >= 4
    assert dispatch_stats.tier_counts(xl.X25519)["cuda"][1] == len(pairs) + 4
    assert dispatch_stats.tier_counts(ca.AEAD)["host"] == (0, 0)


@pytest.mark.cuda
def test_occupancy(card):
    occ = cuda_aead.occupancy()
    assert occ["threads"] == cuda_aead.THREADS_PER_LANE * cuda_aead.FRAMES_PER_BLOCK
    assert occ["blocks_per_sm"] >= 8 and occ["local_bytes"] == 0
    occ = cuda_x25519.occupancy()
    assert occ["threads"] == cuda_x25519.THREADS_PER_BLOCK and occ["blocks_per_sm"] >= 1
    assert occ["local_bytes"] == 0
