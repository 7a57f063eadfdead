"""The hand-written BLS12-381 G1 scalar-multiplication kernel
(cometbft_tpu_torch/csrc/bls_g1.cu).

The kernel runs one thread per lane.  Its source also builds for the host
(no ``__CUDACC__``), where the lanes run one after another, so here its
field arithmetic is held against Python integers (0, 1, p - 1 and the
multiply by b3 = 12 of values near p among them), its ladder against the
pure-Python oracle and the plain version (bit for bit, the point at
infinity and the scalars 0, 1 and 2^128 - 1 among the lanes), and its
own field-op tally against the counts ``ops.cuda_bls`` states.  The
roofline bound counts the work the function needs instead
(``cuda_bls.needed_work``: checked here).  The tests marked ``cuda`` run
the kernel itself against its plain version and skip where there is no
card.  This file imports nothing of JAX: the card's machine has none.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import bls_g1 as tg1
from cometbft_tpu_torch.ops import cuda_bls as tcb
from cometbft_tpu_torch.ops.cuda_secp import wnaf_weight

SRC = _build.CSRC_DIR / "bls_g1.cu"
P = tbls.P
R = 1 << 384  # the kernel's Montgomery radix


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("hostbuild") / "libbls_g1_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
                    "-DBLS_TALLY", "-o", str(out), str(SRC)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.bls_g1_host.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int]
    lib.bls_g1_fe_op_host.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int]
    lib.bls_g1_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 3
    return lib


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals],
                    np.uint32)


def _ints(words) -> list:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


def _tally(lib):
    vals = [ctypes.c_longlong() for _ in range(3)]
    lib.bls_g1_tally(*map(ctypes.byref, vals))
    return tuple(v.value for v in vals)


def _values(n, seed):
    rng = random.Random(seed)
    edge = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, -(-P // 12)]
    return edge + [rng.randrange(P) for _ in range(n - len(edge))]


R_INV = pow(R, -1, P)
FE_OPS = {
    "add": (0, lambda a, b: (a + b) % P),
    "sub": (1, lambda a, b: (a - b) % P),
    "mul": (2, lambda a, b: a * b * R_INV % P),
    "square": (3, lambda a, b: a * a * R_INV % P),
    "mul_b3": (4, lambda a, b: 12 * a % P),
    "to_mont": (5, lambda a, b: a * R % P),
    "from_mont": (6, lambda a, b: a * R_INV % P),
}


@pytest.mark.parametrize("op", sorted(FE_OPS))
def test_field_ops_on_host_match_ints(host_lib, op):
    """Every result is fully reduced (below p): the kernel has no headroom
    (R/p ~ 9.85), so 12 * (p - 1) or (p - 1) + (p - 1) must come back below
    p, not below 2^384."""
    code, want = FE_OPS[op]
    xs, ys = _values(24, 1), _values(24, 2)[::-1]
    if op == "to_mont":  # any value below 2^384 enters
        xs = xs + [R - 1, 1 << 383, P, P + 1]
        ys = ys + [0] * 4
    a, b = _words(xs), _words(ys)
    out = np.zeros_like(a)
    host_lib.bls_g1_fe_op_host(code, a.ctypes.data, b.ctypes.data,
                               out.ctypes.data, len(xs))
    _tally(host_lib)
    assert _ints(out) == [want(x, y) for x, y in zip(xs, ys)]


def _lanes(n, seed):
    """Pubkeys of seeded keys (host library) with the edge lanes: the
    identity, the generator, one point repeated, scalars 0, 1, 2 and
    2^128 - 1."""
    rng = random.Random(seed)
    pubs = [tbls.pubkey(rng.randrange(1, tbls.R)) for _ in range(n)]
    ks = [rng.getrandbits(128) for _ in range(n)]
    pubs[:4] = [tg1.INFINITY, tbls.g1_serialize(tbls.G1_GEN), pubs[4], pubs[4]]
    ks[4:8] = [0, 1, 2, (1 << 128) - 1]
    return pubs, ks


def _host(lib, pubs, ks, nbits=128):
    pts = np.frombuffer(b"".join(pubs), np.uint8).copy()
    sc = tg1.scalars_to_bytes(ks, nbits).copy()
    out = np.zeros((len(pubs), 144), np.uint8)
    lib.bls_g1_host(pts.ctypes.data, sc.ctypes.data, out.ctypes.data, len(pubs), nbits)
    return out


def test_ladder_on_host_equals_plain_and_oracle(host_lib):
    pubs, ks = _lanes(12, 3)
    got = _host(host_lib, pubs, ks)
    plain = tcb.scalar_mul_cuda(
        torch.from_numpy(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 96).copy()),
        torch.from_numpy(tg1.scalars_to_bytes(ks).copy()))
    assert (got == plain.numpy()).all()  # canonical X, Y, Z bit for bit
    want = [tbls.E1.affine(tbls.E1.mul_scalar(tbls.g1_deserialize(p), k))
            for p, k in zip(pubs, ks)]
    assert tg1.affine(got) == want
    assert want[0] is None and want[4] is None and want[5] is not None
    lib = tbls._nat()
    for p, k, w in zip(pubs, ks, tg1.affine(got)):
        buf = ctypes.create_string_buffer(96)
        assert lib.bls_g1_scalar_mul(p, k.to_bytes(16, "big"), 16, buf) == 0
        assert buf.raw == (tg1.INFINITY if w is None else
                           w[0].to_bytes(48, "big") + w[1].to_bytes(48, "big"))
    _tally(host_lib)


def test_ladder_on_host_at_16_bits_is_the_known_answer(host_lib):
    """The JAX self-check's known answer, G * 0x1234 at 16 bits, and a
    scalar wider than nbits is cut to its low bits."""
    gen = tbls.g1_serialize(tbls.G1_GEN)
    got = tg1.affine(_host(host_lib, [gen, gen], [0x1234, 0x1234], 16))
    want = tbls.E1.affine(tbls.E1.mul_scalar(tbls.G1_GEN, 0x1234))
    assert got == [want, want]
    wide = tg1.scalars_to_bytes([0xABCD << 16 | 0x1234]).copy()
    out = np.zeros((1, 144), np.uint8)
    pts = np.frombuffer(gen, np.uint8).copy()
    host_lib.bls_g1_host(pts.ctypes.data, wide.ctypes.data, out.ctypes.data, 1, 16)
    assert tg1.affine(out) == [want]
    _tally(host_lib)


def test_kernel_tally_equals_the_stated_counts(host_lib):
    _tally(host_lib)
    pubs, ks = _lanes(9, 4)
    _host(host_lib, pubs, ks)
    muls, squares, smalls = _tally(host_lib)
    assert (muls, squares, smalls) == (9 * tcb.FIELD_MULS_PER_LANE,
                                       9 * tcb.FIELD_SQUARES_PER_LANE,
                                       9 * tcb.FIELD_SMALLS_PER_LANE)
    assert tcb.WIDE_PRODUCTS_PER_LANE == 300 * (2309 + 768)
    _host(host_lib, pubs[:1], [ks[0] & 0xFFFF], 16)  # the loop runs nbits steps
    assert _tally(host_lib) == (16 * 18 + 5, 16 * 6, 16 * 4)


def test_needed_work():
    """The bound's work: the cheapest width-w NAF ladder per scalar in
    Jacobian coordinates over a one-Z table of odd multiples; the GLV
    split gains nothing at 128 bits."""
    assert tcb.lane_work(0) == (0, 0)
    assert tcb.lane_work(1) == (0, 0)
    assert tcb.lane_work(2) == tcb.DOUBLE_MS
    assert tcb.lane_work(3) == tuple(  # 4P - P
        2 * d + a for d, a in zip(tcb.DOUBLE_MS, tcb.ADD_MS))
    assert tcb.lane_work(7) == tuple(  # 8P - P beats the table P, 3P, 5P, 7P
        3 * d + a for d, a in zip(tcb.DOUBLE_MS, tcb.ADD_MS))
    k = (1 << 128) - 1
    digits, length = wnaf_weight(k, 2)
    assert (digits, length) == (2, 129)
    rng = random.Random(5)
    ks = [rng.getrandbits(128) for _ in range(64)]
    muls, squares, products = tcb.needed_work(ks)
    per = products / len(ks)
    # ~127 doublings and ~20 additions with their tables: about 2.9x less
    # than this kernel's own 128 complete doublings + 128 complete additions
    assert 300_000 < per < 330_000
    assert 2.8 < tcb.WIDE_PRODUCTS_PER_LANE / per < 3.1
    assert products == sum(tcb._products(tcb.lane_work(s)) for s in ks)
    # lambda is the endomorphism's eigenvalue on G1 (lambda^2 + lambda + 1
    # = 0 mod r), and a 128-bit scalar's second GLV half is 0 or 1
    lam = tcb.LAMBDA
    assert (lam * lam + lam + 1) % tbls.R == 0 and ((1 << 128) - 1) // lam == 1
    g = tbls.E1.affine(tbls.G1_GEN)
    beta_x = tbls.E1.affine(tbls.E1.mul_scalar(tbls.G1_GEN, lam))
    assert beta_x[1] == g[1] and beta_x[0] != g[0]


def test_wrapper_checks_and_the_launch_counter():
    pts = torch.zeros(2, 96, dtype=torch.uint8)
    sc = torch.zeros(2, 16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pts"):
        tcb.scalar_mul_cuda(pts[:, :48], sc)
    with pytest.raises(ValueError, match="scalars"):
        tcb.scalar_mul_cuda(pts, sc[:1])
    with pytest.raises(ValueError, match="nbits"):
        tcb.scalar_mul_cuda(pts, sc, 129)
    before = tcb.launches
    pts[:, 0] = 0x40  # two points at infinity
    out = tcb.scalar_mul_cuda(pts, sc, 4)  # CPU tensors: the plain version
    assert tcb.launches == before and tg1.affine(out.numpy()) == [None, None]
    tcb.launches = 7
    tcb.reset_launches()
    assert tcb.launches == 0
    tcb.launches = before
    assert tcb.NAME in _build.sources() and not _build.is_host(tcb.NAME)
    assert _build.is_host("bls12381")
    assert tcb.REPLACES.startswith("cometbft_tpu/ops/bls_g1.py:")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _device_inputs(pubs, ks, dev):
    pts = torch.from_numpy(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 96).copy())
    return pts.to(dev), torch.from_numpy(tg1.scalars_to_bytes(ks).copy()).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 129])
def test_kernel_matches_plain(card, n):
    pubs, ks = _lanes(max(n, 12), 6)
    pts, sc = _device_inputs(pubs[:n], ks[:n], card)
    before = tcb.launches
    kern = tcb.scalar_mul_cuda(pts, sc)
    torch.cuda.synchronize()
    assert tcb.launches == before + 1
    assert torch.equal(kern, tg1.batch_scalar_mul_plain(pts, sc))


@pytest.mark.cuda
def test_kernel_matches_plain_at_10240_lanes(card):
    rng = np.random.default_rng(7)
    pubs, _ = _lanes(256, 7)
    pubs = [pubs[i] for i in rng.integers(0, 256, 10_240)]
    ks = [int.from_bytes(rng.bytes(16), "big") for _ in pubs]
    pts, sc = _device_inputs(pubs, ks, card)
    kern = tcb.scalar_mul_cuda(pts, sc)
    torch.cuda.synchronize()
    assert torch.equal(kern, tg1.batch_scalar_mul_plain(pts, sc))
    got = tg1.affine(kern[:32].cpu().numpy())
    assert got == [tbls.E1.affine(tbls.E1.mul_scalar(tbls.g1_deserialize(p), k))
                   for p, k in zip(pubs[:32], ks[:32])]


@pytest.mark.cuda
def test_kernel_entry_points_and_occupancy(card):
    pubs, ks = _lanes(12, 8)
    pts = [tbls.E1.affine(tbls.g1_deserialize(p)) if p != tg1.INFINITY else None
           for p in pubs]
    assert tg1.batch_scalar_mul(pts, ks) == tg1.batch_scalar_mul(pts, ks, device="cpu")
    assert tg1.batch_scalar_mul(pts[:2], [0x1234] * 2, nbits=16) == tg1.batch_scalar_mul(
        pts[:2], [0x1234] * 2, nbits=16, device="cpu")
    occ = tcb.occupancy()
    assert occ["threads"] == 64 and occ["regs"] <= 255 and occ["blocks_per_sm"] >= 1
