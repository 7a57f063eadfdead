"""The hand-written secp256k1 ECDSA kernel (cometbft_tpu_torch/csrc/
secp256k1_verify.cu).

The kernel runs a quad of four threads per signature.  Its source also
builds for the host (no ``__CUDACC__``), where each lane runs the quad's
four threads in turn and then the combine, so here its field arithmetic is
held against Python integers (edge values included: 0, p - 1, p,
2^256 - 1), its point formulas against the plain curve layer (the same
field elements), its GLV split, signed radix-8 recoding and four partial
points against Python integers and the port's ``crypto/secp256k1``, and
its verify against the pure-Python oracle and the plain version (mixed
and edge lanes), with the kernel's own field-op tally.
The roofline bound counts the work the function needs instead
(``cuda_secp.needed_work``: the GLV split, the wNAF weights and the work
per kind of lane are checked here).  The tests marked ``cuda`` run the kernel itself against its
plain version and skip where there is no card.  This file imports nothing
of JAX: the card's machine has none.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import cuda_secp as tcs
from cometbft_tpu_torch.ops import secp_verify as tsv
from cometbft_tpu_torch.ops.wcurve import Point

SRC = _build.CSRC_DIR / "secp256k1_verify.cu"
P = tsv.P


def pack_points(pts) -> Point:
    """Affine (x, y) int pairs (None = O) as a projective batch of the
    plain curve layer, O as (0 : 1 : 0)."""
    proj = [(0, 1, 0) if pt is None else (pt[0], pt[1], 1) for pt in pts]
    return Point(*(tsv.FIELD.pack([c[i] for c in proj]) for i in range(3)))


def affine(pt: Point) -> list:
    """A projective batch as affine (x, y) int pairs, None for O."""
    out = []
    for x, y, z in zip(*(tsv.FIELD.unpack(c) for c in pt)):
        zi = pow(z, -1, P) if z else 0
        out.append((x * zi % P, y * zi % P) if z else None)
    return out


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("hostbuild") / "libsecp256k1_verify_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
                    "-DSECP_TALLY", "-o", str(out), str(SRC)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.secp256k1_verify_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.secp256k1_fe_op_host.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.secp256k1_pt_op_host.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.secp256k1_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 3
    lib.secp256k1_glv_split_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.secp256k1_recode_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.secp256k1_partials_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    return lib


def _words(vals, k=8) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(k)] for v in vals],
                    np.uint32)


def _ints(words) -> list:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


def _tally(lib):
    vals = [ctypes.c_longlong() for _ in range(3)]
    lib.secp256k1_tally(*map(ctypes.byref, vals))
    return tuple(v.value for v in vals)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, P - 1, P, P + 1, (1 << 256) - 1, (1 << 256) - 978, 1 << 255]
    return edge + [int.from_bytes(rng.bytes(32), "big") for _ in range(n - len(edge))]


FE_OPS = {
    "add": (0, lambda a, b: a + b),
    "sub": (1, lambda a, b: a - b),
    "mul": (2, lambda a, b: a * b),
    "square": (3, lambda a, b: a * a),
    "mul_b3": (4, lambda a, b: 21 * a),
    "neg": (5, lambda a, b: -a),
    "sqrt": (6, lambda a, b: pow(a, (P + 1) // 4, P)),
    "normalize": (7, lambda a, b: a),
}


@pytest.mark.parametrize("op", sorted(FE_OPS))
def test_field_ops_on_host_match_ints(host_lib, op):
    code, want = FE_OPS[op]
    xs, ys = _values(24, 1), _values(24, 2)[::-1]
    a, b = _words(xs), _words(ys)
    out = np.zeros_like(a)
    host_lib.secp256k1_fe_op_host(code, a.ctypes.data, b.ctypes.data,
                                  out.ctypes.data, len(xs))
    got = _ints(out)
    assert all(g < 1 << 256 for g in got)
    assert [g % P for g in got] == [want(x, y) % P for x, y in zip(xs, ys)]
    if op == "normalize":
        assert got == [x % P for x in xs]


@pytest.mark.parametrize("op", ["add", "double"])
def test_point_formulas_on_host_equal_the_plain_curve(host_lib, op):
    """(X : Y : Z) of the kernel's formulas equal the plain curve layer's
    as field elements (so the JAX module's too), on multiples of G, the
    identity, P = Q and Q = -P."""
    rng = np.random.default_rng(3)
    pts = [tsecp.g_mul(int.from_bytes(rng.bytes(32), "big")) for _ in range(4)]
    ps = [pts[0], pts[1], None, pts[2], pts[3], None]
    qs = [pts[1], pts[1], pts[0], (pts[2][0], P - pts[2][1]), None, None]
    proj = lambda pt: (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
    a = np.concatenate([_words(proj(p)).reshape(1, 24) for p in ps])
    b = np.concatenate([_words(proj(q)).reshape(1, 24) for q in qs])
    out = np.zeros_like(a)
    host_lib.secp256k1_pt_op_host(0 if op == "add" else 1, a.ctypes.data,
                                  b.ctypes.data, out.ctypes.data, len(ps))
    kern = [[v % P for v in _ints(out[:, 8 * c:8 * c + 8])] for c in range(3)]
    cv, fp = tsv.CURVE, tsv.FIELD
    tp, tq = pack_points(ps), pack_points(qs)
    plain = cv.add(tp, tq) if op == "add" else cv.double(tp)
    assert kern == [fp.unpack(c) for c in (plain.x, plain.y, plain.z)]


def not_on_curve_x() -> int:
    x = 5
    while tsv.decompress_pubkey(b"\x02" + x.to_bytes(32, "big")) is not None:
        x += 1
    return x


def mixed_lanes():
    """16 lanes: 4 valid, then one of each kind of reject: high-S (valid
    ECDSA that the low-S rule rejects), a flipped byte of s, another
    message, the wrong key, r = 0, s = 0, r = n, a bad prefix, x off the
    curve, x >= p, a 32-byte key, a 63-byte signature."""
    privs = [tsecp.Secp256k1PrivKey.from_secret(b"secp-test-%d" % i) for i in range(16)]
    pubs = [p.pub_key().bytes() for p in privs]
    msgs = [b"vote-bytes-%d" % i for i in range(16)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    n = tsv.N
    sigs[4] = sigs[4][:32] + (n - int.from_bytes(sigs[4][32:], "big")).to_bytes(32, "big")
    sigs[5] = sigs[5][:40] + bytes([sigs[5][40] ^ 4]) + sigs[5][41:]
    msgs[6] = b"another message"
    pubs[7] = pubs[0]
    sigs[8] = bytes(32) + sigs[8][32:]
    sigs[9] = sigs[9][:32] + bytes(32)
    sigs[10] = n.to_bytes(32, "big") + sigs[10][32:]
    pubs[11] = b"\x05" + pubs[11][1:]
    pubs[12] = b"\x02" + not_on_curve_x().to_bytes(32, "big")
    pubs[13] = b"\x03" + (P + 1).to_bytes(32, "big")
    pubs[14] = pubs[14][:32]
    sigs[15] = sigs[15][:63]
    return pubs, msgs, sigs


def _oracle(pubs, msgs, sigs):
    return [len(p) == 33 and tsecp.Secp256k1PubKey(p).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)]


def test_kernel_source_on_host_matches_oracle_and_tally(host_lib):
    pubs, msgs, sigs = mixed_lanes()
    a = tsv.prepare_batch(pubs, msgs, sigs)
    arrays = [np.ascontiguousarray(a[k], np.uint8) for k in tsv.KEYS]
    out = np.zeros(len(pubs), np.int32)
    _tally(host_lib)
    host_lib.secp256k1_verify_host(*(x.ctypes.data for x in arrays),
                                   out.ctypes.data, len(pubs))
    assert (out != 0).tolist() == _oracle(pubs, msgs, sigs)
    assert (out != 0).tolist() == [True] * 4 + [False] * 12
    # a lane with ok clear costs nothing; every other lane the same counted
    # work, its four threads' (keys off the curve included)
    lanes = int(a["ok"].sum())
    assert _tally(host_lib) == (lanes * tcs.FIELD_MULS_PER_SIG,
                                lanes * tcs.FIELD_SQUARES_PER_SIG,
                                lanes * tcs.FIELD_SMALLS_PER_SIG)
    assert (tcs.FIELD_MULS_PER_SIG, tcs.FIELD_SQUARES_PER_SIG,
            tcs.FIELD_SMALLS_PER_SIG) == (5420, 4164, 1416)
    assert tcs.WIDE_PRODUCTS_PER_SIG == 72 * 5420 + 44 * 4164 + 8 * 1416 + 4 * 184
    assert tcs.THREADS_PER_SIG == 4


# -- the quad's scalars and partial points ----------------------------------------


def _split_host(lib, ks):
    kb = np.array([list(k.to_bytes(32, "big")) for k in ks], np.uint8)
    m1, m2 = np.zeros((len(ks), 5), np.uint32), np.zeros((len(ks), 5), np.uint32)
    negs = np.zeros((len(ks), 2), np.int32)
    lib.secp256k1_glv_split_host(kb.ctypes.data, m1.ctypes.data, m2.ctypes.data,
                                 negs.ctypes.data, len(ks))
    return [(-a if n1 else a, -b if n2 else b)
            for a, b, (n1, n2) in zip(_ints(m1), _ints(m2), negs)]


def test_glv_split_on_host(host_lib):
    """k1 + k2*lambda = k (mod n) with |k1|, |k2| < 2^129, on 64 seeded
    scalars and the edges."""
    n = tsv.N
    rng = np.random.default_rng(6)
    ks = [0, 1, 2, n - 1, (n - 1) // 2, tcs.LAMBDA, n - tcs.LAMBDA, 1 << 128,
          (1 << 129) - 1]
    ks += [int.from_bytes(rng.bytes(32), "big") % n for _ in range(64)]
    for k, (k1, k2) in zip(ks, _split_host(host_lib, ks)):
        assert (k1 + k2 * tcs.LAMBDA - k) % n == 0
        assert abs(k1) < 1 << 129 and abs(k2) < 1 << 129


def test_signed_radix8_recoding_on_host(host_lib):
    """44 digits in [-4, 4] that recombine to each scalar below 2^129."""
    rng = np.random.default_rng(7)
    ss = [0, 1, 4, 5, 7, 8, (1 << 128) - 1, 1 << 128, (1 << 129) - 1] + [
        int.from_bytes(rng.bytes(17), "big") >> 7 for _ in range(64)]
    words, digits = _words(ss, 5), np.zeros((len(ss), 44), np.int32)
    host_lib.secp256k1_recode_host(words.ctypes.data, digits.ctypes.data, len(ss))
    for v, row in zip(ss, digits.tolist()):
        assert all(-4 <= d <= 4 for d in row)
        assert sum(d * 8 ** i for i, d in enumerate(row)) == v


def test_partial_points_on_host_sum_to_the_double_mul(host_lib):
    """Thread j of a lane's quad ends with s_j*P_j: u1's halves times G and
    2^128*G, |k1| times +-Q, |k2| times +-lambda*Q; the four add up to
    u1*G + u2*Q (the port's ``crypto/secp256k1``)."""
    pubs, msgs, sigs = mixed_lanes()
    a = tsv.prepare_batch(pubs[:3], msgs[:3], sigs[:3])
    edge, _ = tcs.edge_lanes(8)
    q33 = np.concatenate([a["q33"], edge["q33"][:1]])  # and u1 = 0
    u1s, u2s = (np.concatenate([a[k], edge[k][:1]]) for k in ("u1", "u2"))
    out = np.zeros((len(q33), 4, 24), np.uint32)
    host_lib.secp256k1_partials_host(q33.ctypes.data, u1s.ctypes.data,
                                     u2s.ctypes.data, out.ctypes.data, len(q33))
    g128 = tsecp.g_mul(1 << 128)
    big = lambda row: int.from_bytes(row.tobytes(), "big")
    signed = lambda pt, k: pt if k >= 0 else (pt[0], P - pt[1])
    for i in range(len(q33)):
        q = tsecp.pt_decompress(q33[i].tobytes())
        u1, u2 = big(u1s[i]), big(u2s[i])
        (k1, k2), = _split_host(host_lib, [u2])
        lq = (tcs.BETA * q[0] % P, q[1])
        want = [tsecp.double_mul(0, u1 & ((1 << 128) - 1), tsv.G),
                tsecp.double_mul(0, u1 >> 128, g128),
                tsecp.double_mul(0, abs(k1), signed(q, k1)),
                tsecp.double_mul(0, abs(k2), signed(lq, k2))]
        coords = [[v % P for v in _ints(out[i, :, 8 * c:8 * c + 8])] for c in range(3)]
        got = affine(Point(*(tsv.FIELD.pack(vals) for vals in coords)))
        assert got == want
        total = (0, 1, 0)  # Jacobian, the identity
        for pt in got:
            if pt is not None:
                total = tsecp._jac_add(total, (pt[0], pt[1], 1))
        assert tsecp._to_affine(total) == tsecp.double_mul(u1, u2, q)


def test_edge_lanes_on_host_equal_the_plain_version(host_lib):
    """u1 = 0; Q = G; Q = -G with u1 = u2 (R' = O, rejected); u1 = n - 1;
    u2 = n - 1; r + n < p: the host build, the plain version and the
    expected verdicts agree bit for bit."""
    arrays, want = tcs.edge_lanes(8)
    ins = [np.ascontiguousarray(arrays[k], np.uint8) for k in tsv.KEYS]
    out = np.zeros(len(want), np.int32)
    host_lib.secp256k1_verify_host(*(x.ctypes.data for x in ins), out.ctypes.data,
                                   len(want))
    plain = tsv.verify_core(**tsv.batch_to_device(arrays, "cpu"))
    assert (out != 0).tolist() == plain.tolist() == want
    assert want.count(True) == 5 and not want[-1]


# -- the bound's work model ------------------------------------------------------


def test_glv_split_and_endomorphism():
    """lambda*G = (beta*x, y), and every split recombines to its scalar
    with halves below 2^129."""
    n = tsv.N
    assert tsecp.g_mul(tcs.LAMBDA) == (tcs.BETA * tsv.GX % P, tsv.GY)
    rng = np.random.default_rng(5)
    ks = [0, 1, 2, n - 1, n // 2, tcs.LAMBDA, (1 << 255) + 3] + [
        int.from_bytes(rng.bytes(32), "big") % n for _ in range(64)]
    for k in ks:
        k1, k2 = tcs.glv_split(k)
        assert (k1 + k2 * tcs.LAMBDA - k) % n == 0
        assert abs(k1) < 1 << 129 and abs(k2) < 1 << 129


def _naf_digits(k: int, w: int) -> list:
    """The width-w NAF of k >= 0, one digit per bit position, LSB first."""
    out = []
    while k:
        d = 0
        if k & 1:
            d = k % (1 << w)
            if d >= 1 << (w - 1):
                d -= 1 << w
            k -= d
        out.append(d)
        k >>= 1
    return out


@pytest.mark.parametrize("w", [2, 5, 15])
def test_wnaf_weight_matches_the_digit_expansion(w):
    rng = np.random.default_rng(w)
    ks = [0, 1, 3, 255, (1 << 128) - 1, 1 << 128] + [
        int.from_bytes(rng.bytes(17), "big") for _ in range(40)]
    for k in ks:
        digits = _naf_digits(k, w)
        assert sum(d << i for i, d in enumerate(digits)) == k
        assert all(d % 2 and abs(d) < 1 << (w - 1) for d in digits if d)
        assert tcs.wnaf_weight(k, w) == (sum(1 for d in digits if d), len(digits))
        assert tcs.wnaf_weight(-k, w) == tcs.wnaf_weight(k, w)


def _lanes(keys, u1s, u2s, oks):
    row = lambda v: list(v.to_bytes(32, "big"))
    arr = lambda rows: np.array(rows, np.uint8)
    return (arr([list(k) for k in keys]), arr([row(u) for u in u1s]),
            arr([row(u) for u in u2s]), np.array(oks, bool))


def test_needed_work_by_lane_kind():
    """A lane the host rejected needs nothing, a key off the curve its
    decompression, u1 = 0, u2 = 1 decompression, Q's table and the
    closing steps; a real signature about 1,000 multiplies and as many
    squares, under a third of the kernel's own tally."""
    key = tsecp.Secp256k1PrivKey.from_secret(b"bound").pub_key().bytes()
    off = b"\x02" + not_on_curve_x().to_bytes(32, "big")
    dm, ds = tcs.DECOMPRESS_MS
    tm, ts = tcs.TABLE_MS
    fm, fs = tcs.FINISH_MS
    cost = lambda m, sq, split: (m, sq, tcs.PRODUCTS_PER_MUL * m
                                 + tcs.PRODUCTS_PER_SQUARE * sq + split)
    assert tcs.needed_work(*_lanes([key], [5], [7], [False])) == (0, 0, 0)
    assert tcs.needed_work(*_lanes([off], [5], [7], [True])) == cost(dm, ds, 0)
    assert tcs.needed_work(*_lanes([key], [0], [1], [True])) == cost(
        dm + tm + fm, ds + ts + fs, tcs.SPLIT_PRODUCTS)
    pubs, msgs, sigs = mixed_lanes()
    a = tsv.prepare_batch(pubs[:4], msgs[:4], sigs[:4])
    m, sq, products = tcs.needed_work(a["q33"], a["u1"], a["u2"], a["ok"])
    assert 900 * 4 < m < 1100 * 4 and 900 * 4 < sq < 1100 * 4
    assert 3 * products < 4 * tcs.WIDE_PRODUCTS_PER_SIG
    # lanes add up
    parts = [tcs.needed_work(*(a[k][i:i + 1] for k in ("q33", "u1", "u2", "ok")))
             for i in range(4)]
    assert tuple(map(sum, zip(*parts))) == (m, sq, products)


def test_wrapper_rejects_malformed_inputs():
    pubs, msgs, sigs = mixed_lanes()
    t = tsv.batch_to_device(tsv.prepare_batch(pubs[:2], msgs[:2], sigs[:2]), "cpu")
    with pytest.raises(ValueError, match="q33"):
        tcs.verify_core_cuda(t["q33"][:, :32], t["u1"], t["u2"], t["r"], t["ok"])
    with pytest.raises(ValueError, match="u2"):
        tcs.verify_core_cuda(t["q33"], t["u1"], t["u2"][:1], t["r"], t["ok"])
    with pytest.raises(ValueError, match="ok"):
        tcs.verify_core_cuda(t["q33"], t["u1"], t["u2"], t["r"], t["ok"].int())
    tcs.launches, before = 7, tcs.launches
    tcs.reset_launches()
    assert tcs.launches == 0
    tcs.launches = before
    assert tcs.NAME in _build.sources() and not _build.is_host(tcs.NAME)
    assert tcs.REPLACES.startswith("cometbft_tpu/ops/secp_verify.py:")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 12, 15, 16, 17, 31, 33, 65])
def test_kernel_matches_plain_and_oracle(card, n):
    pubs, msgs, sigs = (x * 5 for x in mixed_lanes())
    pubs, msgs, sigs = pubs[:n], msgs[:n], sigs[:n]
    t = tsv.batch_to_device(tsv.prepare_batch(pubs, msgs, sigs), card)
    before = tcs.launches
    kern = tcs.verify_core_cuda(**t)
    torch.cuda.synchronize()
    assert tcs.launches == before + 1
    assert torch.equal(kern, tsv.verify_core(**t))
    assert kern.cpu().tolist() == _oracle(pubs, msgs, sigs)


@pytest.mark.cuda
def test_kernel_entry_points_and_occupancy(card):
    pubs, msgs, sigs = mixed_lanes()
    assert tsv.verify_batch(pubs, msgs, sigs).tolist() == _oracle(pubs, msgs, sigs)
    occ = tcs.occupancy()
    assert occ["threads"] == 64 and occ["local_bytes"] == 0
    assert occ["shared_bytes"] == (4 * 24 + 7) * 4 * 64 and occ["regs"] <= 204
    # a 10,240-signature commit (640 blocks) in one wave on 132 SMs
    assert occ["blocks_per_sm"] >= 5


@pytest.mark.cuda
def test_kernel_edge_lanes_match_plain(card):
    arrays, want = tcs.edge_lanes(8)
    t = tsv.batch_to_device(arrays, card)
    kern = tcs.verify_core_cuda(**t)
    torch.cuda.synchronize()
    assert kern.cpu().tolist() == tsv.verify_core(**t).cpu().tolist() == want
