"""The hand-written BLS12-381 G1 scalar-multiplication kernel
(cometbft_tpu_torch/csrc/bls_g1.cu).

The kernel runs a group of G threads per lane over a schedule of levels
of field operations.  Its source also builds for the host (no
``__CUDACC__``), where each lane runs its group's threads in turn between
the barriers, so here its lazy field arithmetic is held against Python
integers at the extreme operands (0, 1, p - 1, p, 2p - 1, the largest each
operation admits), its signed-window recoding against the scalar, its
schedule against hazards and against the counts ``ops.cuda_bls`` states
(the field operations of a full lane, the levels each thread runs at each
G), and its ladder against the pure-Python oracle and the plain version, as
points (the kernel hands out (X Z : Y : Z^3) of a Jacobian result, the
plain version RCB15's projective one): the identity, the order-3 point (0,
2) that takes both H = 0 branches, the scalar and width edges, at G = 1,
2 and 4.  The roofline bound counts the work the function needs instead
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
ORDER3 = (0, 2)  # on y^2 = x^3 + 4, outside the subgroup: 2P = -P, 3P = O
W = 4  # the kernel's bits per signed digit (its bls_g1_config)


def _compile(tmp_path_factory, *defines):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    name = "_".join(d.strip("-D").replace("=", "") for d in defines) or "default"
    out = tmp_path_factory.mktemp("hostbuild") / f"libbls_g1_{name}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
                    "-DBLS_TALLY", *defines, "-o", str(out), str(SRC)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bls_g1_host.argtypes = [vp, vp, vp, i32, i32]
    lib.bls_g1_fe_op_host.argtypes = [i32, vp, vp, vp, i32]
    lib.bls_g1_recode_host.argtypes = [vp, i32, i32, vp]
    lib.bls_g1_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 3
    lib.bls_g1_rounds.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    lib.bls_g1_branches.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.bls_g1_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The package's build (G = 4) for the host, with the tally."""
    return _compile(tmp_path_factory)


@pytest.fixture(scope="module")
def host_lib_g1(tmp_path_factory):
    return _compile(tmp_path_factory, "-DBLS_GROUP=1")


@pytest.fixture(scope="module")
def host_lib_g2(tmp_path_factory):
    return _compile(tmp_path_factory, "-DBLS_GROUP=2")


@pytest.fixture(params=[1, 2, 4], ids=["G1", "G2", "G4"])
def group_lib(request, host_lib, host_lib_g1, host_lib_g2):
    return request.param, {1: host_lib_g1, 2: host_lib_g2, 4: host_lib}[request.param]


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)] for v in vals],
                    np.uint32)


def _ints(words) -> list:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


def _tally(lib):
    vals = [ctypes.c_longlong() for _ in range(3)]
    lib.bls_g1_tally(*map(ctypes.byref, vals))
    return tuple(v.value for v in vals)


def _rounds(lib):
    vals = [ctypes.c_longlong() for _ in range(2)]
    lib.bls_g1_rounds(*map(ctypes.byref, vals))
    return tuple(v.value for v in vals)


def _branches(lib):
    vals = (ctypes.c_longlong * 5)()
    lib.bls_g1_branches(vals)
    return list(vals)


def _reset(lib):
    _tally(lib), _rounds(lib), _branches(lib)


def _values(n, seed, edge, top):
    rng = random.Random(seed)
    return list(edge) + [rng.randrange(top) for _ in range(n - len(edge))]


def _fe_cases(name, n):
    """(xs, ys) for fe op ``name``: the extremes of what it admits first."""
    top = tcb.FE_OPS[name][3]
    edge = tcb.FE_EDGES + (tcb.FE_RAW_EDGES if top == R else ())
    xs = _values(n, 1, edge, top)
    ys = _values(n, 2, tcb.FE_EDGES[::-1], 2 * P)
    return xs, ys


def _fe_check(name, xs, ys, got):
    _, want, bound, _ = tcb.FE_OPS[name]
    assert all(g < bound for g in got), name
    if name == "is_zero":
        assert got == [want(x, 0) for x in xs]
    else:
        assert [g % P for g in got] == [want(x, y) for x, y in zip(xs, ys)], name


@pytest.mark.parametrize("op", sorted(tcb.FE_OPS))
def test_field_ops_on_host_match_ints(host_lib, op):
    """Lazy reduction: every result below 2p (the canonical output below
    p), equal to the operation mod p, at the extremes of what each
    operation admits: values below 2p, and any value below 2^384 into and
    out of the Montgomery domain (2p - 1 times 2p - 1 is below p R, so the
    product needs no final subtraction)."""
    xs, ys = _fe_cases(op, 40)
    a, b = _words(xs), _words(ys)
    out = np.zeros_like(a)
    host_lib.bls_g1_fe_op_host(tcb.FE_OPS[op][0], a.ctypes.data, b.ctypes.data,
                               out.ctypes.data, len(xs))
    _reset(host_lib)
    _fe_check(op, xs, ys, _ints(out))


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


def _raw(pt) -> bytes:
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")


def _oracle(pub: bytes, k: int):
    """k * P by the pure-Python oracle, affine or None (any point on the
    curve, in the subgroup or not)."""
    if pub[0] & 0x40:
        return None
    x = int.from_bytes(bytes([pub[0] & 0x1F]) + pub[1:48], "big")
    y = int.from_bytes(pub[48:], "big")
    return tbls.E1.affine(tbls.E1.mul_scalar((x, y, 1), k))


def _host(lib, pubs, ks, nbits=128):
    pts = np.frombuffer(b"".join(pubs), np.uint8).copy()
    sc = tg1.scalars_to_bytes([k & ((1 << nbits) - 1) for k in ks], nbits).copy()
    out = np.zeros((len(pubs), 144), np.uint8)
    lib.bls_g1_host(pts.ctypes.data, sc.ctypes.data, out.ctypes.data, len(pubs), nbits)
    return out


def _plain(pubs, ks, nbits=128) -> np.ndarray:
    return tcb.scalar_mul_cuda(
        torch.from_numpy(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 96).copy()),
        torch.from_numpy(tg1.scalars_to_bytes(ks, nbits).copy()), nbits).numpy()


def test_ladder_on_host_equals_plain_and_oracle(host_lib):
    pubs, ks = _lanes(12, 3)
    got = _host(host_lib, pubs, ks)
    plain = _plain(pubs, ks)
    assert tg1.points_equal(got, plain).all()  # the same points, not bytes
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
    _reset(host_lib)


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
    _reset(host_lib)


def _digits(lib, ks, nbits=128) -> list:
    """The host build's signed digits of each scalar, least significant
    first."""
    sc = tg1.scalars_to_bytes(ks, nbits).copy()
    count = (nbits + W) // W
    digits = np.zeros((len(ks), count), np.int32)
    assert lib.bls_g1_recode_host(sc.ctypes.data, len(ks), nbits,
                                  digits.ctypes.data) == count
    return digits.tolist()


def _full_scalars(lib, n, seed, nbits=128):
    """Scalars of nbits bits whose signed digits are all nonzero."""
    rng, out = random.Random(seed), []
    while len(out) < n:
        k = rng.getrandbits(nbits) | 1 << (nbits - 1)
        if all(_digits(lib, [k], nbits)[0]):
            out.append(k)
    return out


def test_kernel_tally_equals_the_stated_counts(host_lib):
    """The host build's tally of full lanes (every digit nonzero: what a
    warp runs in step) equals the counts the wrapper states; a lane with a
    digit 0 or a short scalar costs less."""
    _reset(host_lib)
    pubs = _lanes(9, 4)[0][4:]
    ks = _full_scalars(host_lib, len(pubs), 4)
    _host(host_lib, pubs, ks)
    full = (tcb.FIELD_MULS_PER_LANE, tcb.FIELD_SQUARES_PER_LANE,
            tcb.FIELD_SMALLS_PER_LANE)
    assert _tally(host_lib) == tuple(len(ks) * v for v in full)
    assert full[:2] == (691, 801)
    assert tcb.WIDE_PRODUCTS_PER_LANE == 300 * (691 + 801) == 447_600
    # less: a digit 0 (no addition), short scalars (fewer doublings)
    rng = random.Random(9)
    for k, nbits in [(5, 128), (0x1234, 16), (1, 1), (rng.getrandbits(13), 13),
                     (0, 128)]:
        _host(host_lib, pubs[:1], [k], nbits)
        got = _tally(host_lib)
        assert all(g <= f for g, f in zip(got, full)) and got[:2] != full[:2], (k, nbits)
    # the identity costs nothing
    _host(host_lib, [tg1.INFINITY], [rng.getrandbits(128)])
    assert _tally(host_lib) == (0, 0, 0)
    _reset(host_lib)


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
    # ~127 doublings and ~20 additions with their tables: this kernel's
    # Jacobian windows (full Jacobian additions, squares by the product
    # code) run ~1.4x that; the parent's complete formulas ran 2.94x
    assert 300_000 < per < 330_000
    assert 1.3 < tcb.WIDE_PRODUCTS_PER_LANE / per < 1.55
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
    with pytest.raises(ValueError, match="card"):
        tcb.fe_op_cuda(2, torch.zeros(1, 12, dtype=torch.int32),
                       torch.zeros(1, 12, dtype=torch.int32))


def test_exceptional_branches_are_taken_and_right(group_lib):
    """The order-3 point (0, 2) and its negation, outside the subgroup,
    at scalars 1-7 and a 128-bit one: building its table doubles the
    identity, adds to the identity (a copy), meets H = 0 with r != 0 (P +
    2P) and with r = 0 (P + P); the identity input at several scalars.
    Every lane equals the oracle at G = 1, 2 and 4."""
    g, lib = group_lib
    _reset(lib)
    o3, o3n = _raw(ORDER3), _raw((0, P - 2))
    ks = list(range(1, 8)) + [(1 << 127) | 0xF00D]
    pubs = [o3] * len(ks) + [o3n] * len(ks) + [tg1.INFINITY] * 4
    ks = ks + ks + [0, 1, 7, (1 << 128) - 1]
    got = tg1.affine(_host(lib, pubs, ks))
    assert got == [_oracle(p, k) for p, k in zip(pubs, ks)]
    assert got[2] is None and got[0] == ORDER3 and got[1] == (0, P - 2)
    assert all(b > 0 for b in _branches(lib)), _branches(lib)
    # a subgroup lane takes none of the H = 0 branches
    _host(lib, [tbls.g1_serialize(tbls.G1_GEN)], _full_scalars(lib, 1, 3))
    assert _branches(lib)[3:] == [0, 0]
    _reset(lib)


EDGE_SCALARS = [0, 1, 2, 2 ** W - 1, 2 ** W, 2 ** (W - 1), (1 << 128) - 1,
                1 << 127]


@pytest.mark.parametrize("nbits", [128, 16, 1, 7, 13, 127])
def test_scalar_and_width_edges_equal_the_oracle(group_lib, nbits):
    """The scalars 0, 1, 2, 2^w - 1, 2^w, 2^(w-1), 2^128 - 1 and 2^127
    (cut to nbits), 2^nbits - 1 and 0x1234 at each width: 1, widths that
    are not a multiple of w, 16 (the self-check's) and 128."""
    g, lib = group_lib
    pubs, _ = _lanes(6, 11)
    gen = tbls.g1_serialize(tbls.G1_GEN)
    ks = [k & ((1 << nbits) - 1) for k in EDGE_SCALARS
          + [(1 << nbits) - 1, 0x1234, random.Random(nbits).getrandbits(128)]]
    lanes = [gen, pubs[5]] * len(ks)
    ks = [k for k in ks for _ in range(2)]
    got = _host(lib, lanes, ks, nbits)
    assert tg1.affine(got) == [_oracle(p, k) for p, k in zip(lanes, ks)]
    _reset(lib)


def test_recoding_sums_to_the_scalar(host_lib):
    """Booth's signed digits: ceil((nbits + 1) / w) of them, each in
    [-2^(w-1), 2^(w-1)], sum d_i 2^(wi) = s (its low nbits), the top one
    not negative."""
    w = W
    rng = random.Random(12)
    for nbits in (128, 16, 1, 7, 13, 127):
        ks = [k & ((1 << nbits) - 1) for k in EDGE_SCALARS
              + [(1 << nbits) - 1, 0x1234] + [rng.getrandbits(128) for _ in range(20)]]
        for k, row in zip(ks, _digits(host_lib, ks, nbits)):
            assert len(row) == -(-(nbits + 1) // w)
            assert sum(d << (w * i) for i, d in enumerate(row)) == k
            assert all(-(1 << (w - 1)) <= d <= 1 << (w - 1) for d in row)
            assert row[-1] >= 0


def test_schedule_has_no_hazards_and_the_stated_rounds(group_lib):
    """No task of a level writes a slot another task of that level reads
    or writes (OUT counted as IN1), so the group may run a level in any
    order; the levels one thread runs in a full lane equal the wrapper's
    ``MUL_ROUNDS_PER_LANE`` and ``ADD_ROUNDS_PER_LANE``; the build reports
    its G, W, lanes per block and shared memory."""
    g, lib = group_lib
    assert lib.bls_g1_schedule_check_host() == 0
    vals = [ctypes.c_int() for _ in range(4)]
    lib.bls_g1_config(*map(ctypes.byref, vals))
    group, window, lanes, smem = (v.value for v in vals)
    assert (group, window, lanes) == (g, W, 32)
    assert smem == (3 + 3 * 8 + 10 + 1) * 12 * (lanes + 1) * 4 == 60_192
    _reset(lib)
    pub = tbls.g1_serialize(tbls.G1_GEN)
    ks = _full_scalars(lib, 2, 6)
    _host(lib, [pub] * 2, ks)
    mul, lin = tcb.MUL_ROUNDS_PER_LANE[g], tcb.ADD_ROUNDS_PER_LANE[g]
    assert _rounds(lib) == (2 * mul, 2 * lin)
    _reset(lib)


def test_host_build_is_the_same_at_each_group(host_lib, host_lib_g1, host_lib_g2):
    """The schedule run by one thread, two or four gives the same bytes,
    and the package's build is the G the wrapper states."""
    pubs, ks = _lanes(10, 13)
    pubs += [_raw(ORDER3)] * 3
    ks += [3, 4, (1 << 128) - 1]
    want = _host(host_lib, pubs, ks)
    assert (_host(host_lib_g1, pubs, ks) == want).all()
    assert (_host(host_lib_g2, pubs, ks) == want).all()
    vals = [ctypes.c_int() for _ in range(4)]
    host_lib.bls_g1_config(*map(ctypes.byref, vals))
    assert vals[0].value == tcb.THREADS_PER_LANE
    for lib in (host_lib, host_lib_g1, host_lib_g2):
        _reset(lib)


def test_points_equal():
    """Projective equality: a rescaled representative is equal, another
    point is not, and Z = 0 matches only Z = 0."""
    g = tbls.E1.affine(tbls.G1_GEN)
    h = tbls.E1.affine(tbls.E1.mul_scalar(tbls.G1_GEN, 2))

    def row(x, y, z):
        return np.frombuffer(b"".join(v.to_bytes(48, "big") for v in (x, y, z)), np.uint8)

    lam = 0x1234567
    a = np.stack([row(*g, 1), row(*g, 1), row(0, 1, 0), row(0, 1, 0), row(*h, 1)])
    b = np.stack([row(g[0] * lam % P, g[1] * lam % P, lam), row(*h, 1),
                  row(0, 5, 0), row(*g, 1), row(h[0] * 3 % P, h[1] * 3 % P, 3)])
    assert tg1.points_equal(a, b).tolist() == [True, False, True, False, True]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _device_inputs(pubs, ks, dev, nbits=128):
    pts = torch.from_numpy(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 96).copy())
    sc = torch.from_numpy(tg1.scalars_to_bytes(ks, nbits).copy())
    return pts.to(dev), sc.to(dev)


def _same(kern, plain) -> bool:
    return bool(tg1.points_equal(kern.cpu().numpy(), plain.cpu().numpy()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 31, 32, 33, 63, 64, 65, 129])
def test_kernel_matches_plain(card, n):
    pubs, ks = _lanes(max(n, 12), 6)
    pts, sc = _device_inputs(pubs[:n], ks[:n], card)
    before = tcb.launches
    kern = tcb.scalar_mul_cuda(pts, sc)
    torch.cuda.synchronize()
    assert tcb.launches == before + 1
    assert _same(kern, tg1.batch_scalar_mul_plain(pts, sc))


@pytest.mark.cuda
def test_kernel_matches_plain_at_10240_lanes(card):
    rng = np.random.default_rng(7)
    pubs, _ = _lanes(256, 7)
    pubs = [pubs[i] for i in rng.integers(0, 256, 10_240)]
    ks = [int.from_bytes(rng.bytes(16), "big") for _ in pubs]
    pts, sc = _device_inputs(pubs, ks, card)
    kern = tcb.scalar_mul_cuda(pts, sc)
    torch.cuda.synchronize()
    assert _same(kern, tg1.batch_scalar_mul_plain(pts, sc))
    got = tg1.affine(kern[:32].cpu().numpy())
    assert got == [tbls.E1.affine(tbls.E1.mul_scalar(tbls.g1_deserialize(p), k))
                   for p, k in zip(pubs[:32], ks[:32])]


@pytest.mark.cuda
def test_kernel_exceptional_lanes(card):
    """The order-3 point and its negation (both H = 0 branches), the
    identity, and the width edges, on the card against the oracle."""
    o3, o3n = _raw(ORDER3), _raw((0, P - 2))
    ks = list(range(1, 8)) + [(1 << 127) | 0xF00D]
    pubs = [o3] * 8 + [o3n] * 8 + [tg1.INFINITY] * 2
    ks = ks + ks + [0, 5]
    pts, sc = _device_inputs(pubs, ks, card)
    assert tg1.affine(tcb.scalar_mul_cuda(pts, sc).cpu().numpy()) == [
        _oracle(p, k) for p, k in zip(pubs, ks)]
    gen = tbls.g1_serialize(tbls.G1_GEN)
    for nbits in (1, 7, 16):
        ks = [k & ((1 << nbits) - 1) for k in EDGE_SCALARS + [0x1234]]
        pts, sc = _device_inputs([gen] * len(ks), ks, card, nbits)
        got = tg1.affine(tcb.scalar_mul_cuda(pts, sc, nbits).cpu().numpy())
        assert got == [_oracle(gen, k) for k in ks]


@pytest.mark.cuda
def test_field_ops_on_the_card_match_ints(card):
    """The PTX carry chains (which the host build never runs) at the same
    extreme operands as the host test."""
    for name, (code, _, _, _) in tcb.FE_OPS.items():
        xs, ys = _fe_cases(name, 64)
        a = torch.from_numpy(_words(xs).view(np.int32)).to(card)
        b = torch.from_numpy(_words(ys).view(np.int32)).to(card)
        got = _ints(tcb.fe_op_cuda(code, a, b).cpu().numpy().view(np.uint32))
        _fe_check(name, xs, ys, got)


@pytest.mark.cuda
def test_kernel_entry_points_and_occupancy(card):
    pubs, ks = _lanes(12, 8)
    pts = [tbls.E1.affine(tbls.g1_deserialize(p)) if p != tg1.INFINITY else None
           for p in pubs]
    assert tg1.batch_scalar_mul(pts, ks) == tg1.batch_scalar_mul(pts, ks, device="cpu")
    assert tg1.batch_scalar_mul(pts[:2], [0x1234] * 2, nbits=16) == tg1.batch_scalar_mul(
        pts[:2], [0x1234] * 2, nbits=16, device="cpu")
    occ = tcb.occupancy()
    assert occ["threads"] == occ["lanes_per_block"] * tcb.THREADS_PER_LANE
    assert occ["threads_per_lane"] == tcb.THREADS_PER_LANE
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 3
