"""The secp256k1 ECDSA verify kernel's wrapper (``csrc/secp256k1_verify.cu``).

Counterpart of the XLA ladder ``_ladder_kernel`` of
``cometbft_tpu/ops/secp_verify.py`` (with the host decompression and
compare around it there): raw bytes in, accept bits out.  The kernel runs a
quad of four threads per signature: u1 in two 128-bit halves over G and
2^128*G, u2 split by the GLV endomorphism on the card over Q and lambda*Q,
each thread one short scalar in signed radix-8 digits over its own table
in shared memory, the four partial points added at the end through warp
shuffles.  For CUDA tensors the wrapper launches the kernel or raises;
for CPU tensors it runs the kernel's plain PyTorch version,
``ops.secp_verify.verify_core``.  ``launches`` counts kernel launches (and
nothing else), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from cometbft_tpu_torch.crypto.secp256k1 import (G, N, P, double_mul, g_mul,
                                                  pt_compress, pt_decompress)
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import secp_verify as _plain

NAME = "secp256k1_verify"
SOURCE = "cometbft_tpu_torch/csrc/secp256k1_verify.cu"
REPLACES = "cometbft_tpu/ops/secp_verify.py:117"

# The kernel's own work per signature, counted by a host build of its
# source (``-DSECP_TALLY``), which runs a lane's four threads in turn and then
# the combine and compare as each of them runs it on the card.  Per thread:
# the square root of decompression (253 squares + 13 multiplies) with x^3,
# y^2 and beta*x; its table {1..4}*P (2 doublings, 1 addition); the walk of
# 43 positions (3 doublings and 1 addition each, after the top digit's
# lookup); the two additions of the combine; r*Z and (r + n)*Z.  A doubling
# is 6 squares, 6 multiplies and 2 small multiplies by b3, an addition 12
# multiplies and 2 small ones.  A multiply takes 64 32x32->64-bit products
# and 8 more to reduce, a square 36 + 8, a small multiply 8; the GLV split
# takes two 8 x 8-word products and four 160-bit low halves of 4 x 5 words
# (14 products each), outside the field tally.  Every lane with ``ok`` set
# costs the same.  This is more than the function needs (``needed_work``).
THREADS_PER_SIG = 4
FIELD_MULS_PER_SIG = 4 * 1355
FIELD_SQUARES_PER_SIG = 4 * 1041
FIELD_SMALLS_PER_SIG = 4 * 354
PRODUCTS_PER_MUL = 72
PRODUCTS_PER_SQUARE = 44
PRODUCTS_PER_SMALL = 8
KERNEL_SPLIT_PRODUCTS = 2 * 64 + 4 * 14
WIDE_PRODUCTS_PER_SIG = (PRODUCTS_PER_MUL * FIELD_MULS_PER_SIG
                         + PRODUCTS_PER_SQUARE * FIELD_SQUARES_PER_SIG
                         + PRODUCTS_PER_SMALL * FIELD_SMALLS_PER_SIG
                         + THREADS_PER_SIG * KERNEL_SPLIT_PRODUCTS)
# bytes each signature moves: the 33-byte key, u1, u2, r, ok, one int32 out
BYTES_PER_SIG = 33 + 3 * 32 + 1 + 4

# The least work the function needs, for the roofline bound: ECDSA
# verification as libsecp256k1's secp256k1_ecdsa_verify does it
# (ecmult_strauss_wnaf at its default windows), counted per lane from the
# lane's own scalars.  u2 is split by the GLV endomorphism (u2 = k1 +
# k2*LAMBDA mod n, |k1|, |k2| < 2^129; lambda*(x, y) = (BETA*x, y)), u1 into
# its two 128-bit halves over precomputed tables of G and 2^128*G; one
# Straus ladder then runs over the four width-w NAFs.  Field operations, by
# libsecp256k1's own counts (M multiplies, S squares):
DECOMPRESS_MS = (14, 255)   # x^3 + 7, the square root, y^2 == x^3 + 7
TABLE_MS = (98, 33)         # Q's 8 odd multiples on one global Z, and lambda's
DOUBLE_MS = (3, 4)          # gej_double, per digit position after the top one
ADD_Q_MS = (8, 3)           # gej_add_ge_var, per nonzero digit of k1, k2
ADD_G_MS = (9, 3)           # gej_add_zinv_var, per nonzero digit of u1's halves
FINISH_MS = (2, 1)          # Z times the global Z; X == r*Z^2
# The split: two 256x256-bit products and three of 128-bit operands
SPLIT_PRODUCTS = 2 * 64 + 2 * 16 + 32
WINDOW_Q, WINDOW_G = 5, 15
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
# a reduced basis of the lattice {(a, b): a + b*LAMBDA = 0 mod n}; b2 = a1
_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).secp256k1_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``)."""
    return _build.occupancy(NAME)


def _check(q33, u1, u2, r, ok) -> int:
    n = q33.shape[0] if q33.dim() == 2 else -1
    if q33.dtype != torch.uint8 or tuple(q33.shape) != (n, 33):
        raise ValueError(f"q33: want ({n}, 33) uint8, got {tuple(q33.shape)} "
                         f"{q33.dtype}")
    for name, t in (("u1", u1), ("u2", u2), ("r", r)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (n, 32):
            raise ValueError(f"{name}: want ({n}, 32) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ok.dtype not in (torch.uint8, torch.bool) or tuple(ok.shape) != (n,):
        raise ValueError(f"ok: want ({n},) uint8/bool, got {tuple(ok.shape)} "
                         f"{ok.dtype}")
    devices = {t.device for t in (q33, u1, u2, r, ok)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return n


def glv_split(k: int) -> tuple[int, int]:
    """(k1, k2) with k = k1 + k2*LAMBDA (mod n), each below 2^129 in
    magnitude (Babai rounding against the reduced basis)."""
    c1 = (_A1 * k + N // 2) // N
    c2 = (-_B1 * k + N // 2) // N
    return k - c1 * _A1 - c2 * _A2, -c1 * _B1 - c2 * _A1


def wnaf_weight(k: int, w: int) -> tuple[int, int]:
    """(nonzero digits, length) of the width-``w`` NAF of |k|."""
    k, digits, top, pos = abs(k), 0, 0, 0
    while k:
        tz = (k & -k).bit_length() - 1
        k >>= tz
        pos += tz
        d = k & ((1 << w) - 1)
        if d >> (w - 1):
            d -= 1 << w
        k = (k - d) >> w
        digits, top = digits + 1, pos
        pos += w
    return digits, top + 1 if digits else 0


def needed_work(q33, u1, u2, ok) -> tuple[int, int, int]:
    """(field multiplies, field squares, 32x32->64-bit products) that ECDSA
    verification needs on these lanes (numpy arrays as
    ``secp_verify.prepare_batch`` returns them): the bound's work.  A lane
    the host rejected needs nothing; a key off the curve, its
    decompression."""
    muls = squares = split = 0

    def add(ms, k=1):
        nonlocal muls, squares
        muls += ms[0] * k
        squares += ms[1] * k

    big = lambda row: int.from_bytes(row.tobytes(), "big")
    for i in np.flatnonzero(ok):
        add(DECOMPRESS_MS)
        if pt_decompress(q33[i].tobytes()) is None:
            continue
        a, b = big(u1[i]), big(u2[i])
        q = [wnaf_weight(k, WINDOW_Q) for k in glv_split(b)] if b else []
        g = [wnaf_weight(k, WINDOW_G) for k in (a & ((1 << 128) - 1), a >> 128)]
        dq, dg = sum(d for d, _ in q), sum(d for d, _ in g)
        if dq:
            split += SPLIT_PRODUCTS
            add(TABLE_MS)
        if dq + dg:
            add(DOUBLE_MS, max(n for _, n in q + g) - 1)
            add(ADD_Q_MS, dq)
            add(ADD_G_MS, dg)
            add(ADD_G_MS if dg else ADD_Q_MS, -1)  # the first only sets
            add(FINISH_MS)
    return muls, squares, (PRODUCTS_PER_MUL * muls + PRODUCTS_PER_SQUARE * squares
                           + split)


def edge_lanes(seed: int) -> tuple[dict, list]:
    """Lanes at the edges of the kernel's scalars and points, as numpy
    arrays in ``secp_verify.prepare_batch``'s form, and the verdicts they
    must get: u1 = 0 (two partial points O); Q = G; u1 = n - 1 (both halves
    of u1 full); u2 = n - 1; x(R') >= n, so that only X = (r + n)*Z holds
    (Q.x >= n, u1 = 0, u2 = 1); each with r = x(R') mod n (accepted) and
    with r + 1 (rejected); and Q = -G with u1 = u2, so R' = O (rejected,
    r = 0 = X)."""
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(32), "big") % N
    key = g_mul(rand())
    x = N
    while pt_decompress(b"\x02" + x.to_bytes(32, "big")) is None:
        x += 1
    big = pt_decompress(b"\x02" + x.to_bytes(32, "big"))
    u = rand()
    cases = [(key, 0, rand()), (G, rand(), rand()), (key, N - 1, rand()),
             (key, rand(), N - 1), (big, 0, 1)]
    lanes = [c + (dr,) for c in cases for dr in (0, 1)]
    lanes.append(((G[0], P - G[1]), u, u, 0))
    rows, want = {"q33": [], "u1": [], "u2": [], "r": []}, []
    for q, u1, u2, dr in lanes:
        point = double_mul(u1, u2, q)
        r = (point[0] % N if point is not None else 0) + dr
        want.append(point is not None and dr == 0)
        rows["q33"].append(list(pt_compress(q)))
        for name, v in (("u1", u1), ("u2", u2), ("r", r)):
            rows[name].append(list(v.to_bytes(32, "big")))
    arrays = {k: np.array(v, np.uint8) for k, v in rows.items()}
    arrays["ok"] = np.ones(len(want), bool)
    return arrays, want


def verify_core_cuda(q33, u1, u2, r, ok) -> torch.Tensor:
    """(B,) bool accept bits for (B, 33) keys, (B, 32) big-endian u1, u2,
    r and (B,) ok.

    CUDA tensors: one launch of the kernel on the current stream (no
    padding: the kernel masks the ragged edge).  CPU tensors: the plain
    version."""
    n = _check(q33, u1, u2, r, ok)
    dev = q33.device
    if dev.type == "cpu":
        return _plain.verify_core(q33, u1, u2, r, ok)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    ins = [t.contiguous() for t in (q33, u1, u2, r)]
    flag = ok.to(torch.uint8).contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), flag.data_ptr(), out.data_ptr(),
                n, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out != 0
