"""The BLS12-381 G1 scalar-multiplication kernel's wrapper
(``csrc/bls_g1.cu``).

Counterpart of the XLA program ``_batch_mul_kernel`` of
``cometbft_tpu/ops/bls_g1.py``: raw 96-byte points and 16-byte scalars
in, canonical projective X || Y || Z (144 bytes a lane) out.  The kernel
runs one thread per lane over 12 x 32-bit Montgomery limbs, the MSB-first
double-and-add of ``wcurve.Curve.scalar_mul``.  For CUDA tensors the
wrapper launches the kernel or raises; for CPU tensors it runs the
kernel's plain PyTorch version, ``ops.bls_g1.batch_scalar_mul_plain``.
``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import bls_g1 as _plain
from cometbft_tpu_torch.ops.cuda_secp import wnaf_weight

NAME = "bls_g1"
SOURCE = "cometbft_tpu_torch/csrc/bls_g1.cu"
REPLACES = "cometbft_tpu/ops/bls_g1.py:91"

# The kernel's own work per lane at 128 bits, counted by a host build of its
# source (``-DBLS_TALLY``): 128 complete doublings (6 squares, 6 multiplies,
# 2 small multiplies) and 128 complete additions (12 multiplies, 2 small
# multiplies), and x, y into the Montgomery domain and X, Y, Z out of it
# (5 multiplies).  A square is a multiply there, and a multiply is a 12-word
# CIOS product: 144 products for a * b, 12 for the m_i and 144 for m_i * p.
# A small multiply (by b3 = 12) is four modular additions, no product.
# Every lane costs the same.  This is more than the function needs
# (``needed_work``).
FIELD_MULS_PER_LANE = 128 * 18 + 5
FIELD_SQUARES_PER_LANE = 128 * 6
FIELD_SMALLS_PER_LANE = 128 * 4
PRODUCTS_PER_MUL = 2 * 144 + 12
WIDE_PRODUCTS_PER_LANE = PRODUCTS_PER_MUL * (FIELD_MULS_PER_LANE
                                             + FIELD_SQUARES_PER_LANE)
# bytes each lane moves: the point, the scalar, X || Y || Z out
BYTES_PER_LANE = 96 + 16 + 144

# The least work the function needs, for the roofline bound: s * P in
# Jacobian coordinates (validated subgroup points need no complete
# formulas) with a width-w NAF of s (w chosen per lane, 2..8) over a table
# of the odd multiples P, 3P, ..., (2^(w-1) - 1)P on one global Z, as
# libsecp256k1's ecmult tables are.  Field operations (M multiplies, S
# squares; multiplications by small constants are additions, not counted),
# by the cheapest a = 0 formulas of the Explicit-Formulas Database:
DOUBLE_MS = (2, 5)     # dbl-2009-l, per digit position after the top one
ADD_MS = (7, 4)        # madd-2007-bl, a Jacobian point plus a table entry
ISO_MS = (3, 1)        # P onto the curve of 2P's Z: Z^2, Z^3, x Z^2, y Z^3
RESCALE_MS = (4, 1)    # an entry onto the global Z, and the running Z ratio
FINISH_MS = (1, 0)     # the result's Z times the global Z
# A multiply takes 144 products and 156 more to reduce (Montgomery), a
# square 78 + 156.
PRODUCTS_MS = (PRODUCTS_PER_MUL, 78 + 156)
NAF_WIDTHS = range(2, 9)
# G1's GLV endomorphism (x, y) -> (beta * x, y) acts as lambda = z^2 - 1
# ~ 2^127.43 (z the BLS parameter), so a 128-bit s splits as s1 + s2 *
# lambda with s2 in {0, 1}: it saves at most one doubling of s1 and costs an
# addition of beta * P when s2 = 1, never less work.  The bound counts none.
LAMBDA = 0xAC45A4010001A40200000000FFFFFFFF

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).bls_g1_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``)."""
    return _build.occupancy(NAME)


def _check(pts, scalars, nbits) -> int:
    n = pts.shape[0] if pts.dim() == 2 else -1
    if pts.dtype != torch.uint8 or tuple(pts.shape) != (n, 96):
        raise ValueError(f"pts: want ({n}, 96) uint8, got {tuple(pts.shape)} "
                         f"{pts.dtype}")
    if scalars.dtype != torch.uint8 or tuple(scalars.shape) != (n, 16):
        raise ValueError(f"scalars: want ({n}, 16) uint8, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if pts.device != scalars.device:
        raise ValueError(f"inputs lie on {pts.device} and {scalars.device}")
    if not 1 <= nbits <= _plain.MAX_BITS:
        raise ValueError(f"nbits {nbits} outside 1..{_plain.MAX_BITS}")
    return n


def scalar_mul_cuda(pts, scalars, nbits: int = _plain.MAX_BITS) -> torch.Tensor:
    """(n, 144) uint8 canonical X || Y || Z of s_i * P_i for (n, 96) uint8
    points and (n, 16) uint8 big-endian scalars (their low ``nbits`` bits).

    CUDA tensors: one launch of the kernel on the current stream (no
    padding: the kernel masks the ragged edge).  CPU tensors: the plain
    version."""
    n = _check(pts, scalars, nbits)
    dev = pts.device
    if dev.type == "cpu":
        return _plain.batch_scalar_mul_plain(pts, scalars, nbits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    ins = [t.contiguous() for t in (pts, scalars)]
    out = torch.empty((n, 144), dtype=torch.uint8, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ins[0].data_ptr(), ins[1].data_ptr(), out.data_ptr(), n, nbits,
                stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def lane_work(s: int) -> tuple[int, int]:
    """(multiplies, squares) that s * P needs: the cheapest width-w NAF
    ladder.  For w > 2 the table of 2^(w-2) odd multiples costs a
    doubling, the move of P onto 2P's curve, an addition and a rescale for
    each further entry, and the result's Z at the end; w = 2 adds P
    itself.  Then a doubling per digit position after the top one and an
    addition per nonzero digit after the first, which only sets."""
    if s == 0:
        return (0, 0)
    best = None
    for w in NAF_WIDTHS:
        digits, length = wnaf_weight(s, w)
        table = 1 << (w - 2)
        steps = [(DOUBLE_MS, length - 1), (ADD_MS, digits - 1)]
        if table > 1:
            steps += [(DOUBLE_MS, 1), (ISO_MS, 1), (ADD_MS, table - 1),
                      (RESCALE_MS, table - 1), (FINISH_MS, 1)]
        work = tuple(sum(ms[i] * k for ms, k in steps) for i in range(2))
        if best is None or _products(work) < _products(best):
            best = work
    return best


def _products(work) -> int:
    return sum(k * c for k, c in zip(work, PRODUCTS_MS))


def needed_work(scalars) -> tuple[int, int, int]:
    """(field multiplies, squares, 32x32->64-bit products) that s_i * P_i
    needs over these lanes' scalars (ints): the bound's work."""
    muls = squares = 0
    for s in scalars:
        m, q = lane_work(int(s))
        muls, squares = muls + m, squares + q
    return muls, squares, _products((muls, squares))
