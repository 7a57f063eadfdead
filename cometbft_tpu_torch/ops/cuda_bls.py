"""The BLS12-381 G1 scalar-multiplication kernel's wrapper
(``csrc/bls_g1.cu``).

Counterpart of the XLA program ``_batch_mul_kernel`` of
``cometbft_tpu/ops/bls_g1.py``: raw 96-byte points and 16-byte scalars
in, canonical projective X || Y || Z (144 bytes a lane) out.  The kernel
runs a group of ``THREADS_PER_LANE`` threads per lane over 12 x 32-bit
Montgomery limbs kept lazy in [0, 2p) (PTX carry chains): Jacobian
dbl-2009-l and add-2007-bl over signed 4-bit digits and a per-lane
table {1..8} P in shared memory, each formula a schedule of levels of
independent field operations that the group shares.  It hands out (X Z :
Y : Z^3) of its Jacobian result, so its bytes equal the plain version's
(``ops.bls_g1.batch_scalar_mul_plain``, RCB15's projective ladder) as
points, not as bytes: ``ops.bls_g1.points_equal`` compares them.  For CUDA
tensors the wrapper launches the kernel or raises; for CPU tensors it runs
the plain version.  ``launches`` counts kernel launches (and nothing
else), so a run can show that its main path went through the kernel.
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

THREADS_PER_LANE = 4  # BLS_GROUP of the package's build

# The kernel's own work per lane, counted by a host build of its source
# (``-DBLS_TALLY``, ``bls_g1_tally``) for a full 128-bit lane (the top bit
# set, no digit 0: what every lane of a warp runs in step): 2 multiplies
# into the domain, the table {1..8} P (4 doublings, 3 additions), 128
# doublings (2M + 5S) and 32 additions (12M + 4S: add-2007-bl with Z3 = 2
# (Z1 H) Z2), the top digit's copy, and 5M + 1S out to (X Z : Y : Z^3)
# and out of the domain.  A square is the product code on one operand, so
# every product is a 12-word CIOS product: 144 products for a * b, 12 for
# the m_i and 144 for m_i * p, with no final subtraction (the lazy bound).
# An addition (a sum or difference, doublings of it, 2p - y) takes no
# product.  A lane with zero digits or a short scalar costs less.  This is
# more than the function needs (``needed_work``).
FIELD_MULS_PER_LANE = 691
FIELD_SQUARES_PER_LANE = 801
FIELD_SMALLS_PER_LANE = 1574
PRODUCTS_PER_MUL = 2 * 144 + 12
WIDE_PRODUCTS_PER_LANE = PRODUCTS_PER_MUL * (FIELD_MULS_PER_LANE
                                             + FIELD_SQUARES_PER_LANE)
# The levels one thread of a group of G runs in a full lane, by G
# (``bls_g1_rounds`` of the host build at each G): multiply levels (a level
# of n products is ceil(n / G) of them: the lane's chain of dependent
# multiplies) and levels of additions alone.
MUL_ROUNDS_PER_LANE = {1: 1492, 2: 980, 4: 575}
ADD_ROUNDS_PER_LANE = {1: 706, 2: 670, 4: 669}
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


def config() -> dict:
    """The built kernel's threads per lane, bits per signed digit, lanes
    per block and dynamic shared memory bytes per block
    (``bls_g1_config``)."""
    fn = _build.load(NAME).bls_g1_config
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    vals = [ctypes.c_int() for _ in range(4)]
    fn(*map(ctypes.byref, vals))
    keys = ("threads_per_lane", "window", "lanes_per_block", "smem_bytes")
    return dict(zip(keys, (v.value for v in vals)))


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``: ``threads`` per block, ``shared_bytes`` static
    and dynamic), with its threads per lane and lanes per block."""
    cfg = config()
    return dict(_build.occupancy(NAME), threads_per_lane=cfg["threads_per_lane"],
                lanes_per_block=cfg["lanes_per_block"])


# fe_op_cuda's operations, for the checks that hold it (and the host
# build's bls_g1_fe_op_host) to Python integers: name -> (code, its value
# mod p, the bound of its result, the bound of its operands).  Values below
# 2p (the lazy domain); into and out of the Montgomery domain (R = 2^384)
# take any value below R, out of it gives the canonical value.
_P = _plain.P
_R = 1 << 384
_R_INV = pow(_R, -1, _P)
FE_OPS = {
    "add": (0, lambda a, b: (a + b) % _P, 2 * _P, 2 * _P),
    "sub": (1, lambda a, b: (a - b) % _P, 2 * _P, 2 * _P),
    "mul": (2, lambda a, b: a * b * _R_INV % _P, 2 * _P, 2 * _P),
    "square": (3, lambda a, b: a * a * _R_INV % _P, 2 * _P, 2 * _P),
    "times8": (4, lambda a, b: 8 * a % _P, 2 * _P, 2 * _P),
    "to_mont": (5, lambda a, b: a * _R % _P, 2 * _P, _R),
    "from_mont": (6, lambda a, b: a * _R_INV % _P, _P, _R),
    "is_zero": (7, lambda a, b: int(a % _P == 0), 2, 2 * _P),
}
# the extremes of the lazy domain [0, 2p), and of the raw one [0, R)
FE_EDGES = (0, 1, 2, _P - 1, _P, _P + 1, 2 * _P - 2, 2 * _P - 1, (_P + 1) // 2,
            (1 << 381) - 1)
FE_RAW_EDGES = (_R - 1, 1 << 383, _R - _P, 2 * _P, 4 * _P)


@lru_cache(maxsize=1)
def _fe_op():
    fn = _build.load(NAME).bls_g1_fe_op
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fe_op_cuda(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's field operation ``op`` (``fe_op`` in the source: 0 add,
    1 sub, 2 multiply, 3 square, 4 times 8, 5 into the Montgomery domain, 6
    out of it, 7 the zero test) on the card, on (n, 12) int32 tensors of
    little-endian 32-bit words: the PTX carry chains, which the host build
    never runs.  A check, not the main path: it counts no launch."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != 12 or \
            a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"want two (n, 12) int32 tensors, got {tuple(a.shape)}"
                         f" {a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"fe_op_cuda runs on a card, got {a.device}, {b.device}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _fe_op()(op, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      a.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} field op launch failed: CUDA error {rc}")
    return out


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
    """(n, 144) uint8 canonical X || Y || Z, a projective representative
    of s_i * P_i, for (n, 96) uint8 points and (n, 16) uint8 big-endian
    scalars (their low ``nbits`` bits).

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


# The lane sum of ``ops.bls_g1.msm`` folds B products with B - 1 additions
# of two Jacobian points (add-2007-bl, the cheapest general addition).
SUM_ADD_MS = (11, 5)


def msm_needed_work(scalars) -> tuple[int, int, int]:
    """(field multiplies, squares, products) that the sum of s_i * P_i
    needs: ``needed_work`` and B - 1 additions."""
    muls, squares, _ = needed_work(scalars)
    adds = max(len(scalars) - 1, 0)
    muls, squares = muls + adds * SUM_ADD_MS[0], squares + adds * SUM_ADD_MS[1]
    return muls, squares, _products((muls, squares))


def needed_work(scalars) -> tuple[int, int, int]:
    """(field multiplies, squares, 32x32->64-bit products) that s_i * P_i
    needs over these lanes' scalars (ints): the bound's work."""
    muls = squares = 0
    for s in scalars:
        m, q = lane_work(int(s))
        muls, squares = muls + m, squares + q
    return muls, squares, _products((muls, squares))
