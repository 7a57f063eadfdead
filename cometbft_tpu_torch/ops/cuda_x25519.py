"""The X25519 ladder kernel's wrapper (``csrc/x25519_ladder.cu``).

Counterpart of the XLA program ``_ladder_fn`` (with ``_inv``) of
``cometbft_tpu/ops/x25519_ladder.py``: (lanes, 32) uint8 clamped scalars
and u-coordinates in, (lanes, 32) uint8 canonical shared u out.  The
kernel runs a quad of four threads per lane, one coordinate of x2, z2,
x3, z3 each: the RFC 7748 ladder over bits 254..0 in levels of one field
operation per thread (swaps by masks on values taken from the partner),
then the 2^255 - 21 inversion in lockstep and a freeze.  For CUDA
tensors the wrapper launches the kernel on the current stream or raises;
for CPU tensors it runs the kernel's plain PyTorch version,
``ops.x25519_ladder.ladder_plain`` (``ladder_core`` on the scalars' bits).
``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import x25519_ladder as _plain

NAME = "x25519_ladder"
SOURCE = "cometbft_tpu_torch/csrc/x25519_ladder.cu"
REPLACES = "cometbft_tpu/ops/x25519_ladder.py:135 (_ladder_fn), :113 (_inv)"

# The work of one lane, counted by a host build of the source
# (``-DX25519_TALLY``): 255 ladder steps of 5 multiplies, 4 squares and one
# multiply by a24; the inversion's 254 squares and 11 multiplies; x2 times
# the inverse.  A multiply is 100 32x32->64-bit products, a square 55, a
# small multiply 10.
FIELD_MULS_PER_LANE = 255 * 5 + 12
FIELD_SQUARES_PER_LANE = 255 * 4 + 254
FIELD_SMALLS_PER_LANE = 255
WIDE_PRODUCTS_PER_LANE = (100 * FIELD_MULS_PER_LANE + 55 * FIELD_SQUARES_PER_LANE
                          + 10 * FIELD_SMALLS_PER_LANE)
BYTES_PER_LANE = 3 * 32  # scalar and u in, the shared u out

THREADS_PER_LANE = 4  # a quad
THREADS_PER_BLOCK = 128  # X25519_THREADS in the source
# The kernel's own work per lane, counted by its host build (the results
# that are used): a step's 4 + 4 + 1 multiplies (levels 2-4; AA and BB as
# multiplies, so that the quad runs one operation) and a small multiply;
# the inversion once; x2 times the inverse.
KERNEL_MULS_PER_LANE = 255 * 9 + 12
KERNEL_SQUARES_PER_LANE = 254
KERNEL_SMALLS_PER_LANE = 255
KERNEL_PRODUCTS_PER_LANE = (100 * KERNEL_MULS_PER_LANE
                            + 55 * KERNEL_SQUARES_PER_LANE
                            + 10 * KERNEL_SMALLS_PER_LANE)
# Field operations one after another in a lane: 3 multiplies and a small
# multiply a step in the quad, the inversion's 265 and the last multiply;
# 10 a step in one thread.
DEPENDENT_OPS_PER_LANE = 255 * 4 + 266
ONE_THREAD_DEPENDENT_OPS_PER_LANE = 255 * 10 + 266

launches = 0
_COUNT_LOCK = threading.Lock()  # the transport plane launches from many threads


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).x25519_ladder_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``)."""
    return _build.occupancy(NAME)


def ladder(scalars: torch.Tensor, u_bytes: torch.Tensor) -> torch.Tensor:
    """(lanes, 32) uint8 X25519(scalar, u) of clamped ``scalars`` and
    ``u_bytes``, both (lanes, 32) uint8.

    CUDA tensors: one launch on the current stream, no synchronisation.
    CPU tensors: the plain version."""
    for name, t in (("scalars", scalars), ("u_bytes", u_bytes)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or t.shape[0] < 1:
            raise ValueError(f"{name}: want (lanes, 32) uint8 with lanes >= 1, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if scalars.shape != u_bytes.shape or scalars.device != u_bytes.device:
        raise ValueError(f"scalars {tuple(scalars.shape)} on {scalars.device} "
                         f"and u {tuple(u_bytes.shape)} on {u_bytes.device} "
                         f"differ")
    dev = scalars.device
    if dev.type == "cpu":
        return _plain.ladder_plain(scalars, u_bytes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    scalars, u_bytes = scalars.contiguous(), u_bytes.contiguous()
    out = torch.empty_like(scalars)  # 8-byte aligned: a thread stores 8 bytes
    launch = _launcher()
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(scalars.data_ptr(), u_bytes.data_ptr(), scalars.shape[0],
                    out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
        with _COUNT_LOCK:
            launches += 1
    return out
