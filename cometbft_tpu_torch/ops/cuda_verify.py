"""The Ed25519 verify kernel's wrapper (``csrc/ed25519_verify.cu``).

Counterpart of ``cometbft_tpu/ops/pallas_verify.py``: raw bytes in, accept
bits out, four threads per signature.  For CUDA tensors the wrapper launches
the kernel or raises; for CPU tensors it runs the kernel's plain PyTorch
version, ``ops.verify.verify_core``.  ``launches`` counts kernel launches
(and nothing else), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import verify as _plain

NAME = "ed25519_verify"
SOURCE = "cometbft_tpu_torch/csrc/ed25519_verify.cu"
REPLACES = "cometbft_tpu/ops/pallas_verify.py:94"

# Work per signature, counted from the kernel's code path (two
# decompressions, the {0..8}*A table, 64 Straus positions, the final
# subtraction and three doublings) and checked against a host build of the
# same source: field multiplies take 100 32x32->64-bit products, squares 55.
FIELD_MULS_PER_SIG = 1914
FIELD_SQUARES_PER_SIG = 1546
PRODUCTS_PER_MUL = 100
PRODUCTS_PER_SQUARE = 55


def wide_products(muls: int, squares: int) -> int:
    """32x32->64-bit products in ``muls`` field multiplies and ``squares``
    field squares of the kernel's field code (``csrc/fe25519.cuh``)."""
    return PRODUCTS_PER_MUL * muls + PRODUCTS_PER_SQUARE * squares


WIDE_PRODUCTS_PER_SIG = wide_products(FIELD_MULS_PER_SIG, FIELD_SQUARES_PER_SIG)
THREADS_PER_SIG = 4
# bytes each signature moves: four 32-byte inputs, s_ok, one int32 out
BYTES_PER_SIG = 4 * 32 + 1 + 4

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# Radix 2^25.5: limb i starts at bit 25*i + ceil(i/2); 26 bits even, 25 odd.
LIMB_OFF = [25 * i + (i + 1) // 2 for i in range(10)]
LIMB_BITS = [26 if i % 2 == 0 else 25 for i in range(10)]


def limbs25(n: int) -> list[int]:
    """Canonical radix-2^25.5 limbs of n mod p (the kernel's layout)."""
    n %= ref.P
    return [(n >> LIMB_OFF[i]) & ((1 << LIMB_BITS[i]) - 1) for i in range(10)]


@lru_cache(maxsize=1)
def base_table_limbs() -> tuple:
    """(9 * 3 * 10,) ints: niels triples (y+x, y-x, 2dxy) of k*B, k = 0..8,
    in the kernel's radix, from the port's ``ed25519_ref``."""
    out = []
    for k in range(9):
        if k == 0:
            x, y = 0, 1
        else:
            X, Y, Z, _ = ref.pt_mul(k, ref.BASE)
            zi = pow(Z, ref.P - 2, ref.P)
            x, y = X * zi % ref.P, Y * zi % ref.P
        for v in ((y + x), (y - x), 2 * ref.D * x * y):
            out.extend(limbs25(v))
    return tuple(out)


@lru_cache(maxsize=8)
def base_table(device: torch.device) -> torch.Tensor:
    return torch.tensor(base_table_limbs(), dtype=torch.int32, device=device)


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).ed25519_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy() -> dict:
    """The kernel's launch resources on the current card: resident blocks
    per SM, threads per block, and registers, local memory bytes per thread
    and static shared memory bytes per block of the compiled kernel."""
    fn = _build.load(NAME).ed25519_verify_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(5)]
    rc = fn(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"{NAME} occupancy query failed: CUDA error {rc}")
    keys = ("blocks_per_sm", "threads", "regs", "local_bytes", "shared_bytes")
    return dict(zip(keys, (v.value for v in vals)))


def _check(a_bytes, r_bytes, s_bytes, m_bytes, s_ok) -> int:
    n = a_bytes.shape[0] if a_bytes.dim() == 2 else -1
    for name, t in (("a_bytes", a_bytes), ("r_bytes", r_bytes),
                    ("s_bytes", s_bytes), ("m_bytes", m_bytes)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (n, 32):
            raise ValueError(f"{name}: want ({n}, 32) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if s_ok.dtype not in (torch.uint8, torch.bool) or tuple(s_ok.shape) != (n,):
        raise ValueError(f"s_ok: want ({n},) uint8/bool, got "
                         f"{tuple(s_ok.shape)} {s_ok.dtype}")
    devices = {t.device for t in (a_bytes, r_bytes, s_bytes, m_bytes, s_ok)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return n


def verify_core_cuda(a_bytes, r_bytes, s_bytes, m_bytes, s_ok) -> torch.Tensor:
    """(B,) bool accept bits for (B, 32) uint8 a/r/s/m bytes and (B,) s_ok.

    CUDA tensors: one launch of the kernel on the current stream (no
    padding: the kernel masks the ragged edge).  CPU tensors: the plain
    version."""
    n = _check(a_bytes, r_bytes, s_bytes, m_bytes, s_ok)
    dev = a_bytes.device
    if dev.type == "cpu":
        return _plain.verify_core(a_bytes, r_bytes, s_bytes, m_bytes, s_ok)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    ins = [t.contiguous() for t in (a_bytes, r_bytes, s_bytes, m_bytes)]
    ok = s_ok.to(torch.uint8).contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    tbl = base_table(dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), ok.data_ptr(), tbl.data_ptr(),
                out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out != 0

