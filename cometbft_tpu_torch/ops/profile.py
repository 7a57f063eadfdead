"""Measurement kernels: the verify kernel's stage builds and field-op chains.

Counterparts of the JAX package's two Pallas measurement scripts:

* ``scripts/bench_kernel_stages.py`` (``make_stage_kernel``) times the
  verify kernel stopped after each stage.  Here the same source,
  ``csrc/ed25519_verify.cu``, is built with ``-DED25519_STAGE=1|2|3``
  (``_build.VARIANTS``): it stops after decompressing A and R, after the
  {0..8}*A table, or after the Straus walk.  ``verify_stage`` launches one
  and returns ok_A | ok_R << 1 per signature.
* ``scripts/bench_pallas_chain.py`` (``make_chain``) times K chained field
  multiplies, squares or adds.  Here ``csrc/fe_chain.cu`` runs the verify
  kernel's own field code (``csrc/fe25519.cuh``); ``fe_chain`` launches it.

Each wrapper launches its kernel on CUDA tensors and raises for any other:
they measure the card and have no caller on the CPU.  The plain PyTorch
versions are ``decompress_oks`` (``ops.verify._decompress_pair``) for the
stages and ``fe_chain_plain`` (``ops.fe25519``) for the chains.
``launches`` counts the kernel launches by build name.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import cuda_verify as cv
from cometbft_tpu_torch.ops import fe25519 as fe
from cometbft_tpu_torch.ops import verify as ov

STAGES = {1: "decompress", 2: "table", 3: "ladder"}
# (field multiplies, squares) per signature up to the end of each stage,
# as the host build's tally counts them: A and R decompressed, their T
# products and R's cached form; then the {0..8}*A table; then the walk.
STAGE_WORK = {1: (41, 510), 2: (106, 510), 3: (1898, 1534)}

CHAIN = "fe_chain"
CHAIN_SOURCE = "cometbft_tpu_torch/csrc/fe_chain.cu"
CHAIN_REPLACES = "scripts/bench_pallas_chain.py:45"
CHAIN_OPS = {"mul": 0, "square": 1, "add": 2}
# 32x32->64-bit products in one operation of each chain
PRODUCTS_PER_OP = {"mul": cv.PRODUCTS_PER_MUL, "square": cv.PRODUCTS_PER_SQUARE,
                   "add": 0}

launches = {CHAIN: 0, **{f"ed25519_verify_stage{k}": 0 for k in STAGES}}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _count(name: str) -> None:
    launches[name] += 1


# -- stage builds of the verify kernel --------------------------------------

@lru_cache(maxsize=None)
def _stage_launcher(stage: int):
    fn = _build.load(f"ed25519_verify_stage{stage}").ed25519_verify_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decompress_oks(a_bytes, r_bytes) -> torch.Tensor:
    """Plain version of a stage build's output: (B,) int32 ok_A | ok_R << 1
    from ``ops.verify._decompress_pair``."""
    ya, sa = fe.unpack255(a_bytes)
    yr, sr = fe.unpack255(r_bytes)
    ok_a, _, ok_r, _ = ov._decompress_pair(ya, sa, yr, sr)
    return ok_a.to(torch.int32) | (ok_r.to(torch.int32) << 1)


def verify_stage(stage: int, a_bytes, r_bytes, s_bytes, m_bytes, s_ok):
    """(B,) int32 ok_A | ok_R << 1 from the verify kernel stopped after
    ``stage`` (1 decompress, 2 table, 3 ladder); one launch on the current
    stream.  CUDA tensors only."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, got {stage}")
    n = cv._check(a_bytes, r_bytes, s_bytes, m_bytes, s_ok)
    dev = a_bytes.device
    if dev.type != "cuda":
        raise ValueError(f"stage builds run on a CUDA card, got {dev}")
    ins = [t.contiguous() for t in (a_bytes, r_bytes, s_bytes, m_bytes)]
    ok = s_ok.to(torch.uint8).contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _stage_launcher(stage)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), ok.data_ptr(),
                cv.base_table(dev).data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"stage {stage} kernel launch failed: CUDA error {rc}")
    _count(f"ed25519_verify_stage{stage}")
    return out & 3


# -- field-operation chains ---------------------------------------------------

def chain_input(n: int, seed: int) -> torch.Tensor:
    """(n, 10) int32 canonical radix-2^25.5 limbs of seeded field elements."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << b, size=n, dtype=np.int64) for b in cv.LIMB_BITS]
    return torch.from_numpy(np.stack(cols, axis=1).astype(np.int32))


def chain_reference(x: int, op: str, k: int) -> int:
    """What a chain of ``k`` steps computes from x, in Python integers."""
    p = fe.P_INT
    if op == "mul":
        return pow(x, k + 1, p)
    if op == "square":
        return pow(x, 1 << k, p)
    return (k + 1) * x % p


def int_of_limbs10(row) -> int:
    return sum(int(v) << off for v, off in zip(row, cv.LIMB_OFF))


def _limbs10_to_13(x: torch.Tensor) -> torch.Tensor:
    """(n, 10) canonical radix-2^25.5 limbs -> (20, n) 13-bit limbs."""
    x = x.to(torch.int64)
    bits = torch.cat(
        [(x[:, i : i + 1] >> torch.arange(w, device=x.device)) & 1
         for i, w in enumerate(cv.LIMB_BITS)],
        dim=1,
    )  # (n, 255)
    bits = torch.nn.functional.pad(bits, (0, fe.NLIMBS * fe.BITS - 255))
    w13 = 1 << torch.arange(fe.BITS, device=x.device, dtype=torch.int64)
    limbs = (bits.view(-1, fe.NLIMBS, fe.BITS) * w13).sum(dim=2)
    return limbs.t().to(torch.int32).contiguous()


def _limbs13_to_10(v: torch.Tensor) -> torch.Tensor:
    """(20, n) canonical 13-bit limbs -> (n, 10) radix-2^25.5 limbs."""
    v = v.t().to(torch.int64)
    bits = ((v[:, :, None] >> torch.arange(fe.BITS, device=v.device)) & 1)
    bits = bits.reshape(v.shape[0], -1)
    w = [1 << torch.arange(b, device=v.device, dtype=torch.int64)
         for b in cv.LIMB_BITS]
    cols = [(bits[:, off : off + b] * w[i]).sum(dim=1)
            for i, (off, b) in enumerate(zip(cv.LIMB_OFF, cv.LIMB_BITS))]
    return torch.stack(cols, dim=1).to(torch.int32)


def fe_chain_plain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """The plain PyTorch version of the chain kernel, on ``ops.fe25519``:
    (n, 10) canonical limbs in, (n, 10) canonical limbs out."""
    a = fe.F(_limbs10_to_13(x), 0, fe.MASK)
    y = fe.red(a)
    for _ in range(k):
        if op == "mul":
            y = fe.red(fe.mul(y, a))
        elif op == "square":
            y = fe.red(fe.square(y))
        else:
            y = fe.red(fe.add(y, a))
    return _limbs13_to_10(fe.freeze(y))


@lru_cache(maxsize=1)
def _chain_lib():
    lib = _build.load(CHAIN)
    lib.fe_chain_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fe_chain_launch.restype = ctypes.c_int
    lib.fe_chain_occupancy.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.fe_chain_occupancy.restype = ctypes.c_int
    return lib


def fe_chain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """(n, 10) canonical limbs of each lane's chain of ``k`` ``op`` steps
    (mul: y*x, square: y^2, add: y+x, from y = x): one launch of
    ``csrc/fe_chain.cu``.  CUDA tensors only."""
    if op not in CHAIN_OPS:
        raise ValueError(f"op must be one of {sorted(CHAIN_OPS)}, got {op!r}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 10:
        raise ValueError(f"x: want (n, 10) int32, got {tuple(x.shape)} {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the chain kernel runs on a CUDA card, got {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _chain_lib().fe_chain_launch(CHAIN_OPS[op], k, x.data_ptr(),
                                          out.data_ptr(), x.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{CHAIN} kernel launch failed: CUDA error {rc}")
    _count(CHAIN)
    return out


def chain_occupancy(op: str) -> dict:
    """Resident blocks per SM, threads per block, registers and local
    memory bytes per thread of the chain kernel for ``op`` (needs a card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    rc = _chain_lib().fe_chain_occupancy(CHAIN_OPS[op], *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"{CHAIN} occupancy query failed: CUDA error {rc}")
    return dict(zip(("blocks_per_sm", "threads", "regs", "local_bytes"),
                    (v.value for v in vals)))
