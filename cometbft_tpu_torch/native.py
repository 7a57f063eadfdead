"""The port's host library (``csrc/host_prep.cpp``) through ctypes.

Counterpart of ``cometbft_tpu/native/__init__.py``, for the commit path
only: ``ed25519_pack`` (SHA-512(R||A||m) mod L and the s < L check, for
``ops.verify._pack``), ``sha512`` and ``commit_sign_bytes`` (for
``types.block.Commit.all_vote_sign_bytes``).  The library is built with
``g++`` at first use (``ops._build``), on any machine, card or not.

Unlike the JAX package's loader, a failed build or load raises: no caller
falls back to its Python path, and no switch turns the library off.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

from cometbft_tpu_torch.ops import _build

NAME = "host_prep"
SOURCE = "cometbft_tpu_torch/csrc/host_prep.cpp"


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed; raises on failure."""
    cdll = _build.load(NAME)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    cdll.ed25519_pack.restype = ctypes.c_int
    cdll.ed25519_pack.argtypes = [
        ptr, ptr, ptr,  # pubs (n*32), sigs (n*64), messages concatenated
        ptr, i64,  # message offsets (n+1 int64), n
        ptr, ptr, ptr,  # outputs: s (n*32), m (n*32), s_ok (n)
    ]
    cdll.sha512.restype = None
    cdll.sha512.argtypes = [ptr, i64, ptr]
    cdll.commit_sign_bytes.restype = i64
    cdll.commit_sign_bytes.argtypes = [
        ptr, i64,  # chain id
        i64, i64,  # height, round
        ptr, i64,  # block id hash
        i64, ptr, i64,  # part-set header total, hash
        ptr, ptr, ptr,  # per-lane int64: flags, timestamp seconds, nanos
        i64,  # n
        ptr, i64,  # out, capacity
        ptr,  # out offsets (n+1 int64)
    ]
    return cdll


def sha512(data: bytes) -> bytes:
    """SHA-512 of ``data`` in the host library."""
    out = ctypes.create_string_buffer(64)
    lib().sha512(data, len(data), out)
    return out.raw
