"""The port's host libraries through ctypes.

Counterpart of ``cometbft_tpu/native/__init__.py``, for the commit path
only: ``lib()`` is ``csrc/host_prep.cpp`` (``ed25519_pack``:
SHA-512(R||A||m) mod L and the s < L check, for ``ops.verify._pack``;
``sha512``; ``commit_sign_bytes``, for
``types.block.Commit.all_vote_sign_bytes``; ``wal_open``/``wal_append``/
``wal_sync``/``wal_size``/``wal_close``, the writer of
``consensus.wal.WAL``), and ``bls()`` is
``csrc/bls12381.cpp`` (the BLS12-381 structural checks, hash to G2, the G2
and G1 scalar multiplications, the aggregate and the pairing product, for
``crypto.bls12381`` and ``crypto.batch.BlsBatchVerifier``).  Each library
is built with ``g++`` at first use (``ops._build``), on any machine, card
or not.

Unlike the JAX package's loader, a failed build or load raises, and so
does the BLS library's own pairing self-check (``bls_init``): no caller
falls back to its Python path, and no switch turns a library off.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

from cometbft_tpu_torch.ops import _build

NAME = "host_prep"
SOURCE = "cometbft_tpu_torch/csrc/host_prep.cpp"
BLS_NAME = "bls12381"
BLS_SOURCE = "cometbft_tpu_torch/csrc/bls12381.cpp"


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
    cdll.wal_open.restype = ctypes.c_void_p
    cdll.wal_open.argtypes = [ctypes.c_char_p]
    cdll.wal_append.restype = ctypes.c_int
    cdll.wal_append.argtypes = [
        ptr, ctypes.c_int,  # handle, record kind
        ctypes.c_char_p, i64,  # payload, length
        ctypes.c_int,  # fsync after the write
    ]
    cdll.wal_sync.restype = ctypes.c_int
    cdll.wal_sync.argtypes = [ptr]
    cdll.wal_size.restype = i64
    cdll.wal_size.argtypes = [ptr]
    cdll.wal_close.restype = None
    cdll.wal_close.argtypes = [ptr]
    return cdll


def sha512(data: bytes) -> bytes:
    """SHA-512 of ``data`` in the host library."""
    out = ctypes.create_string_buffer(64)
    lib().sha512(data, len(data), out)
    return out.raw


@lru_cache(maxsize=1)
def bls() -> ctypes.CDLL:
    """The loaded BLS12-381 host library, built first if needed, with its
    functions bound (the argument types of the JAX package's loader);
    raises if the build, the load or the library's pairing self-check
    fails."""
    cdll = _build.load(BLS_NAME)
    c = ctypes
    ptr, i64 = c.c_char_p, c.c_int64
    sigs = {
        "bls_init": [],
        "bls_pubkey_from_sk": [ptr, ptr],
        "bls_pubkey_validate": [ptr, i64],
        "bls_sign": [ptr, ptr, i64, ptr],
        "bls_verify": [ptr, i64, ptr, i64, ptr],
        "bls_aggregate_sigs": [ptr, i64, ptr],
        "bls_hash_to_g2": [ptr, i64, ptr],
        "bls_sig_validate": [ptr],
        "bls_g1_scalar_mul": [ptr, ptr, i64, ptr],
        "bls_g2_scalar_mul_compressed": [ptr, ptr, i64, ptr],
        "bls_pairing_product_is_one_serialized": [ptr, ptr, i64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(cdll, name)
        fn.restype = c.c_int
        fn.argtypes = argtypes
    # the library refuses to serve if its constants or its pairing are
    # inconsistent (bilinearity, non-degeneracy and inversion self-checks)
    if cdll.bls_init() != 0:
        raise RuntimeError(
            f"{BLS_SOURCE}: the library failed its pairing self-check"
        )
    return cdll
