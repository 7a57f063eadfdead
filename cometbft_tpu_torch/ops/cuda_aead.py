"""The ChaCha20-Poly1305 kernel's wrapper (``csrc/chacha20_poly1305.cu``).

Counterpart of the XLA program ``_aead_fn`` of
``cometbft_tpu/ops/chacha_aead.py`` (jitted as ``_seal_fn`` /
``_open_fn``), on its layout: key, nonce, payload words and byte lengths
in, masked output words and tag words out, all int32 (the bits of
uint32).  A CUDA block of the kernel takes ``FRAMES_PER_BLOCK`` frames,
a warp each: all its threads share the frames' ChaCha blocks, and each
warp runs its frame's Poly1305 by powers of r, its lanes over interleaved
blocks (``mac_shape``).  For CUDA tensors the wrapper launches the kernel
on the current stream or raises; for CPU tensors it runs the kernel's
plain PyTorch version, ``ops.chacha_aead.aead_core``.  ``launches`` counts
kernel launches (and nothing else), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import chacha_aead as _plain

NAME = "chacha20_poly1305"
SOURCE = "cometbft_tpu_torch/csrc/chacha20_poly1305.cu"
REPLACES = ("cometbft_tpu/ops/chacha_aead.py:289 (_aead_fn, via _seal_fn "
            ":401 / _open_fn :405)")

THREADS_PER_LANE = 32  # a warp per frame
FRAMES_PER_BLOCK = 2  # AEAD_FRAMES in the source
MAX_BLOCKS = 32
# The work of one lane, counted by a host build of the source
# (``-DAEAD_TALLY``): a ChaCha block is 976 32-bit operations (80 quarter
# rounds of 12, 16 final additions), a keystream block 16 XORs more; a
# Poly1305 block 25 32x32->64-bit products.  The kernel computes only the
# counter blocks that hold a byte of the frame.
CHACHA_OPS_PER_BLOCK = 976
XOR_OPS_PER_BLOCK = 16
POLY_PRODUCTS_PER_BLOCK = 25

launches = 0
_COUNT_LOCK = threading.Lock()  # the transport plane launches from many threads


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def needed_work(nbytes) -> "tuple[int, int]":
    """(32-bit operations, products) of the lanes of byte lengths
    ``nbytes``: per lane the one-time key's block, ceil(n / 64) keystream
    blocks, ceil(n / 16) Poly1305 blocks and the length block."""
    ops = products = 0
    for n in nbytes:
        n = int(n)
        ops += CHACHA_OPS_PER_BLOCK + -(-n // 64) * (CHACHA_OPS_PER_BLOCK
                                                      + XOR_OPS_PER_BLOCK)
        products += (-(-n // 16) + 1) * POLY_PRODUCTS_PER_BLOCK
    return ops, products


def mac_shape(n: int) -> "tuple[int, int]":
    """(T, m) of a frame of ``n`` bytes in the kernel's warp-wide Poly1305:
    its k = ceil(n / 16) + 1 MAC blocks padded at the front to m * T, T the
    least power of two >= k and at most 32.  A lane runs m Horner steps in
    r^T after a scan of log2 T multiplies."""
    k = -(-n // 16) + 1
    t = min(32, 1 << (k - 1).bit_length())
    return t, -(-k // t)


def mac_levels(n: int) -> int:
    """Dependent multiplies of a frame's MAC in the kernel: log2 T + m,
    against the ceil(n / 16) + 1 of one thread's Horner chain."""
    t, m = mac_shape(n)
    return t.bit_length() - 1 + m


def kernel_work(nbytes) -> "tuple[int, int]":
    """(32-bit operations, products) the kernel computes for the lanes of
    byte lengths ``nbytes``, as its host build counts them: the ChaCha
    blocks of ``needed_work``, and per frame the products of the lanes
    whose results are used: at scan level d the T - d lanes >= d, then T
    lanes x m Horner steps."""
    ops, _ = needed_work(nbytes)
    products = 0
    for n in nbytes:
        t, m = mac_shape(int(n))
        scan = sum(t - (1 << j) for j in range(t.bit_length() - 1))
        products += (scan + t * m) * POLY_PRODUCTS_PER_BLOCK
    return ops, products


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).chacha20_poly1305_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``)."""
    return _build.occupancy(NAME)


def _check(key_words, nonce_words, data_words, nbytes) -> "tuple[int, int]":
    if data_words.dtype != torch.int32 or data_words.dim() != 3 or \
            data_words.shape[2] != 16:
        raise ValueError(f"data_words: want (blocks, lanes, 16) int32, got "
                         f"{tuple(data_words.shape)} {data_words.dtype}")
    blocks, lanes = data_words.shape[0], data_words.shape[1]
    if not (1 <= blocks <= MAX_BLOCKS and lanes >= 1):
        raise ValueError(f"want 1..{MAX_BLOCKS} blocks and a lane, got "
                         f"{tuple(data_words.shape)}")
    for name, t, shape in (("key_words", key_words, (lanes, 8)),
                           ("nonce_words", nonce_words, (lanes, 3)),
                           ("nbytes", nbytes, (lanes,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != data_words.device:
            raise ValueError(f"inputs lie on several devices: {t.device}, "
                             f"{data_words.device}")
    return blocks, lanes


def aead(key_words, nonce_words, data_words, nbytes, seal: bool):
    """((blocks, lanes, 16) output words, (lanes, 4) tag words) of the
    lanes: the payload XOR the keystream, masked to each lane's length, and
    the Poly1305 tag of the ciphertext (``seal``: the output; open: the
    input).  Lengths must lie in [0, 64 * blocks].

    CUDA tensors: one launch on the current stream, no synchronisation.
    CPU tensors: the plain version."""
    blocks, lanes = _check(key_words, nonce_words, data_words, nbytes)
    dev = data_words.device
    if dev.type == "cpu":
        if int(nbytes.min()) < 0 or int(nbytes.max()) > 64 * blocks:
            raise ValueError(f"lengths outside [0, {64 * blocks}]")
        return _plain.aead_core(key_words, nonce_words, data_words, nbytes, seal)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    # the kernel moves keys, payload and tags as 16-byte vectors
    ins = [t.contiguous() for t in (key_words, nonce_words, data_words, nbytes)]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    out = torch.empty_like(ins[2])
    tag = torch.empty((lanes, 4), dtype=torch.int32, device=dev)
    launch = _launcher()
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(t.data_ptr() for t in ins), blocks, lanes, int(bool(seal)),
                    out.data_ptr(), tag.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
        with _COUNT_LOCK:
            launches += 1
    return out, tag
