"""The SHA-256 Merkle tree kernel's wrapper (``csrc/sha256_tree.cu``).

Counterpart of the XLA programs ``_leaf_fn`` and ``_layer_fn`` (over
``_compress``) of ``cometbft_tpu/ops/sha256_tree.py``: raw leaf bytes and
offsets in, every level's digests out.  For CUDA tensors the wrapper
queues one launch per tree on the current stream, or raises; for CPU
tensors it runs the plain PyTorch version,
``ops.sha256_tree.tree_words_plain``.  ``launches`` counts kernel launches
(one per tree, and nothing else), so a run can show that its main path
went through the kernel.

The kernel's last block finds itself by a ticket, one int32 in device
memory that every launch leaves at 0.  The wrapper keeps one per (device,
stream), made once, so that trees on two streams never share one.  (A
memset of a fresh ticket before each launch would put a second operation
on the stream in front of every tree, the very cost one launch per tree
removes.)
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import sha256_tree as _plain

NAME = "sha256_tree"
SOURCE = "cometbft_tpu_torch/csrc/sha256_tree.cu"
REPLACES = "cometbft_tpu/ops/sha256_tree.py:227 (_leaf_fn), :252 (_layer_fn)"

# Instructions of sm_90's integer ISA in one compression, counted by a host
# build of the source (-DSHA256_TALLY): 48 schedule words of 10 (four
# rotates and two shifts, each one SHF; two three-input XORs, each one
# LOP3; an IADD3 and an IADD), 64 rounds of 14 (six SHF; LOP3 for each of
# the two sigma XORs, Ch and Maj; three IADD3 and an IADD) and the 8 IADD
# into the state.
OPS_PER_COMPRESSION = 1384

launches = 0
_tickets: "dict[tuple[int, int], torch.Tensor]" = {}


def reset_launches() -> None:
    global launches
    launches = 0


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(NAME).sha256_tree_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ticket(index: int, stream: int) -> torch.Tensor:
    """The zeroed int32 ticket of card ``index``'s ``stream``."""
    t = _tickets.get((index, stream))
    if t is None:
        zero = torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
        t = _tickets.setdefault((index, stream), zero)
    return t


def occupancy() -> dict:
    """The kernel's launch resources on the current card
    (``_build.occupancy``); ``threads`` is C, the leaves per block, and
    ``shared_bytes`` counts the dynamic shared memory too."""
    return _build.occupancy(NAME)


def compressions(lens) -> int:
    """Compressions of the tree over leaves of byte lengths ``lens``: each
    leaf's padded blocks, and two for each of the n - 1 inner nodes."""
    n = len(lens)
    return sum((ln + 1 + 8) // 64 + 1 for ln in lens) + 2 * max(n - 1, 0)


def _check(data, offs) -> int:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data: want (total,) uint8, got {tuple(data.shape)} "
                         f"{data.dtype}")
    if offs.dtype != torch.int64 or offs.dim() != 1 or offs.numel() < 2:
        raise ValueError(f"offs: want (n + 1,) int64 with n >= 1, got "
                         f"{tuple(offs.shape)} {offs.dtype}")
    if data.device != offs.device:
        raise ValueError(f"inputs lie on several devices: {data.device}, "
                         f"{offs.device}")
    return offs.numel() - 1


def tree_words(data: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Every level's digests of the tree over the leaves ``data[offs[i]:
    offs[i + 1]]``, leaves first, as (sum of ``level_sizes(n)``, 8) int32
    words (the bits of uint32).

    CUDA tensors: one launch on the current stream, no synchronisation.
    CPU tensors: the plain version."""
    n = _check(data, offs)
    dev = data.device
    if dev.type == "cpu":
        return _plain.tree_words_plain(data, offs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")
    data, offs = data.contiguous(), offs.contiguous()
    out = torch.empty((sum(_plain.level_sizes(n)), 8), dtype=torch.int32,
                      device=dev)
    launch = _launcher()
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ticket = _ticket(torch.cuda.current_device(), stream)
        rc = launch(data.data_ptr(), offs.data_ptr(), n, out.data_ptr(),
                    ticket.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
        launches += 1
    return out
