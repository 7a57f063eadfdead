"""RFC 6962 SHA-256 Merkle trees on the card: roots, every level and
inclusion proofs, the port of the JAX package's ``ops/sha256_tree.py``.

A leaf set is hashed in one device pass: the leaves' raw bytes and their
offsets go to the card, one kernel launch hashes every ``SHA-256(0x00 ||
leaf)`` and every level above, adjacent pairs ``SHA-256(0x01 || L ||
R)``, an odd tail promoted unchanged (``ops/cuda_sha256.py`` +
``csrc/sha256_tree.cu``).  ``tree_root`` copies back the root's 32 bytes
(the light path); ``tree_levels`` copies back the kernel's whole output
once and splits it by ``level_sizes``, and ``tree_proofs`` assembles every
leaf's inclusion proof from those levels on the host
(``proofs_from_levels``).  Bottom-up adjacent pairing with odd-tail
promotion is structurally equal to ``crypto/merkle``'s split-point
recursion, which is the oracle: ``host_levels`` and ``proofs_from_levels``
give byte for byte what ``merkle.proofs_from_byte_slices`` gives.

``leaf_core`` / ``layer_core`` are the kernel's plain PyTorch version:
32-bit words held in int64 and masked (torch on the CPU has no add and no
shifts for ``uint32``).  CPU tensors take it.

Routing, as in the JAX package: a set beyond the bucket rules
(``_bucket_shape``) goes to the host oracle and is counted as oversize.
On the card a leaf may be twice as long (``_CARD_MAX_BLOCKS``): the
kernel pads nothing, so a 64 KiB part-set chunk, one SHA-256 block over
the JAX ladder's bound once prefixed and padded, is hashed there too;
with no device named and the trust gate closed
(``verifysched.backend_trusted``, which reads
``COMETBFT_TPU_CRYPTO_BACKEND`` first) a tree is hashed on the host; with
the gate open it goes to the gate's device (the card, or the device a
caller holds it open on with ``verifysched.open_gate``).  The
gate never runs the card's self-check itself; a named device runs its
tier whatever the gate says.  ``set_tree_runner`` replaces the device
pass, as the JAX package's seam does (a runner also takes sets beyond the
bucket rules), for the simulator's host-oracle stand-in.  There is no fallback: on
a card, a tree pass that the kernel fails, or that returns a malformed
result, counts against the ``merkle_device`` breaker, logs a WARNING and
raises ``BackendError`` (``ops/supervisor.supervised_device_call``); the
JAX package recomputes that tree on the host instead.  On the CPU the
host answers below the plain version, counted per tier.  ``tree_root`` and
``tree_levels`` share this routing (``_route``).  Tree passes and leaves
served per tier are in ``ops/dispatch_stats.tier_counts("merkle")``,
oversize ones also under ``"merkle_oversize"``; the proof server's
tree-pass counters (``proofserve/stats``) are written here too, as in the
JAX package.  ``warm_kernels`` is the tree family's warm-boot hook
(``ops/warmboot``).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.backend_health import (
    MERKLE_DEVICE,
    BackendOutputError,
)
from cometbft_tpu_torch.proofserve import stats as pstats

BREAKER = MERKLE_DEVICE
MERKLE = "merkle"  # the dispatch_stats key of tree passes
MERKLE_OVERSIZE = "merkle_oversize"

# The JAX package's bucket rules: lanes are powers of two, blocks bound the
# longest leaf; a set beyond them is hashed on the host
_MIN_LANES = 8
_MAX_LANES_DEFAULT = 16384
_MAX_BLOCKS = 1024  # leaves of up to 65,526 bytes
# on the card: a full 64 KiB part is 1,025 blocks once prefixed and padded
_CARD_MAX_BLOCKS = 2048
_MAX_BATCH_BYTES = 1 << 25  # lanes * blocks * 64

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_MASK = 0xFFFFFFFF

EMPTY_HASH = hashlib.sha256(b"").digest()


# -- runner seam ------------------------------------------------------------------

_RUNNER_LOCK = threading.Lock()
_TREE_RUNNER: "list" = [None]


def set_tree_runner(fn) -> None:
    """Install a stand-in for the device tree pass: ``fn(items) ->
    levels`` (leaf level first, root level last), as the JAX package's
    seam takes.  Everything above the pass (routing, the breaker, the
    counters) runs as it does over the kernel; the deterministic
    simulator pins the host oracle here on the CPU."""
    with _RUNNER_LOCK:
        _TREE_RUNNER[0] = fn


def clear_tree_runner() -> None:
    with _RUNNER_LOCK:
        _TREE_RUNNER[0] = None


def tree_runner():
    with _RUNNER_LOCK:
        return _TREE_RUNNER[0]


def host_tree_runner(items) -> "list[list[bytes]]":
    """The host oracle as a tree runner: the kernel's differential oracle."""
    return host_levels(items)


def device_active() -> bool:
    """True when a tree pass with no device named goes to the device pass:
    a runner is installed or the trust gate is open.  Never runs the
    self-check."""
    if tree_runner() is not None:
        return True
    from cometbft_tpu_torch.verifysched import service

    return service.backend_trusted()


def level_sizes(n: int) -> "list[int]":
    """Digests per level of an ``n``-leaf tree, leaves first."""
    sizes = [n]
    while sizes[-1] > 1:
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


# -- bucket rules --------------------------------------------------------------


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _bucket_shape(items, max_blocks: int = _MAX_BLOCKS) -> "tuple[int, int] | None":
    """(lanes, blocks) of the JAX package's padding bucket for a leaf set,
    or None when the set exceeds its ladder (too many leaves, a leaf of
    more than ``max_blocks`` blocks, or too many bytes in all): such a set
    is hashed on the host.  The kernel pads nothing; the rules only
    route."""
    n = len(items)
    if n > _MAX_LANES_DEFAULT:
        return None
    lanes = _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)
    need = max((len(it) + 10 + 63) // 64 for it in items)
    if need > max_blocks:
        return None
    blocks = _pow2_at_least(need, 1)
    if lanes * blocks * 64 > _MAX_BATCH_BYTES:
        return None
    return lanes, blocks


# -- the plain PyTorch version ---------------------------------------------------


def pack_leaves(items, device="cpu") -> "tuple[torch.Tensor, torch.Tensor]":
    """The leaves as the kernel takes them: their bytes back to back as a
    (total,) uint8 tensor and (n + 1,) int64 offsets (leaf i is
    ``data[offs[i]:offs[i + 1]]``), on ``device``."""
    raw = b"".join(bytes(it) for it in items)
    data = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(it) for it in items], out=offs[1:])
    return data.to(device), torch.from_numpy(offs).to(device)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress(state, w):
    """One SHA-256 compression over lanes: ``state`` 8 and ``w`` 16 (B,)
    int64 tensors of 32-bit words."""
    ws = list(w)
    for t in range(16, 64):
        x15, x2 = ws[t - 15], ws[t - 2]
        s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
        s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
        ws.append((ws[t - 16] + s0 + ws[t - 7] + s1) & _MASK)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _MASK) & g)
        t1 = (h + s1 + ch + _K[t] + ws[t]) & _MASK
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _MASK, c, b, a, (
            t1 + s0 + maj) & _MASK
    return [(s + v) & _MASK for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _initial(n: int, device) -> list:
    return [torch.full((n,), h, dtype=torch.int64, device=device) for h in _H0]


def leaf_core(data: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(n, 8) int64 words of SHA-256(0x00 || leaf) for the leaves of
    ``pack_leaves``: each leaf padded in place, the message blocks scanned
    with the lanes past their last block masked."""
    dev = offs.device
    n = offs.numel() - 1
    lens = offs[1:] - offs[:-1]
    m = lens + 1  # with the 0x00 prefix
    total = ((m + 8) // 64 + 1) * 64
    nblk = total // 64
    blocks = int(nblk.max()) if n else 0
    buf = torch.zeros((n, blocks * 64), dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    if data.numel():
        leaf_of = torch.repeat_interleave(rows, lens)
        pos = torch.arange(data.numel(), device=dev) - offs[leaf_of] + 1
        buf[leaf_of, pos] = data.long()
    buf[rows, m] = 0x80
    bits = m * 8
    for q in range(8):
        buf[rows, total - 8 + q] = (bits >> (56 - 8 * q)) & 0xFF
    b = buf.view(n, blocks, 16, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    state = _initial(n, dev)
    for k in range(blocks):
        new = _compress(state, [words[:, k, j] for j in range(16)])
        live = k < nblk
        state = [torch.where(live, x, s) for x, s in zip(new, state)]
    return torch.stack(state, dim=1)


def layer_core(digests: torch.Tensor) -> torch.Tensor:
    """(ceil(k/2), 8) int64 parent words of a level of (k, 8) int64 digest
    words: ``SHA-256(0x01 || L || R)`` of adjacent pairs (a 65-byte message
    of two blocks, built from the words by shifts), the odd tail promoted
    unchanged."""
    k = digests.shape[0]
    half = k // 2
    left, right = digests[0 : 2 * half : 2], digests[1 : 2 * half : 2]
    w = [(0x01 << 24) | (left[:, 0] >> 8)]
    w += [((left[:, i - 1] & 0xFF) << 24) | (left[:, i] >> 8) for i in range(1, 8)]
    w.append(((left[:, 7] & 0xFF) << 24) | (right[:, 0] >> 8))
    w += [((right[:, i - 1] & 0xFF) << 24) | (right[:, i] >> 8) for i in range(1, 8)]
    state = _compress(_initial(half, digests.device), w)
    zero = torch.zeros(half, dtype=torch.int64, device=digests.device)
    w2 = [((right[:, 7] & 0xFF) << 24) | 0x800000] + [zero] * 14
    w2.append(torch.full((half,), 65 * 8, dtype=torch.int64, device=digests.device))
    inner = torch.stack(_compress(state, w2), dim=1)
    if k % 2:
        inner = torch.cat([inner, digests[k - 1 :]])
    return inner


def tree_words_plain(data: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Every level's digests, leaves first, as (sum of ``level_sizes``, 8)
    int32 words (the bits of uint32): what the kernels write."""
    level = leaf_core(data, offs)
    levels = [level]
    while level.shape[0] > 1:
        level = layer_core(level)
        levels.append(level)
    words = torch.cat(levels)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


# -- the host oracle -----------------------------------------------------------


def host_levels(items) -> "list[list[bytes]]":
    """Every level of the tree on the host, leaves first: ``levels[0]``
    are the RFC 6962 leaf hashes, ``levels[-1]`` is ``[root]``; adjacent
    pairs, the odd tail promoted."""
    level = [merkle._leaf_hash(it) for it in items]
    levels = [level]
    while len(level) > 1:
        nxt = [merkle._inner_hash(level[j], level[j + 1])
               for j in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        levels.append(level)
    return levels


def proofs_from_levels(levels) -> "list[merkle.Proof]":
    """Every leaf's inclusion proof from the tree's levels: the aunts are
    the siblings from the leaf up, skipping the levels where the node is a
    promoted odd tail (it has no sibling there).  Byte for byte
    ``merkle.proofs_from_byte_slices``'s proofs."""
    n = len(levels[0])
    proofs = []
    for i in range(n):
        aunts = []
        idx, cnt = i, n
        for level in levels[:-1]:
            if cnt == 1:
                break
            sib = idx ^ 1
            if sib < cnt:
                aunts.append(level[sib])
            idx //= 2
            cnt = (cnt + 1) // 2
        proofs.append(merkle.Proof(total=n, index=i, leaf_hash=levels[0][i],
                                   aunts=aunts))
    return proofs


# -- the device pass -----------------------------------------------------------


def device_root(items, device=None) -> bytes:
    """The unguarded device tree pass: the leaves' bytes to ``device``
    (None: the card), one launch of the tree kernel, one copy of the root
    back.  CPU tensors run the plain version; an installed runner
    (``set_tree_runner``) answers in its place.  Raises on any failure;
    ``tree_root`` supervises it."""
    runner = tree_runner()
    if runner is not None:
        levels = runner(items)
        return levels[-1][0]
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops.verify import resolve_device

    data, offs = pack_leaves(items, resolve_device(device))
    root = cuda_sha256.tree_words(data, offs)[-1]
    return root.cpu().numpy().astype(np.uint32).astype(">u4").tobytes()


def split_levels(words: np.ndarray, n: int) -> "list[list[bytes]]":
    """The (sum of ``level_sizes(n)``, 8) int32 words of an ``n``-leaf
    tree (the kernel's output, on the host) as its levels of 32-byte
    digests, leaves first."""
    raw = words.astype(np.uint32).astype(">u4").tobytes()
    levels, o = [], 0
    for k in level_sizes(n):
        levels.append([raw[32 * i : 32 * i + 32] for i in range(o, o + k)])
        o += k
    return levels


def device_levels(items, device=None) -> "list[list[bytes]]":
    """The unguarded device pass of every level: the leaves' bytes to
    ``device`` (None: the card), one launch of the tree kernel, one copy
    of its whole output back, split by ``level_sizes``.  CPU tensors run
    the plain version; an installed runner answers in its place.  Raises
    on any failure; ``tree_levels`` supervises it."""
    runner = tree_runner()
    if runner is not None:
        return runner(items)
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops.verify import resolve_device

    data, offs = pack_leaves(items, resolve_device(device))
    return split_levels(cuda_sha256.tree_words(data, offs).cpu().numpy(),
                        len(items))


def _validate_root(root) -> None:
    """A malformed result is an infrastructure failure, never a root."""
    if not (isinstance(root, bytes) and len(root) == 32):
        raise BackendOutputError(f"tree pass returned a malformed root: {root!r:.80}")


def _validate_levels(levels, n: int) -> None:
    """Every level must hold its ``level_sizes(n)`` rows of 32 bytes: a
    dropped or short row would become a wrong proof."""
    ok = (isinstance(levels, list)
          and [len(lv) for lv in levels] == level_sizes(n)
          and all(isinstance(d, bytes) and len(d) == 32
                  for lv in levels for d in lv))
    if not ok:
        raise BackendOutputError(
            f"tree pass returned malformed levels for {n} leaves: {levels!r:.80}")


def _on_host(n: int, host):
    from cometbft_tpu_torch.ops import dispatch_stats

    dispatch_stats.record_tier("host", n, MERKLE)
    pstats.record_tree(n, 0, device=False)
    return host()


def _route(items, device, run, validate, host):
    """The routing of ``tree_root`` and ``tree_levels``: ``run`` is the
    device pass on a given device, ``validate`` its result check, ``host``
    the host oracle.  With no device named and the gate closed, or a set beyond the bucket
    ladder (on the card, with leaves of up to ``_CARD_MAX_BLOCKS``), the
    host answers; otherwise one supervised pass under the
    ``merkle_device`` breaker, which on a card answers or raises
    ``BackendError``."""
    from cometbft_tpu_torch.ops import dispatch_stats, supervisor
    from cometbft_tpu_torch.verifysched import service

    n = len(items)
    if device is None:
        if not device_active():
            return _on_host(n, host)
        device = service.gate_device()
    on_card = supervisor._on_card(device)
    if tree_runner() is None and _bucket_shape(
            items, _CARD_MAX_BLOCKS if on_card else _MAX_BLOCKS) is None:
        dispatch_stats.record_tier("host", n, MERKLE_OVERSIZE)
        pstats.record_oversize()
        return _on_host(n, host)
    lanes = _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)
    out = supervisor.traced_device_call(
        "merkle.tree", "merkle_device_fault", BREAKER, lambda: run(device), validate,
        device=device, leaves=n, lanes=lanes)
    if out is None:  # the CPU only: the host answers below the plain version
        pstats.record_device_fallback()
        return _on_host(n, host)
    dispatch_stats.record_tier("cuda" if on_card else "torch", n, MERKLE)
    pstats.record_tree(n, lanes, device=True)
    return out


def tree_root(items, device=None) -> bytes:
    """Merkle root, bit-identical to ``merkle.hash_from_byte_slices`` on
    every input.  ``device=None`` routes by the gate (the card when it is
    open, else the host); a named device runs its tier.  Oversize sets go
    to the host.  On a card a failed pass raises ``BackendError``; on the
    CPU the host answers below the plain version.  The empty set's root is
    ``EMPTY_HASH`` and launches nothing."""
    if len(items) == 0:
        return EMPTY_HASH
    return _route(items, device, lambda d: device_root(items, d),
                  _validate_root, lambda: merkle.hash_from_byte_slices(items))


def tree_levels(items, device=None) -> "list[list[bytes]]":
    """Every level of a non-empty leaf set's tree, leaves first, routed as
    ``tree_root`` is.  On a card the kernel's levels answer or the call
    raises ``BackendError``: the JAX ``tree_levels`` recomputes a failed
    pass on the host, which would hide the kernel's fault, so the port
    does not (on the CPU the host still answers below the plain
    version)."""
    n = len(items)
    if n == 0:
        raise ValueError("tree_levels needs at least one leaf")
    return _route(items, device, lambda d: device_levels(items, d),
                  lambda lv: _validate_levels(lv, n), lambda: host_levels(items))


def tree_proofs(items, device=None) -> "tuple[bytes, list[merkle.Proof]]":
    """(root, proofs), bit-identical to ``merkle.proofs_from_byte_slices``
    on every input: ``tree_levels``, then ``proofs_from_levels``."""
    if len(items) == 0:
        return EMPTY_HASH, []
    levels = tree_levels(items, device)
    return levels[-1][0], proofs_from_levels(levels)


# -- the warm-boot hook ----------------------------------------------------------

WARM_LEAVES = 64  # the JAX package's warm bucket of the tree family


def warm_kernels(device=None) -> "dict[str, str]":
    """The tree family's warm-boot hook (``ops/warmboot``): on a card, load
    the kernel's library, then one unsupervised pass over WARM_LEAVES
    leaves of 0-32 bytes whose root must equal ``crypto/merkle``'s.
    Returns {library: build status}; raises ``SelfCheckError`` on a wrong
    root and whatever the build, the load or the launch raised."""
    from cometbft_tpu_torch.crypto.batch import SelfCheckError
    from cometbft_tpu_torch.ops import _build, cuda_sha256
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    names = [cuda_sha256.NAME] if dev.type == "cuda" else []
    for name in names:
        _build.load(name)
    items = [hashlib.sha256(b"warm-%d" % i).digest()[: i % 33]
             for i in range(WARM_LEAVES)]
    root = device_root(items, dev)
    if root != merkle.hash_from_byte_slices(items):
        raise SelfCheckError(f"the tree kernel failed its known-answer check "
                             f"on {dev}: root {root.hex()}")
    return _build.statuses(names)
