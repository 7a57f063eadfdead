"""Batched ChaCha20-Poly1305 (RFC 8439, empty AAD): the transport plane's
AEAD, many frames in one pass.

Counterpart of the JAX package's ``ops/chacha_aead.py``.  A batch of
frames (each a 32-byte key, a 96-bit nonce and a payload) is packed by the
JAX package's rules into ``(blocks, lanes, 16)`` little-endian payload
words, ``(lanes, 8)`` key words, ``(lanes, 3)`` nonce words and ``(lanes,)``
byte lengths, and sealed or opened in one launch of the hand-written
kernel (``ops/cuda_aead.py`` + ``csrc/chacha20_poly1305.cu``); every lane
carries its own key and nonce, so both directions of many connections can
share a pass.  The transport path always has empty AAD (SecretConnection
frames), so the MAC input is the zero-padded ciphertext words and one
length block.

``aead_core`` is the kernel's plain PyTorch version, the same function as
the JAX ``_aead_fn``: 32-bit words held in int64 and masked (torch on the
CPU has no add and no shifts for ``uint32``), Poly1305 in five 26-bit
limbs.  CPU tensors take it.

Routing and supervision (the port's rules, ``verifysched.backend_trusted``
being the gate, as in ``ops/sha256_tree.tree_root``):

  * ``COMETBFT_TPU_AEAD_DEVICE=0`` pins every frame to the host tier;
  * with no device named, no runner installed and the gate closed, a
    batch is sealed or opened on the host tier; with the gate open, a
    batch with no device named goes to the gate's device
    (``verifysched.gate_device``: the card, or a device a caller named);
  * a batch beyond the JAX package's bucket ladder (``_bucket_shape``:
    frames over 2 KiB, more than ``COMETBFT_TPU_AEAD_MAX_LANES`` frames, a
    4 MiB budget) goes to the host, counted as oversize;
  * otherwise the pass goes through ``ops/supervisor.supervised_device_call``
    under the ``aead_device`` breaker.  On a card the kernel answers, or the
    call logs a WARNING, counts against the breaker and raises
    ``BackendError``: nothing below the kernel answers for a card (the JAX
    package steps down to its numpy and pure tiers there).  On the CPU the
    plain version answers, then the host tier (``aead_ref``), each counted;
  * a tag the device tier (kernel or plain version) rejects is confirmed
    on the reference's Poly1305 before the reject may leave.  Where the
    reference accepts it, the pass recorded a breaker failure and raises
    ``BackendError``; the JAX package serves the reference's plaintext.

Batches served per tier are in ``ops/dispatch_stats.tier_counts("aead")``
(oversize ones also under ``"aead_oversize"``), AEAD passes per tier in
``p2p/transport_stats``.  ``set_aead_runner`` replaces the device pass
(tests).  ``warm_kernels`` is the family's warm-boot hook
(``ops/warmboot``): the JAX package's compiles executables, the port's
loads the kernel's library and checks the RFC 8439 vector on the card.
A pass records an ``aead.dispatch`` span and a pass the device did not
serve an ``aead_device_fault`` anomaly (``libs/tracing``), as in the JAX
package; a device reject the reference overturns an
``aead_verdict_mismatch``.  The JAX ``aead_numpy_fault`` has no site: the
port's host tier is one pass, with no numpy tier above a pure one.
"""

from __future__ import annotations

import os
import struct
import threading

import numpy as np
import torch

from cometbft_tpu_torch.crypto import aead_ref
from cometbft_tpu_torch.crypto.backend_health import (
    AEAD_DEVICE,
    BackendError,
    BackendOutputError,
)
from cometbft_tpu_torch.p2p import transport_stats as tstats

BREAKER = AEAD_DEVICE
AEAD = "aead"  # the dispatch_stats key of AEAD passes
AEAD_OVERSIZE = "aead_oversize"
TAG_LEN = 16

# The JAX package's bucket rules: lane buckets are powers of two; blocks
# bound the frame length.  SecretConnection frames carry at most 1,024
# bytes = 16 blocks; 32 leaves slack for other callers.
_MIN_LANES = 8
_MAX_LANES_DEFAULT = 1024
_MAX_BLOCKS = 32  # 2 KiB frames; longer ones go to the host
_MAX_BATCH_BYTES = 1 << 22  # lanes * blocks * 64

_CHACHA_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_QROUNDS = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)
_M32 = 0xFFFFFFFF
_M26 = (1 << 26) - 1


def enabled() -> bool:
    """``COMETBFT_TPU_AEAD_DEVICE=0`` pins every frame to the host tier."""
    return os.environ.get("COMETBFT_TPU_AEAD_DEVICE", "1") != "0"


# -- runner seam ----------------------------------------------------------------

_RUNNER_LOCK = threading.Lock()
_AEAD_RUNNER: "list" = [None]


def set_aead_runner(fn) -> None:
    """Install a stand-in for the device pass: ``fn(op, frames) -> [(out,
    tag)]`` with ``op`` in ("seal", "open") and ``frames`` a list of (key,
    nonce, data).  Everything above the pass (routing, the breaker, the
    confirmation of rejects, the counters) runs as it does over the
    kernel."""
    with _RUNNER_LOCK:
        _AEAD_RUNNER[0] = fn


def clear_aead_runner() -> None:
    with _RUNNER_LOCK:
        _AEAD_RUNNER[0] = None


def aead_runner():
    with _RUNNER_LOCK:
        return _AEAD_RUNNER[0]


def device_active(device=None) -> bool:
    """True when a batch on ``device`` goes to the device pass: the kill
    switch is on and a device is named, a runner is installed or the gate
    is open.  Never runs the card's self-check."""
    if not enabled():
        return False
    if device is not None or aead_runner() is not None:
        return True
    from cometbft_tpu_torch.verifysched import service

    return service.backend_trusted()


# -- the host tier -------------------------------------------------------------------


def _ref_tag(key: bytes, nonce: bytes, ct: bytes) -> bytes:
    """The reference's Poly1305 tag of ``ct`` with empty AAD."""
    otk = aead_ref._chacha20_block(key, 0, nonce)[:32]
    return aead_ref._poly1305(
        otk, ct + aead_ref._pad16(ct) + struct.pack("<QQ", 0, len(ct)))


def _host_pass(op, frames):
    """The host tier, frame by frame on ``aead_ref``.  Returns [(out,
    tag)]: ``out`` the ciphertext (seal) or candidate plaintext (open),
    ``tag`` the MAC of the ciphertext, equal to ``ChaCha20Poly1305Ref``
    with empty AAD."""
    outs = []
    for key, nonce, data in frames:
        out = aead_ref._chacha20_xor(key, 1, nonce, data)
        outs.append((out, _ref_tag(key, nonce, out if op == "seal" else data)))
    return outs


# -- the plain PyTorch version ------------------------------------------------------


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & _M32


def _chacha_blocks(key_rows, nonce_rows, counter):
    """The 20-round ChaCha block function over an (X, lanes) grid of
    counters: ``key_rows`` 8 and ``nonce_rows`` 3 (lanes,) int64 words,
    broadcast over the block axis.  Returns the 16 output words, each (X,
    lanes) int64 in [0, 2^32)."""
    shape = counter.shape
    st = [torch.full(shape, c, dtype=torch.int64, device=counter.device)
          for c in _CHACHA_CONST]
    st += [k[None, :].expand(shape) for k in key_rows]
    st.append(counter)
    st += [nc[None, :].expand(shape) for nc in nonce_rows]
    w = list(st)
    for _ in range(10):
        for a, b, c, d in _QROUNDS:
            wa, wb, wc, wd = w[a], w[b], w[c], w[d]
            wa = (wa + wb) & _M32
            wd = _rotl(wd ^ wa, 16)
            wc = (wc + wd) & _M32
            wb = _rotl(wb ^ wc, 12)
            wa = (wa + wb) & _M32
            wd = _rotl(wd ^ wa, 8)
            wc = (wc + wd) & _M32
            wb = _rotl(wb ^ wc, 7)
            w[a], w[b], w[c], w[d] = wa, wb, wc, wd
    return [(x + y) & _M32 for x, y in zip(w, st)]


def _limbs26(w0, w1, w2, w3):
    """4 little-endian words -> 5 limbs of 26 bits (the top limb 24)."""
    return [w0 & _M26, ((w0 >> 26) | (w1 << 6)) & _M26,
            ((w1 >> 20) | (w2 << 12)) & _M26, ((w2 >> 14) | (w3 << 18)) & _M26,
            w3 >> 8]


def _poly_block(h, r, s5, m):
    """(h + m + 2^128) * r mod 2^130 - 5 on 26-bit limb lists; ``s5`` are
    5 r (2^130 = 5).  Limbs of h stay below 2^27, so each column of five
    products is below 2^58."""
    n = _limbs26(*m)
    n[4] = n[4] | (1 << 24)
    t = [h[i] + n[i] for i in range(5)]
    d = []
    for k in range(5):
        acc = None
        for i in range(5):
            j = k - i
            term = t[i] * (r[j] if j >= 0 else s5[j + 5])
            acc = term if acc is None else acc + term
        d.append(acc)
    out, c = [], None
    for k in range(5):
        v = d[k] if c is None else d[k] + c
        out.append(v & _M26)
        c = v >> 26
    v = out[0] + 5 * c
    out[0] = v & _M26
    out[1] = out[1] + (v >> 26)
    return out


def _i32(words):
    """int64 words in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def aead_core(key_words, nonce_words, data_words, nbytes, seal: bool):
    """The plain PyTorch version of the AEAD kernel: the JAX ``_aead_fn``.

    ``key_words`` (lanes, 8), ``nonce_words`` (lanes, 3), ``data_words``
    (blocks, lanes, 16) zero-padded payload words and ``nbytes`` (lanes,)
    byte lengths, all int32 (the bits of uint32).  Returns ((blocks, lanes,
    16) output words masked to each lane's length, (lanes, 4) tag words),
    int32.  ``seal``: the payload is plaintext, MAC over the output; open:
    the payload is ciphertext, MAC over the input."""
    dev = data_words.device
    blocks, lanes = data_words.shape[0], data_words.shape[1]
    key = key_words.to(torch.int64) & _M32
    nonce = nonce_words.to(torch.int64) & _M32
    data = data_words.to(torch.int64) & _M32
    n = nbytes.to(torch.int64)
    key_rows = [key[:, i] for i in range(8)]
    nonce_rows = [nonce[:, i] for i in range(3)]

    # counter block 0: the one-time key (r clamped, s)
    blk0 = _chacha_blocks(key_rows, nonce_rows,
                          torch.zeros((1, lanes), dtype=torch.int64, device=dev))
    rw = [blk0[0][0] & 0x0FFFFFFF] + [blk0[i][0] & 0x0FFFFFFC for i in (1, 2, 3)]
    r = _limbs26(*rw)
    s5 = [5 * x for x in r]
    s_words = [blk0[4 + i][0] for i in range(4)]

    ctr = (torch.arange(blocks, dtype=torch.int64, device=dev) + 1)[:, None]
    ks = _chacha_blocks(key_rows, nonce_rows, ctr.expand(blocks, lanes))

    # XOR, masked per word to the lane's length (a word's first k bytes are
    # its low 8k bits)
    xored, mac_words = [], []
    for j in range(16):
        off = (torch.arange(blocks, dtype=torch.int64, device=dev) * 64 + 4 * j)[:, None]
        k = torch.clamp(n[None, :] - off, 0, 4)
        mask = torch.where(k >= 4, _M32, (1 << (8 * k)) - 1)
        dw = data[:, :, j] & mask
        xw = (dw ^ ks[j]) & mask
        xored.append(xw)
        mac_words.append(xw if seal else dw)

    # Poly1305 over the zero-padded ciphertext words: blocks * 4 MAC blocks
    # of 4 words, the ones past each lane's ceil(n / 16) left out
    mac = torch.stack(mac_words, dim=1).reshape(blocks * 4, 4, lanes)
    nfull = (n + 15) // 16
    h = [torch.zeros(lanes, dtype=torch.int64, device=dev) for _ in range(5)]
    for p in range(blocks * 4):
        new = _poly_block(h, r, s5, [mac[p, i] for i in range(4)])
        live = p < nfull
        h = [torch.where(live, x, y) for x, y in zip(new, h)]
    zero = torch.zeros(lanes, dtype=torch.int64, device=dev)
    h = _poly_block(h, r, s5, [zero, zero, n & _M32, zero])

    # carry fully, then h mod p by the g = h + 5 - 2^130 select
    for i in (1, 2, 3):
        h[i + 1] = h[i + 1] + (h[i] >> 26)
        h[i] = h[i] & _M26
    h[0] = h[0] + 5 * (h[4] >> 26)
    h[4] = h[4] & _M26
    h[1] = h[1] + (h[0] >> 26)
    h[0] = h[0] & _M26
    g, c = [], 5
    for i in range(4):
        v = h[i] + c
        g.append(v & _M26)
        c = v >> 26
    g.append(h[4] + c - (1 << 26))
    ge = g[4] >= 0  # h >= p
    h = [torch.where(ge, x, y) for x, y in zip(g, h)]

    # tag = (h + s) mod 2^128, four words with carries
    aw = [(h[0] | (h[1] << 26)) & _M32, ((h[1] >> 6) | (h[2] << 20)) & _M32,
          ((h[2] >> 12) | (h[3] << 14)) & _M32, ((h[3] >> 18) | (h[4] << 8)) & _M32]
    tag, c = [], 0
    for i in range(4):
        v = aw[i] + s_words[i] + c
        tag.append(v & _M32)
        c = v >> 32
    return _i32(torch.stack(xored, dim=2)), _i32(torch.stack(tag, dim=1))


# -- bucket rules and packing -----------------------------------------------------


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def max_lanes() -> int:
    try:
        return int(os.environ.get("COMETBFT_TPU_AEAD_MAX_LANES", "")
                   or _MAX_LANES_DEFAULT)
    except ValueError:
        return _MAX_LANES_DEFAULT


def _bucket_shape(frames) -> "tuple[int, int] | None":
    """(lanes, blocks) of the JAX package's padding bucket for a frame
    batch, or None when the batch exceeds its ladder (oversize frames, the
    lane budget): such a batch goes to the host."""
    n = len(frames)
    if n == 0 or n > max_lanes():
        return None
    lanes = _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)
    need = max(1, max((len(d) + 63) // 64 for _, _, d in frames))
    if need > _MAX_BLOCKS:
        return None
    blocks = _pow2_at_least(need, 1)
    if lanes * blocks * 64 > _MAX_BATCH_BYTES:
        return None
    return lanes, blocks


def _pack_frames(frames, lanes: int, blocks: int):
    """The kernel's inputs as numpy int32 arrays (the bits of uint32):
    (lanes, 8) key words, (lanes, 3) nonce words, (blocks, lanes, 16)
    zero-padded payload words (little-endian) and (lanes,) byte lengths.
    Idle lanes are all zero."""
    keys = np.zeros((lanes, 32), dtype=np.uint8)
    nonces = np.zeros((lanes, 12), dtype=np.uint8)
    buf = np.zeros((lanes, blocks * 64), dtype=np.uint8)
    nbytes = np.zeros((lanes,), dtype=np.int32)
    for i, (key, nonce, data) in enumerate(frames):
        keys[i] = np.frombuffer(key, dtype=np.uint8)
        nonces[i] = np.frombuffer(nonce, dtype=np.uint8)
        if data:
            buf[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        nbytes[i] = len(data)
    data_words = buf.view("<i4").reshape(lanes, blocks, 16).transpose(1, 0, 2)
    return (keys.view("<i4"), nonces.view("<i4"),
            np.ascontiguousarray(data_words), nbytes)


def _unpack_outputs(out_words, tag_words, frames):
    """The kernel's outputs (numpy int32) back to (out, tag) bytes per
    frame."""
    blocks, lanes = out_words.shape[0], out_words.shape[1]
    flat = out_words.astype("<i4").transpose(1, 0, 2).reshape(lanes, blocks * 16)
    tags = tag_words.astype("<i4")
    return [(flat[i].tobytes()[: len(data)], tags[i].tobytes())
            for i, (_, _, data) in enumerate(frames)]


# -- the device pass ----------------------------------------------------------------


def device_pass(op, frames, device=None):
    """The unguarded device pass: ``op`` in ("seal", "open"), ``frames`` a
    list of (key, nonce, data) with ``data`` plaintext (seal) or tagless
    ciphertext (open).  Packs on the host, copies to ``device`` (None: the
    card), one launch of the kernel (CPU tensors: the plain version), one
    copy back.  Returns [(out, tag)]; raises on any failure, ``aead_pass``
    supervises it."""
    runner = aead_runner()
    if runner is not None:
        outs = runner(op, frames)
    else:
        from cometbft_tpu_torch.ops import cuda_aead
        from cometbft_tpu_torch.ops.verify import resolve_device

        shape = _bucket_shape(frames)
        if shape is None:
            raise ValueError("frame batch exceeds the device bucket ladder")
        dev = resolve_device(device)
        packed = [torch.from_numpy(a).to(dev) for a in _pack_frames(frames, *shape)]
        out_words, tag_words = cuda_aead.aead(*packed, seal=op == "seal")
        outs = _unpack_outputs(out_words.cpu().numpy(), tag_words.cpu().numpy(),
                               frames)
    return outs


def _validate(outs, frames) -> None:
    """A malformed result is an infrastructure failure, never bytes or a
    verdict: a dropped lane on the open path would read as a bad tag."""
    ok = isinstance(outs, list) and len(outs) == len(frames) and all(
        isinstance(o, tuple) and len(o) == 2 and isinstance(o[0], bytes)
        and len(o[0]) == len(f[2]) and isinstance(o[1], bytes)
        and len(o[1]) == TAG_LEN for o, f in zip(outs, frames))
    if not ok:
        raise BackendOutputError(
            f"device AEAD pass returned a malformed result for {len(frames)} "
            f"frames: {outs!r:.80}")


def _host_tier(op, frames):
    """The CPU's tier below the device one, counted."""
    outs = _host_pass(op, frames)
    tstats.record_dispatch("host", len(frames))
    return outs, "host"


def aead_pass(op, frames, device=None):
    """[(key, nonce, data)] -> ([(out, tag)], tier): the routing and
    supervision of the module docstring.  ``tier`` is ``cuda`` or ``torch``
    (the device pass) or ``host``."""
    from cometbft_tpu_torch.ops import dispatch_stats, supervisor

    n = len(frames)
    if not device_active(device):
        outs, tier = _host_tier(op, frames)
        dispatch_stats.record_tier("host", n, AEAD)
        return outs, tier
    if device is None:  # the gate's device: the card, or one a caller named
        from cometbft_tpu_torch.verifysched import service

        device = service.gate_device()
    if aead_runner() is None and _bucket_shape(frames) is None:
        outs, tier = _host_tier(op, frames)
        dispatch_stats.record_tier("host", n, AEAD)
        dispatch_stats.record_tier("host", n, AEAD_OVERSIZE)
        return outs, tier
    lanes = _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)
    outs = supervisor.traced_device_call(
        "aead.dispatch", "aead_device_fault", BREAKER,
        lambda: device_pass(op, frames, device),
        lambda o: _validate(o, frames), device=device,
        op=op, frames=n, lanes=lanes)
    if outs is None:  # the CPU only: the host tier answers below the plain version
        tstats.record_device_fallback()
        outs, tier = _host_tier(op, frames)
        dispatch_stats.record_tier("host", n, AEAD)
        return outs, tier
    tstats.record_dispatch("device", n, lanes)
    tier = "cuda" if supervisor._on_card(device) else "torch"
    dispatch_stats.record_tier(tier, n, AEAD)
    return outs, tier


# -- the batch API --------------------------------------------------------------------


def seal_frames(frames, device=None) -> "list[bytes]":
    """[(key, nonce, plaintext)] -> [ciphertext || tag], equal to
    ``ChaCha20Poly1305Ref.encrypt`` with empty AAD on every frame."""
    outs, _ = aead_pass("seal", frames, device)
    return [ct + tag for ct, tag in outs]


def _ct_eq(a: bytes, b: bytes) -> bool:
    diff = 0
    for x, y in zip(a, b):
        diff |= x ^ y
    return diff == 0 and len(a) == len(b)


def open_frames(frames, device=None) -> "list":
    """[(key, nonce, ciphertext || tag)] -> [plaintext or None] (None: the
    tag does not authenticate).  An accept needs the computed tag to
    match; a reject by the device tier is confirmed on the reference's
    Poly1305 first.  Where the reference accepts the frame, the device pass was
    wrong: a breaker failure is recorded and ``BackendError`` raised."""
    work, results = [], [None] * len(frames)
    for i, (key, nonce, sealed) in enumerate(frames):
        if len(sealed) < TAG_LEN:
            tstats.record_bad_tag()
            continue
        work.append((i, key, nonce, sealed[:-TAG_LEN], sealed[-TAG_LEN:]))
    if not work:
        return results
    outs, tier = aead_pass("open", [(k, n, ct) for _, k, n, ct, _ in work], device)
    for (i, key, nonce, ct, want), (pt, got) in zip(work, outs):
        if _ct_eq(got, want):
            results[i] = pt
            continue
        if tier in ("cuda", "torch"):
            tstats.record_reject_confirm()
            if _ct_eq(_ref_tag(key, nonce, ct), want):
                from cometbft_tpu_torch.crypto import backend_health

                err = BackendError(
                    f"the {tier} AEAD tier rejected frame {i}, which the "
                    f"reference authenticates")
                from cometbft_tpu_torch.libs import tracing

                backend_health.registry().breaker(BREAKER).record_failure(err)
                tracing.record_anomaly("aead_verdict_mismatch")
                raise err
        tstats.record_bad_tag()
    return results


# -- the warm-boot hook -------------------------------------------------------------

# RFC 8439 2.8.2: key, nonce, plaintext and ciphertext.  The vector's tag
# covers its AAD; transport frames carry none, so the check holds the tag
# to the reference's empty-AAD tag of the same ciphertext.
RFC8439_KEY = bytes(range(0x80, 0xA0))
RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
              b"only one tip for the future, sunscreen would be it.")
RFC8439_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116")


def warm_kernels(device=None) -> "dict[str, str]":
    """The AEAD family's warm-boot hook (``ops/warmboot``): on a card, load
    the kernel's library, then one unsupervised seal of the RFC 8439 2.8.2
    plaintext, whose ciphertext must be the RFC's and whose tag the
    reference's.  Returns {library: build status}; raises
    ``SelfCheckError`` on a wrong answer and whatever the build, the load
    or the launch raised."""
    from cometbft_tpu_torch.crypto.batch import SelfCheckError
    from cometbft_tpu_torch.ops import _build, cuda_aead
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    names = [cuda_aead.NAME] if dev.type == "cuda" else []
    for name in names:
        _build.load(name)
    [(ct, tag)] = device_pass("seal", [(RFC8439_KEY, RFC8439_NONCE, RFC8439_PT)],
                              dev)
    if ct != RFC8439_CT or tag != _ref_tag(RFC8439_KEY, RFC8439_NONCE, RFC8439_CT):
        raise SelfCheckError(f"the AEAD kernel failed the RFC 8439 vector on "
                             f"{dev}: ciphertext right {ct == RFC8439_CT}")
    return _build.statuses(names)
