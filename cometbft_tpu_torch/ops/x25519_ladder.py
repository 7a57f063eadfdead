"""Batched X25519 (RFC 7748): the transport plane's handshake ladder, many
exchanges in one pass.

Counterpart of the JAX package's ``ops/x25519_ladder.py``.  A batch of
pending exchanges (a 32-byte scalar and a 32-byte u-coordinate each) runs
through one launch of the hand-written kernel (``ops/cuda_x25519.py`` +
``csrc/x25519_ladder.cu``): scalars are clamped on the host (RFC 7748 5)
and padded, as the JAX package pads, to a bucket of lanes that rides the
base point with a clamped zero scalar; the kernel runs the fixed-structure
ladder (arithmetic swaps, no branch on a secret bit), inverts z by the
2^255 - 21 chain and hands back the canonical u bytes.

``ladder_core`` is the kernel's plain PyTorch version, the same function
as the JAX ``_ladder_fn``: (rows, lanes) int32 scalar bits (most
significant first; 255 rows for a full ladder, fewer in tests) and (lanes,
32) uint8 u in, (20, lanes) int32 canonical 13-bit limbs out, on the port's
``ops/fe25519`` field.  CPU tensors take it.

Routing and supervision, the port's rules (``verifysched.backend_trusted``
being the gate):

  * ``COMETBFT_TPU_X25519_DEVICE=0`` pins every exchange to the host
    reference (``aead_ref.x25519``);
  * with no device named and the gate closed, or with more pairs than
    ``COMETBFT_TPU_X25519_MAX_LANES`` (counted as oversize), a batch goes
    to the host; with the gate open, a batch with no device named goes to
    the gate's device (``verifysched.gate_device``: the card, or a device
    a caller named);
  * otherwise the pass goes through ``ops/supervisor.supervised_device_call``
    under the ``x25519_device`` breaker: on a card the kernel answers or
    the call raises ``BackendError`` (the JAX package re-derives every
    pair on the host instead); on the CPU the plain version answers, then
    the host reference.

Ladder passes and exchanges per tier are in
``ops/dispatch_stats.tier_counts("x25519")``.  ``p2p/handshake_pool.py`` is
the production caller: it coalesces concurrent dials into these batches.
``set_ladder_runner`` replaces the device pass (tests).  ``warm_ladder``
is the family's warm-boot hook (``ops/warmboot``): the JAX package's
compiles an executable, the port's loads the kernel's library and checks
the RFC 7748 vectors on the card.  A pass records an ``x25519.ladder``
span and a pass the device did not serve an ``x25519_device_fault``
anomaly (``libs/tracing``), as in the JAX package.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from cometbft_tpu_torch.crypto import aead_ref
from cometbft_tpu_torch.crypto.backend_health import X25519_DEVICE, BackendOutputError
from cometbft_tpu_torch.ops import fe25519 as fe
from cometbft_tpu_torch.p2p import transport_stats as tstats

BREAKER = X25519_DEVICE
X25519 = "x25519"  # the dispatch_stats key of ladder passes
X25519_OVERSIZE = "x25519_oversize"

_MIN_LANES = 8
_MAX_LANES_DEFAULT = 256

BASE_U = (9).to_bytes(32, "little")
_A24 = 121665


def enabled() -> bool:
    """``COMETBFT_TPU_X25519_DEVICE=0`` pins every exchange to the host."""
    return os.environ.get("COMETBFT_TPU_X25519_DEVICE", "1") != "0"


# -- runner seam ----------------------------------------------------------------

_RUNNER_LOCK = threading.Lock()
_LADDER_RUNNER: "list" = [None]


def set_ladder_runner(fn) -> None:
    """Install a stand-in for the device pass: ``fn(pairs) -> [shared32]``
    with ``pairs`` a list of (scalar32, u32).  Everything above the pass
    runs as it does over the kernel."""
    with _RUNNER_LOCK:
        _LADDER_RUNNER[0] = fn


def clear_ladder_runner() -> None:
    with _RUNNER_LOCK:
        _LADDER_RUNNER[0] = None


def ladder_runner():
    with _RUNNER_LOCK:
        return _LADDER_RUNNER[0]


def host_exchange(pairs) -> "list[bytes]":
    """The host reference, pair by pair: the kernel's oracle."""
    return [aead_ref.x25519(scalar, u) for scalar, u in pairs]


def device_active(device=None) -> bool:
    """True when an exchange on ``device`` goes to the device pass: the
    kill switch is on and a device is named, a runner is installed or the
    gate is open.  Never runs the card's self-check."""
    if not enabled():
        return False
    if device is not None or ladder_runner() is not None:
        return True
    from cometbft_tpu_torch.verifysched import service

    return service.backend_trusted()


# -- the plain PyTorch version ---------------------------------------------------------


def _inv(z: fe.F) -> fe.F:
    """z^(p - 2) = z^(2^255 - 21): the curve25519 inversion chain (254
    squares, 11 multiplies), as the JAX ``_inv``."""
    z = fe.red(z)
    z2 = fe.red(fe.square(z))
    z8 = fe._nsquares(z2, 2)
    z9 = fe.red(fe.mul(z8, z))
    z11 = fe.red(fe.mul(z9, z2))
    z22 = fe.red(fe.square(z11))
    z_5_0 = fe.red(fe.mul(z22, z9))  # 2^5 - 1
    z_10_0 = fe.red(fe.mul(fe._nsquares(z_5_0, 5), z_5_0))
    z_20_0 = fe.red(fe.mul(fe._nsquares(z_10_0, 10), z_10_0))
    z_40_0 = fe.red(fe.mul(fe._nsquares(z_20_0, 20), z_20_0))
    z_50_0 = fe.red(fe.mul(fe._nsquares(z_40_0, 10), z_10_0))
    z_100_0 = fe.red(fe.mul(fe._nsquares(z_50_0, 50), z_50_0))
    z_200_0 = fe.red(fe.mul(fe._nsquares(z_100_0, 100), z_100_0))
    z_250_0 = fe.red(fe.mul(fe._nsquares(z_200_0, 50), z_50_0))
    return fe.red(fe.mul(fe._nsquares(z_250_0, 5), z11))  # 2^255 - 21


def _const(n: int, lanes: int, device) -> fe.F:
    c = fe.const(n, device)
    return fe.F(c.v.expand(fe.NLIMBS, lanes), c.lo, c.hi)


def ladder_core(bits: torch.Tensor, u_bytes: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the ladder kernel: the JAX
    ``_ladder_fn``.  ``bits`` (rows, lanes) int32 scalar bits, most
    significant first (rows = 255 for a clamped scalar's bits 254..0; any
    number of rows runs that many steps), ``u_bytes`` (lanes, 32) uint8.
    Returns (20, lanes) int32 canonical limbs of the shared u."""
    lanes = u_bytes.shape[0]
    dev = u_bytes.device
    x1_raw, _ = fe.unpack255(u_bytes)
    x1 = fe.red(x1_raw)
    x2 = fe.red(_const(1, lanes, dev))
    z2 = fe.red(_const(0, lanes, dev))
    x3 = fe.red(x1_raw)
    z3 = fe.red(_const(1, lanes, dev))
    swap = torch.zeros(lanes, dtype=torch.int32, device=dev)
    for kt in bits:
        sw = (swap ^ kt) != 0
        x2s, x3s = fe.select(sw, x3, x2), fe.select(sw, x2, x3)
        z2s, z3s = fe.select(sw, z3, z2), fe.select(sw, z2, z3)
        a = fe.add(x2s, z2s)
        aa = fe.square(a)
        b = fe.sub(x2s, z2s)
        bb = fe.square(b)
        e = fe.sub(aa, bb)
        c = fe.add(x3s, z3s)
        d = fe.sub(x3s, z3s)
        da = fe.mul(d, a)
        cb = fe.mul(c, b)
        x3 = fe.red(fe.square(fe.add(da, cb)))
        z3 = fe.red(fe.mul(x1, fe.square(fe.sub(da, cb))))
        x2 = fe.red(fe.mul(aa, bb))
        z2 = fe.red(fe.mul(e, fe.add(aa, fe.mul_small(e, _A24))))
        swap = kt
    sw = swap != 0
    x2 = fe.select(sw, x3, x2)
    z2 = fe.select(sw, z3, z2)
    return fe.freeze(fe.mul(x2, _inv(z2)))


def bits_of_scalars(scalars: torch.Tensor) -> torch.Tensor:
    """(lanes, 32) uint8 clamped scalars -> the (255, lanes) int32 bits
    254..0 that ``ladder_core`` and the JAX ``_ladder_fn`` take."""
    x = scalars.to(torch.int32)
    rows = [(x[:, t >> 3] >> (t & 7)) & 1 for t in range(254, -1, -1)]
    return torch.stack(rows)


def bytes_of_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(20, lanes) canonical 13-bit limbs -> (lanes, 32) uint8 little-endian
    bytes."""
    bits = ((limbs.to(torch.int64)[:, :, None]
             >> torch.arange(fe.BITS, device=limbs.device)) & 1)  # (20, lanes, 13)
    bits = bits.permute(1, 0, 2).reshape(limbs.shape[1], fe.NLIMBS * fe.BITS)[:, :256]
    weights = 1 << torch.arange(8, device=limbs.device)
    return (bits.reshape(-1, 32, 8) * weights).sum(dim=2).to(torch.uint8)


def ladder_plain(scalars: torch.Tensor, u_bytes: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: (lanes, 32) uint8 clamped
    scalars and u in, (lanes, 32) uint8 shared u out."""
    return bytes_of_limbs(ladder_core(bits_of_scalars(scalars), u_bytes))


# -- bucket rules and packing -----------------------------------------------------


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def max_lanes() -> int:
    try:
        return int(os.environ.get("COMETBFT_TPU_X25519_MAX_LANES", "")
                   or _MAX_LANES_DEFAULT)
    except ValueError:
        return _MAX_LANES_DEFAULT


def bucket_lanes(n: int) -> "int | None":
    if n == 0 or n > max_lanes():
        return None
    return _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)


def clamp(scalar: bytes) -> bytes:
    """RFC 7748 5's decoding of a scalar: bits 0-2 and 255 cleared, 254 set."""
    b = bytearray(scalar)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return bytes(b)


def _pack_pairs(pairs, lanes: int):
    """(lanes, 32) uint8 clamped scalars and (lanes, 32) uint8 u; idle
    lanes ride the base point with a clamped zero scalar (bit 254 set, as
    the JAX package pads)."""
    scalars = np.zeros((lanes, 32), dtype=np.uint8)
    scalars[:, 31] = 64
    us = np.tile(np.frombuffer(BASE_U, dtype=np.uint8), (lanes, 1))
    for i, (scalar, u) in enumerate(pairs):
        scalars[i] = np.frombuffer(clamp(scalar), dtype=np.uint8)
        us[i] = np.frombuffer(u, dtype=np.uint8)
    return scalars, us


# -- the device pass ----------------------------------------------------------------


def device_exchange(pairs, device=None) -> "list[bytes]":
    """The unguarded device pass: clamp and pack on the host, copy to
    ``device`` (None: the card), one launch of the ladder kernel (CPU
    tensors: the plain version), one copy back.  Raises on any failure;
    ``exchange_batch`` supervises it."""
    runner = ladder_runner()
    if runner is not None:
        return runner(pairs)
    from cometbft_tpu_torch.ops import cuda_x25519
    from cometbft_tpu_torch.ops.verify import resolve_device

    lanes = bucket_lanes(len(pairs))
    if lanes is None:
        raise ValueError("exchange batch exceeds the device lane ladder")
    dev = resolve_device(device)
    scalars, us = (torch.from_numpy(a).to(dev) for a in _pack_pairs(pairs, lanes))
    out = cuda_x25519.ladder(scalars, us).cpu().numpy()
    return [out[i].tobytes() for i in range(len(pairs))]


def _validate(out, n: int) -> None:
    """A malformed result (a dropped lane, a short secret) is an
    infrastructure failure: it must not hand a dial someone else's
    secret."""
    if not (isinstance(out, list) and len(out) == n and all(
            isinstance(s, bytes) and len(s) == 32 for s in out)):
        raise BackendOutputError(
            f"device ladder pass returned a malformed result for {n} pairs: "
            f"{out!r:.80}")


def exchange_batch(pairs, device=None) -> "list[bytes]":
    """[(scalar32, u32)] -> [shared32], each equal to ``aead_ref.x25519``:
    the routing and supervision of the module docstring."""
    from cometbft_tpu_torch.ops import dispatch_stats, supervisor

    n = len(pairs)
    if not n:
        return []
    for scalar, u in pairs:
        if len(scalar) != 32 or len(u) != 32:
            raise ValueError("X25519 scalars and u-coordinates are 32 bytes")
    if not device_active(device):
        tstats.record_hs_dispatch(False, n)
        dispatch_stats.record_tier("host", n, X25519)
        return host_exchange(pairs)
    if device is None:  # the gate's device: the card, or one a caller named
        from cometbft_tpu_torch.verifysched import service

        device = service.gate_device()
    if ladder_runner() is None and bucket_lanes(n) is None:
        tstats.record_hs_dispatch(False, n)
        dispatch_stats.record_tier("host", n, X25519)
        dispatch_stats.record_tier("host", n, X25519_OVERSIZE)
        return host_exchange(pairs)
    lanes = _pow2_at_least(max(n, _MIN_LANES), _MIN_LANES)
    out = supervisor.traced_device_call(
        "x25519.ladder", "x25519_device_fault", BREAKER,
        lambda: device_exchange(pairs, device),
        lambda o: _validate(o, n), device=device, pairs=n, lanes=lanes)
    if out is None:  # the CPU only: the host answers below the plain version
        tstats.record_hs_dispatch(False, n)
        dispatch_stats.record_tier("host", n, X25519)
        return host_exchange(pairs)
    tstats.record_hs_dispatch(True, n, lanes)
    dispatch_stats.record_tier("cuda" if supervisor._on_card(device) else "torch",
                               n, X25519)
    return out


# -- the warm-boot hook -------------------------------------------------------------

# RFC 7748 5.2: (scalar, u, result)
RFC7748_VECTORS = (
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
)


def warm_ladder(device=None) -> "dict[str, str]":
    """The X25519 family's warm-boot hook (``ops/warmboot``): on a card,
    load the kernel's library, then one unsupervised pass of the RFC 7748
    5.2 vectors, which must give the RFC's results.  Returns {library:
    build status}; raises ``SelfCheckError`` on a wrong answer and
    whatever the build, the load or the launch raised."""
    from cometbft_tpu_torch.crypto.batch import SelfCheckError
    from cometbft_tpu_torch.ops import _build, cuda_x25519
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    names = [cuda_x25519.NAME] if dev.type == "cuda" else []
    for name in names:
        _build.load(name)
    vectors = [tuple(bytes.fromhex(x) for x in v) for v in RFC7748_VECTORS]
    got = device_exchange([(k, u) for k, u, _ in vectors], dev)
    if got != [w for _, _, w in vectors]:
        raise SelfCheckError(f"the X25519 ladder kernel failed the RFC 7748 "
                             f"vectors on {dev}")
    return _build.statuses(names)
