"""Batched secp256k1 ECDSA verification: host prep and the plain PyTorch
version of the Hopper kernel (``csrc/secp256k1_verify.cu``).

The port's counterpart of ``cometbft_tpu/ops/secp_verify.py``.  Every lane
is verified on its own (no random linear combination), so failure
attribution is free.  For signature (r, s) on digest e = SHA-256(msg) with
public key Q, accept iff

    R' = u1*G + u2*Q,   u1 = e/s mod n,  u2 = r/s mod n,
    R' != O  and  x(R') = r  (mod n)

Division of labour, redesigned from the JAX package's (host decompresses
Q, packs limbs and 2 x 256 bit rows per lane, inverts Z per lane and
compares on the host):

  * host (``prepare_batch``): the structural rules of the JAX
    ``prepare_batch`` that need no curve arithmetic — 64-byte signature,
    0 < r < n, 0 < s <= n/2 (low-S only), 33-byte key with prefix 2 or 3
    and x < p — then SHA-256, s^-1 mod n, u1 and u2, as 32-byte
    big-endian rows; a lane that fails gets zero rows and ``ok`` False;
  * device (``verify_core``, the kernel): decompresses Q from its raw bytes
    (y = y2^((p+1)/4), y^2 = y2 checked, the parity fixed on the fully
    reduced y), runs the 256-step Straus/Shamir ladder u1*G + u2*Q with the
    RCB15 complete formulas (b3 = 21; ``ops.wcurve``), and compares without
    an inversion: accept iff Z != 0 and X = r*Z, or r + n < p and
    X = (r + n)*Z (mod p).  A lane with ``ok`` False is False.

``decompress_pubkey`` is the JAX module's host decompression (the
reference the tests hold the device's to).  ``verify_batch`` takes ``n``
lanes unpadded (the JAX package pads to a power of two).  ``warm_ladder``
is the family's warm-boot hook (``ops/warmboot``).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from cometbft_tpu_torch.crypto.secp256k1 import G, N, P, pt_decompress
from cometbft_tpu_torch.ops.fpgen import F, Field, select
from cometbft_tpu_torch.ops.wcurve import Curve, Point

GX, GY = G
B3 = 21  # 3*b for y^2 = x^3 + 7

FIELD = Field(P)
CURVE = Curve(FIELD, B3)

KEYS = ("q33", "u1", "u2", "r", "ok")

# SEC1 compressed point -> affine (x, y) ints, or None (the host rule the
# device's decompression is held to)
decompress_pubkey = pt_decompress


def _scalars(pub: bytes, msg: bytes, sig: bytes):
    """(u1, u2, r) of one lane, or None where a structural rule fails
    (decompression aside)."""
    if len(sig) != 64:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (0 < r < N and 0 < s <= N // 2):  # low-S only
        return None
    if len(pub) != 33 or pub[0] not in (2, 3) or int.from_bytes(pub[1:], "big") >= P:
        return None
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, N)
    return e * w % N, r * w % N, r


def prepare_batch(pubs: Sequence[bytes], msgs: Sequence[bytes],
                  sigs: Sequence[bytes]) -> dict:
    """Host prep, the JAX ``prepare_batch``'s rules but for decompression,
    which the device does.  Returns the device's inputs: ``q33`` (n, 33),
    ``u1``, ``u2``, ``r`` (n, 32) uint8 big-endian and ``ok`` (n,) bool;
    a structurally bad lane is all zeros with ``ok`` False."""
    n = len(pubs)
    assert n == len(msgs) == len(sigs)
    q33 = bytearray(33 * n)
    rows = {k: bytearray(32 * n) for k in ("u1", "u2", "r")}
    ok = np.zeros(n, bool)
    for i, (pub, msg, sig) in enumerate(zip(pubs, msgs, sigs)):
        sc = _scalars(pub, msg, sig)
        if sc is None:
            continue
        ok[i] = True
        q33[33 * i:33 * i + 33] = pub
        for k, v in zip(("u1", "u2", "r"), sc):
            rows[k][32 * i:32 * i + 32] = v.to_bytes(32, "big")
    out = {k: np.frombuffer(v, np.uint8).reshape(n, 32) for k, v in rows.items()}
    out["q33"] = np.frombuffer(q33, np.uint8).reshape(n, 33)
    out["ok"] = ok
    return out


def batch_to_device(arrays: dict, device) -> dict:
    """``prepare_batch``'s arrays as contiguous tensors on ``device`` (``ok``
    as uint8)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.uint8)).to(device)
        for k in KEYS
    }


# -- the plain PyTorch version ---------------------------------------------------


def sqrt_candidate(a: F) -> F:
    """a^((p+1)/4), the square root where one exists (p = 3 mod 4), by
    libsecp256k1's addition chain: 253 squares and 13 multiplies (the
    kernel's ``fe_sqrt``)."""
    fp = FIELD

    def sqn(x: F, k: int) -> F:
        for _ in range(k):
            x = fp.square(x)
        return x

    x2 = fp.mul(fp.square(a), a)
    x3 = fp.mul(fp.square(x2), a)
    x6 = fp.mul(sqn(x3, 3), x3)
    x9 = fp.mul(sqn(x6, 3), x3)
    x11 = fp.mul(sqn(x9, 2), x2)
    x22 = fp.mul(sqn(x11, 11), x11)
    x44 = fp.mul(sqn(x22, 22), x22)
    x88 = fp.mul(sqn(x44, 44), x44)
    x176 = fp.mul(sqn(x88, 88), x88)
    x220 = fp.mul(sqn(x176, 44), x44)
    x223 = fp.mul(sqn(x220, 3), x3)
    t = fp.mul(sqn(x223, 23), x22)
    t = fp.mul(sqn(t, 6), x2)
    return sqn(t, 2)


def scalar_bits(t: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 big-endian scalars -> (256, B) int64 bit rows, MSB
    first."""
    shifts = torch.arange(7, -1, -1, device=t.device)
    bits = (t.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(t.shape[0], 8 * t.shape[1]).T


def _below(t: torch.Tensor, bound: int) -> torch.Tensor:
    """(B,) whether the (B, 32) big-endian integers are below ``bound``."""
    fp = FIELD
    le = t.flip(1).to(torch.int64)
    limbs = (le[:, 0::2] | (le[:, 1::2] << 8)).T
    limbs = torch.nn.functional.pad(limbs, (0, 0, 0, fp.NLIMBS - limbs.shape[0]))
    return fp.compare(limbs, fp._column(bound, t.device).expand_as(limbs)) < 0


def decompress(q33: torch.Tensor):
    """(on_curve, x, y) of (B, 33) raw keys: y = y2^((p+1)/4) with its
    parity fixed on the fully reduced y; ``on_curve`` also requires the
    prefix 2 or 3 and x < p."""
    fp = FIELD
    b, dev = q33.shape[0], q33.device
    xb = q33[:, 1:]
    x = fp.from_bytes_be(xb)
    y2 = fp.add(fp.mul(fp.square(x), x), fp.const(7, b, dev))
    y = sqrt_candidate(y2)
    prefix = q33[:, 0].to(torch.int64)
    on_curve = fp.eq(fp.square(y), y2) & ((prefix == 2) | (prefix == 3)) & _below(xb, P)
    flip = (fp.canonical(y)[0] & 1) != (prefix & 1)
    return on_curve, x, select(flip, fp.neg(y), y)


def verify_core(q33, u1, u2, r, ok) -> torch.Tensor:
    """The plain PyTorch version of the verify kernel.

    q33: (B, 33) uint8 compressed keys; u1, u2, r: (B, 32) uint8
    big-endian; ok: (B,) uint8/bool.  Returns (B,) bool accept bits."""
    fp = FIELD
    b, dev = q33.shape[0], q33.device
    on_curve, qx, qy = decompress(q33)
    one = fp.const(1, b, dev)
    g = Point(fp.const(GX, b, dev), fp.const(GY, b, dev), one)
    acc = CURVE.double_scalar_mul(g, Point(qx, qy, one), scalar_bits(u1),
                                  scalar_bits(u2))
    rm = fp.from_bytes_be(r)
    rn = fp.add(rm, fp.const(N, b, dev))
    hit = fp.eq(acc.x, fp.mul(rm, acc.z)) | (
        _below(r, P - N) & fp.eq(acc.x, fp.mul(rn, acc.z)))
    return (ok != 0) & on_curve & ~fp.is_zero(acc.z) & hit


def verify_batch(pubs: Sequence[bytes], msgs: Sequence[bytes],
                 sigs: Sequence[bytes], device=None) -> np.ndarray:
    """(n,) bool accept bits.  ``device=None`` means the card (one launch
    of the kernel); ``device="cpu"`` runs the plain version; a CUDA
    request without a card raises."""
    from cometbft_tpu_torch.ops import cuda_secp
    from cometbft_tpu_torch.ops.verify import resolve_device

    n = len(pubs)
    dev = resolve_device(device)
    if n == 0:
        return np.zeros(0, bool)
    t = batch_to_device(prepare_batch(pubs, msgs, sigs), dev)
    return cuda_secp.verify_core_cuda(**t).cpu().numpy()


def warm_ladder(device=None) -> "dict[str, str]":
    """The secp256k1 family's warm-boot hook (``ops/warmboot``): on a card,
    load the kernel's library, then the batch seam's known-answer check
    (``crypto.batch.secp_self_check``) unless ``device`` passed it already,
    latching it in ``crypto.batch._SECP_SELF_CHECKED``.  Returns {library:
    build status}; raises whatever the build, the load or the check
    raised."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import _build, cuda_secp
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    names = [cuda_secp.NAME] if dev.type == "cuda" else []
    for name in names:
        _build.load(name)
    cbatch.self_check_once("_SECP_SELF_CHECKED", cbatch.secp_self_check, dev)
    return _build.statuses(names)
