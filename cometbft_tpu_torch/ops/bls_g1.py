"""Batched BLS12-381 G1 scalar multiplication: the host API and the plain
PyTorch version of the Hopper kernel (``csrc/bls_g1.cu``).

The port's counterpart of ``cometbft_tpu/ops/bls_g1.py``'s
``batch_scalar_mul``: per lane s_i * P_i on y^2 = x^3 + 4 over GF(P381),
the curve layer of ``ops.wcurve`` bound to ``ops.fp381``, for the
random-linear-combination check of ``crypto.batch.BlsBatchVerifier``
(r_i * pk_i with 128-bit r_i), and its ``msm`` (sum s_i * P_i) and
``sum_points`` (sum P_i).  Those two have no caller on a verify path (the
JAX ones serve its tests and warm boot); on a card ``msm``'s products are
one launch of the kernel, and the lane sum (``wcurve.Curve.lane_sum``, a
log2(B) pairwise fold) runs as a torch tier on the same device: the JAX
``_msm_kernel``/``_sum_kernel`` are XLA programs with no Pallas kernel.

Division of labour, redesigned from the JAX package's (host packs
Montgomery limbs and (nbits, B) bit rows, the device program runs the
ladder, the host unpacks):

  * host: points as raw 96-byte uncompressed G1 (x || y big-endian, byte
    0 = 0x40 for the point at infinity) and scalars as 16-byte big-endian
    rows;
  * device (``ops.cuda_bls.scalar_mul_cuda``: the kernel on a card, its
    plain version here for CPU tensors): s_i * P_i over the low ``nbits``
    bits of s_i, out as canonical X || Y || Z, 144 bytes a lane, a
    projective representative of the point;
  * host: affine coordinates (``affine``), or, for the verifier, the
    negated points serialized for the pairing product
    (``neg_scaled_pubkeys``).

The plain version runs the JAX ladder's sequence of field operations
(MSB-first double-and-add of ``wcurve.Curve.scalar_mul``, RCB15's
complete projective formulas), so its canonical (X, Y, Z) equal the JAX
program's as ints.  The kernel computes the same points another way
(Jacobian coordinates, signed windows) and hands out (X Z : Y : Z^3): its
bytes equal the plain version's as points, X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1
(mod p) with Z = 0 on both sides or neither (``points_equal``), not byte
for byte.  Both give Z = 0 for the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cometbft_tpu_torch.ops import fp381
from cometbft_tpu_torch.ops.fpgen import F, select
from cometbft_tpu_torch.ops.wcurve import Curve, Point

P = fp381.P_INT
B3 = 12  # 3 * b for y^2 = x^3 + 4
FIELD = fp381.FIELD
CURVE = Curve(FIELD, B3)

MAX_BITS = 128  # the kernel's scalar row: 16 bytes
INFINITY = b"\x40" + bytes(95)  # ZCash flags: uncompressed point at infinity


# -- the plain PyTorch version ----------------------------------------------------


def scalar_bits(scalars: torch.Tensor, nbits: int) -> torch.Tensor:
    """(nbits, n) int64 rows of 0/1, MSB first, of the low ``nbits`` bits
    of (n, 16) uint8 big-endian scalars."""
    n = scalars.shape[0]
    shifts = torch.arange(7, -1, -1, device=scalars.device)
    bits = (scalars.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(n, 8 * scalars.shape[1])[:, -nbits:].T


def canonical_be(f: F) -> torch.Tensor:
    """(B, 48) uint8: the fully reduced values of ``f``, big-endian."""
    v = FIELD.canonical(f)[:24]  # 16-bit limbs; the top two are 0 below p
    le = torch.stack([v & 0xFF, v >> 8], 1).reshape(48, -1)
    return le.flip(0).T.to(torch.uint8)


def points_from_bytes(pts: torch.Tensor) -> Point:
    """(n, 96) uint8 uncompressed points (0x40 flag: infinity) -> a
    projective batch on their device."""
    n, dev = pts.shape[0], pts.device
    inf = (pts[:, 0] & 0x40) != 0
    xb = pts[:, :48].clone()
    xb[:, 0] &= 0x1F  # the flag bits
    x = FIELD.from_bytes_be(xb)
    y = FIELD.from_bytes_be(pts[:, 48:])
    zero, one = FIELD.const(0, n, dev), FIELD.const(1, n, dev)
    return Point(select(inf, zero, x), select(inf, one, y), select(inf, zero, one))


def points_from_xyz(xyz: torch.Tensor) -> Point:
    """(n, 144) uint8 canonical X || Y || Z rows (the kernel's output) ->
    a projective batch on their device."""
    return Point(*(FIELD.from_bytes_be(xyz[:, 48 * c : 48 * c + 48])
                   for c in range(3)))


def xyz_bytes(p: Point) -> torch.Tensor:
    """A projective batch -> (n, 144) uint8 canonical X || Y || Z."""
    return torch.cat([canonical_be(c) for c in p], 1)


def batch_scalar_mul_plain(pts: torch.Tensor, scalars: torch.Tensor,
                           nbits: int = MAX_BITS) -> torch.Tensor:
    """The kernel's plain version: (n, 144) uint8 canonical X || Y || Z of
    s_i * P_i for (n, 96) uint8 points and (n, 16) uint8 scalars."""
    base = points_from_bytes(pts)
    return xyz_bytes(CURVE.scalar_mul(base, scalar_bits(scalars, nbits)))


def lane_sum_xyz(p: Point) -> torch.Tensor:
    """(1, 144) uint8 canonical X || Y || Z of the sum of a batch's points:
    the batch padded with the identity to a power of two, then
    ``Curve.lane_sum`` on its device."""
    n, dev = p.x.v.shape[1], p.x.v.device
    pad = (1 << max(n - 1, 0).bit_length()) - n
    if pad:
        ident = CURVE.identity(pad, dev)
        p = Point(*(F(torch.cat([a.v, b.v], 1), max(a.hi, b.hi), max(a.val, b.val))
                    for a, b in zip(p, ident)))
    return xyz_bytes(CURVE.lane_sum(p))


# -- the host API -------------------------------------------------------------------


def points_to_bytes(points: Sequence[Optional[tuple]]) -> np.ndarray:
    """Affine (x, y) int pairs (None = infinity) -> (n, 96) uint8 rows."""
    rows = [INFINITY if pt is None else
            (pt[0] % P).to_bytes(48, "big") + (pt[1] % P).to_bytes(48, "big")
            for pt in points]
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), 96)


def scalars_to_bytes(scalars: Sequence[int], nbits: int = MAX_BITS) -> np.ndarray:
    """Scalars below 2^nbits -> (n, 16) uint8 big-endian rows."""
    if not 1 <= nbits <= MAX_BITS:
        raise ValueError(f"nbits {nbits} outside 1..{MAX_BITS}")
    for j, s in enumerate(scalars):
        if not 0 <= s < 1 << nbits:
            raise ValueError(f"scalar {j} exceeds {nbits} bits")
    rows = b"".join(s.to_bytes(16, "big") for s in scalars)
    return np.frombuffer(rows, np.uint8).reshape(len(scalars), 16)


def _coords(xyz: np.ndarray) -> list:
    """(n, 144) uint8 X || Y || Z -> [(X, Y, Z)] ints."""
    return [tuple(int.from_bytes(row[48 * c:48 * c + 48].tobytes(), "big")
                  for c in range(3)) for row in xyz]


def points_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n,) bool: lane i of the (n, 144) uint8 X || Y || Z arrays ``a`` and
    ``b`` is the same projective point: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1
    (mod p), and Z1 = 0 exactly when Z2 = 0 (the identity)."""
    if a.shape != b.shape:
        raise ValueError(f"shapes {a.shape} and {b.shape}")
    out = np.zeros(a.shape[0], bool)
    for i, ((x1, y1, z1), (x2, y2, z2)) in enumerate(zip(_coords(a), _coords(b))):
        if z1 % P == 0 or z2 % P == 0:
            out[i] = z1 % P == z2 % P == 0
        else:
            out[i] = (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0
    return out


def affine(xyz: np.ndarray) -> list:
    """(n, 144) uint8 projective X || Y || Z -> affine (x, y) int pairs,
    None where Z = 0."""
    out = []
    for x, y, z in _coords(xyz):
        zi = pow(z, -1, P) if z else 0
        out.append((x * zi % P, y * zi % P) if z else None)
    return out


def _products(pts: np.ndarray, scalars: np.ndarray, nbits: int,
              dev: torch.device) -> torch.Tensor:
    """(n, 144) uint8 X || Y || Z of s_i * P_i on ``dev``: one launch of the
    kernel on a card, the plain version on the CPU."""
    from cometbft_tpu_torch.ops import cuda_bls

    t = [torch.from_numpy(a.copy()).to(dev) for a in (pts, scalars)]
    return cuda_bls.scalar_mul_cuda(*t, nbits)


def _run(pts: np.ndarray, scalars: np.ndarray, nbits: int, device) -> np.ndarray:
    """``_products`` on ``device`` (None: the card), copied back."""
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    if pts.shape[0] == 0:
        return np.zeros((0, 144), np.uint8)
    return _products(pts, scalars, nbits, dev).cpu().numpy()


def batch_scalar_mul(points: Sequence[Optional[tuple]], scalars: Sequence[int],
                     nbits: int = MAX_BITS, device=None) -> list:
    """Per lane scalar_i * point_i, affine (x, y) ints or None for
    infinity (the JAX ``batch_scalar_mul``).  ``device=None`` means the
    card (one launch of the kernel); ``device="cpu"`` runs the plain
    version; a CUDA request without a card raises."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")
    xyz = _run(points_to_bytes(points), scalars_to_bytes(scalars, nbits),
               nbits, device)
    return affine(xyz)


def neg_scaled_pubkeys(pubs: Sequence[bytes], scalars: Sequence[int],
                       device=None) -> list:
    """[-(r_i * pk_i)] as 96-byte uncompressed G1 (0x40 || 0... for the
    identity), ready for the host library's pairing product, for 96-byte
    uncompressed pubkeys (already validated) and 128-bit scalars: one
    launch on a card, the plain version on the CPU."""
    if len(pubs) != len(scalars):
        raise ValueError(f"{len(pubs)} pubkeys, {len(scalars)} scalars")
    pts = np.frombuffer(b"".join(pubs), np.uint8).reshape(len(pubs), 96)
    xyz = _run(pts, scalars_to_bytes(scalars), MAX_BITS, device)
    return [INFINITY if a is None else
            a[0].to_bytes(48, "big") + ((P - a[1]) % P).to_bytes(48, "big")
            for a in affine(xyz)]


def msm(points: Sequence[Optional[tuple]], scalars: Sequence[int],
        nbits: int = MAX_BITS, device=None) -> Optional[tuple]:
    """sum of scalar_i * point_i, affine (x, y) ints or None for infinity
    (the JAX ``msm``).  ``device=None`` means the card: one launch of the
    kernel for the products, then ``lane_sum`` on the card (a torch tier);
    ``device="cpu"`` runs the plain version and the same fold; a CUDA
    request without a card raises, and so does a failed launch."""
    from cometbft_tpu_torch.ops.verify import resolve_device

    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")
    if not points:
        return None
    dev = resolve_device(device)
    xyz = _products(points_to_bytes(points), scalars_to_bytes(scalars, nbits),
                    nbits, dev)
    return affine(lane_sum_xyz(points_from_xyz(xyz)).cpu().numpy())[0]


def sum_points(points: Sequence[Optional[tuple]], device=None) -> Optional[tuple]:
    """sum of point_i, affine (x, y) ints or None for infinity (the JAX
    ``sum_points``): ``lane_sum`` on ``device`` (None: the card; no
    kernel, a torch tier)."""
    from cometbft_tpu_torch.ops.verify import resolve_device

    if not points:
        return None
    dev = resolve_device(device)
    pts = torch.from_numpy(points_to_bytes(points).copy()).to(dev)
    return affine(lane_sum_xyz(points_from_bytes(pts)).cpu().numpy())[0]


def warm_kernels(device=None) -> "dict[str, str]":
    """The BLS12-381 family's warm-boot hook (``ops/warmboot``): load the
    host library (``native.bls()``, which runs its pairing self-check)
    and, on a card, the G1 kernel's, then the batch seam's known-answer
    check (``crypto.batch.bls_self_check``) unless ``device`` passed it
    already, latching it in ``crypto.batch._BLS_SELF_CHECKED``.  Returns
    {library: build status}; raises whatever the build, the load or a
    check raised."""
    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import _build, cuda_bls
    from cometbft_tpu_torch.ops.verify import resolve_device

    dev = resolve_device(device)
    names = [native.BLS_NAME] + ([cuda_bls.NAME] if dev.type == "cuda" else [])
    native.bls()  # loads it, binds it and runs its pairing self-check
    for name in names[1:]:
        _build.load(name)
    cbatch.self_check_once("_BLS_SELF_CHECKED", cbatch.bls_self_check, dev)
    return _build.statuses(names)
