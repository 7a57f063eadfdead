"""Batched Ed25519 ZIP-215 verification: host preparation + device dispatch.

Pipeline per signature (pub, msg, sig=R||s):
  host:   h = SHA-512(R || pub || msg) mod L;  m = L - h;  s canonical check
          (C++, ``csrc/host_prep.cpp`` ``ed25519_pack``, one call per batch)
  device: unpack bytes -> limbs/digits; ZIP-215 decompress A and R;
          radix-16 Straus ladder  s*B + m*A;  subtract R;  multiply by
          cofactor 8; accept iff identity.

Every signature is verified *independently* in its own lane, so per-sig
accept bits come out for free — no recheck pass to attribute failures
(the reference needs one: types/validation.go:308-317).

The device inputs are RAW BYTES (32 B per element: pub, R, s, m).  On a
CUDA device ``verify_batch`` launches the hand-written kernel
(``ops.cuda_verify``) on the device's verify stream; on the CPU it runs
``verify_core``, the kernel's plain PyTorch version, which is what the
tests hold against the JAX package.  ``verify_batches_overlapped``,
``dispatch_segments``/``fetch_segments`` and ``verify_pipelined`` keep
several batches in flight, so the host packs one while the card verifies
another.  Every public entry goes through ``ops/supervisor`` (watchdog,
breakers, bisection; on a card the kernel answers or the call raises, on
the CPU the plain version then the host reference) unless
``COMETBFT_TPU_SUPERVISOR=0``.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from cometbft_tpu_torch import native
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import dispatch_stats
from cometbft_tpu_torch.ops import ed25519_point as ep
from cometbft_tpu_torch.ops import fe25519 as fe

L_INT = 2**252 + 27742317777372353535851937790883648493

# Batch buckets for the CPU path: pad to one of these sizes so that lane
# counts stay within a small set.  The CUDA kernel masks its ragged edge
# itself and takes the batch unpadded.
_BUCKETS = [32, 64, 128, 256, 512, 1024, 4096, 8192, 10240, 32768]


def bucket_size(n: int, min_bucket: int = _BUCKETS[0]) -> int:
    for b in _BUCKETS:
        if b < min_bucket:
            continue
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA request on a machine without
    one raises: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "backend='cpu') to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def verify_core(a_bytes, r_bytes, s_bytes, m_bytes, s_ok):
    """The plain PyTorch version of the verify kernel.

    a_bytes/r_bytes/s_bytes/m_bytes: (B, 32) uint8; s_ok: (B,) bool.
    Returns (B,) bool accept bits.
    """
    ya, sa = fe.unpack255(a_bytes)
    yr, sr = fe.unpack255(r_bytes)
    ok_a, a, ok_r, r = _decompress_pair(ya, sa, yr, sr)
    dig_s = fe.signed_digits_msb_first(s_bytes)
    dig_m = fe.signed_digits_msb_first(m_bytes)
    p = ep.double_base_scalar_mul(dig_s, dig_m, a)
    q = ep.add(p, ep.negate(r))
    # Cofactored equation: [8](s*B + m*A - R) == identity (ZIP-215).
    q = ep.double(ep.double(ep.double(q, need_t=False), need_t=False))
    return ok_a & ok_r & s_ok.to(torch.bool) & ep.is_identity(q)


def _decompress_pair(ya, sa, yr, sr):
    """Decompress A and R as ONE double-width batch: the ~250-square sqrt
    chain runs once over (20, 2B) instead of twice over (20, B)."""
    t = ya.v.shape[1]
    y_all = fe.F(torch.cat([ya.v, yr.v], dim=1), 0, fe.MASK)
    s_all = torch.cat([sa, sr])
    ok_all, p_all = ep.decompress(y_all, s_all)
    half = lambda f, i: fe.F(f.v[:, i * t : (i + 1) * t], f.lo, f.hi)
    a = ep.PointBatch(*(half(c, 0) for c in p_all))
    r = ep.PointBatch(*(half(c, 1) for c in p_all))
    return ok_all[:t], a, ok_all[t:], r


BYTE_KEYS = ("a_bytes", "r_bytes", "s_bytes", "m_bytes")


def _host_tensors(lanes: int, pin: bool = False) -> dict:
    """Zeroed host tensors of a packed batch: (lanes, 32) uint8 per byte
    array and (lanes,) bool ``s_ok``; page-locked when ``pin`` (for copies
    to the card that do not block the host).  Zeroed by numpy: torch's
    fill of a tensor this size wakes its thread pool, which costs more
    than the packing."""
    out = {
        k: torch.empty((lanes, 32), dtype=torch.uint8, pin_memory=pin)
        for k in BYTE_KEYS
    }
    out["s_ok"] = torch.empty((lanes,), dtype=torch.bool, pin_memory=pin)
    for t in out.values():
        t.numpy().fill(0)
    return out


def _pack(pubs, msgs, sigs, lanes: int, pin: bool = False):
    """Pack n triples into ``lanes`` >= n rows of raw bytes (the extra rows
    are zero with s_ok False, rejected by construction) through the host
    library's ``ed25519_pack`` (``csrc/host_prep.cpp``): SHA-512(R||A||m)
    mod L, m = L - h and the s < L check in C++, one call for the batch.
    Returns (host tensors, structural_ok).  A failed build or load of the
    host library raises: there is no Python fallback."""
    lib = native.lib()
    n = len(pubs)
    host = _host_tensors(lanes, pin)
    out = {k: v.numpy() for k, v in host.items()}
    structural = np.zeros((lanes,), bool)
    ok_idx = [i for i in range(n) if len(pubs[i]) == 32 and len(sigs[i]) == 64]
    k = len(ok_idx)
    if k:
        if k == n:
            idx, p, m, s = slice(0, n), pubs, msgs, sigs
        else:
            idx = np.asarray(ok_idx)
            p = [pubs[i] for i in ok_idx]
            m = [msgs[i] for i in ok_idx]
            s = [sigs[i] for i in ok_idx]
        pub_cat, sig_cat, msg_cat = b"".join(p), b"".join(s), b"".join(m)
        offs = np.zeros(k + 1, np.int64)
        np.cumsum([len(x) for x in m], out=offs[1:])
        s_buf = np.empty((k, 32), np.uint8)
        m_buf = np.empty((k, 32), np.uint8)
        ok_buf = np.empty((k,), np.uint8)
        rc = lib.ed25519_pack(
            pub_cat, sig_cat, msg_cat, offs.ctypes.data, k,
            s_buf.ctypes.data, m_buf.ctypes.data, ok_buf.ctypes.data,
        )
        if rc != 0:
            raise RuntimeError(f"ed25519_pack failed: rc {rc}")
        structural[idx] = True
        out["a_bytes"][idx] = np.frombuffer(pub_cat, np.uint8).reshape(k, 32)
        out["r_bytes"][idx] = np.frombuffer(sig_cat, np.uint8).reshape(k, 64)[:, :32]
        out["s_bytes"][idx] = s_buf
        out["m_bytes"][idx] = m_buf
        out["s_ok"][idx] = ok_buf.astype(bool)
    return host, structural


def _pack_plain(pubs, msgs, sigs, lanes: int):
    """The reference for ``_pack``: the same packing as a Python/hashlib
    loop.  Returns (numpy arrays, structural_ok)."""
    n = len(pubs)
    pub_arr = np.zeros((lanes, 32), np.uint8)
    r_arr = np.zeros((lanes, 32), np.uint8)
    s_bytes = np.zeros((lanes, 32), np.uint8)
    m_bytes = np.zeros((lanes, 32), np.uint8)
    s_ok = np.zeros((lanes,), bool)
    structural = np.zeros((lanes,), bool)
    for i in range(n):
        pub, msg, sig = pubs[i], msgs[i], sigs[i]
        if len(pub) != 32 or len(sig) != 64:
            continue
        structural[i] = True
        r_enc, s_enc = sig[:32], sig[32:]
        s = int.from_bytes(s_enc, "little")
        s_ok[i] = s < L_INT
        h = int.from_bytes(
            hashlib.sha512(r_enc + pub + msg).digest(), "little"
        ) % L_INT
        m = (L_INT - h) % L_INT
        pub_arr[i] = np.frombuffer(pub, np.uint8)
        r_arr[i] = np.frombuffer(r_enc, np.uint8)
        if s_ok[i]:
            s_bytes[i] = np.frombuffer(s_enc, np.uint8)
        m_bytes[i] = np.frombuffer(m.to_bytes(32, "little"), np.uint8)
    arrays = dict(
        a_bytes=pub_arr,
        r_bytes=r_arr,
        s_bytes=s_bytes,
        m_bytes=m_bytes,
        s_ok=s_ok,
    )
    return arrays, structural


def prepare_batch(
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    min_bucket: int = 128,
):
    """Host-side packing, padded to a bucket.  Returns (arrays, n,
    structural_ok): ``arrays`` holds the padded numpy device inputs (the
    JAX package's ``prepare_batch`` dict, key for key) and structural_ok
    marks length-valid entries.

    The per-signature SHA-512 + mod-L math runs in the host library
    (``_pack``); ``_pack_plain`` is its Python reference."""
    n = len(pubs)
    host, structural = _pack(pubs, msgs, sigs, bucket_size(max(n, 1), min_bucket))
    return {k: v.numpy() for k, v in host.items()}, n, structural


def batch_to_device(arrays: dict, device) -> dict:
    """The packed numpy dict -> contiguous tensors on ``device``: the
    four byte arrays as (B, 32) uint8, ``s_ok`` as (B,) uint8."""
    out = {
        k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.uint8)).to(device)
        for k in BYTE_KEYS
    }
    out["s_ok"] = torch.from_numpy(
        np.ascontiguousarray(arrays["s_ok"]).astype(np.uint8)
    ).to(device)
    return out


# -- dispatch and fetch ------------------------------------------------------
#
# Every verify goes through one packed batch in flight: ``_dispatch`` packs
# it on the host and, for the ``cuda`` tier, copies it from page-locked
# memory and launches the kernel on the device's verify stream without
# waiting; ``_fetch`` waits for that batch's event alone and returns its
# bits.  So a caller that keeps K batches in flight packs batch i+1 while
# the card verifies batch i.  The ``torch`` tier (the plain version, the
# CPU's tier) packs a bucket-padded batch and runs at fetch.
# ``ops/supervisor`` runs both halves under its watchdog.


@lru_cache(maxsize=None)
def _stream(dev: torch.device, slot: int = 0) -> "torch.cuda.Stream":
    """The stream that every kernel launch on ``dev`` runs on; a mesh
    ordinal's shards run on the stream of its own ``slot`` (virtual
    ordinals of one card each get one, ``parallel/mesh``)."""
    return torch.cuda.Stream(device=dev)


class _Flight:
    """One packed batch between its dispatch and its fetch.  It holds the
    host buffers and, for the ``cuda`` tier, the device tensors and the
    page-locked bits until its fetch has seen the event fire: a fetch
    abandoned by the watchdog leaves them all referenced here."""

    __slots__ = ("n", "structural", "host", "dev", "tier", "device_refs",
                 "bits", "event", "error")

    def __init__(self, n, structural=None, host=None, dev=None, tier=None):
        self.n = n
        self.structural = structural
        self.host = host
        self.dev = dev
        self.tier = tier
        self.device_refs = None  # the launch's inputs and output, on dev
        self.bits = None  # pinned (n,) bool, filled by the device
        self.event = None
        self.error = None  # a failed launch, raised by _fetch


def _dispatch(pubs, msgs, sigs, dev: torch.device) -> _Flight:
    """Pack a batch and, on a CUDA device, launch the kernel on it (the
    ``cuda`` tier; a card verifies with its kernel only).  On the CPU the
    batch waits for ``_fetch`` to run the plain version (the ``torch``
    tier)."""
    from cometbft_tpu_torch.ops import cuda_verify

    tier = "cuda" if dev.type == "cuda" else "torch"
    n = len(pubs)
    if n == 0:
        return _Flight(0, tier=tier)
    if tier == "torch":
        host, structural = _pack(pubs, msgs, sigs, bucket_size(n, _BUCKETS[0]))
        return _Flight(n, structural, host, dev, tier)
    host, structural = _pack(pubs, msgs, sigs, n, pin=True)
    f = _Flight(n, structural, host, dev, tier)
    stream = _stream(dev)
    try:
        with torch.cuda.stream(stream):
            t = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            accept = cuda_verify.verify_core_cuda(**t)
            f.device_refs = (t, accept)
            f.bits = torch.empty((n,), dtype=torch.bool, pin_memory=True)
            f.bits.copy_(accept, non_blocking=True)
            f.event = torch.cuda.Event()
            f.event.record(stream)
    except RuntimeError as e:
        f.error = e
    return f


def _fetch(f: _Flight) -> np.ndarray:
    """(n,) bool accept bits of a dispatched batch; raises its launch's
    failure."""
    if f.error is not None:
        raise f.error
    if f.n == 0:
        return np.zeros(0, dtype=bool)
    if f.tier == "torch":
        accept = verify_core(**f.host).numpy()
    else:
        f.event.synchronize()
        accept = f.bits.numpy()
    f.host = f.device_refs = None
    return (accept & f.structural)[: f.n]


_MESH_PROBED = [False]


def _maybe_enable_mesh() -> None:
    """One-time device probe deciding elastic-mesh activation
    (``parallel/elastic``): two or more CUDA devices, or an explicit
    ``COMETBFT_TPU_MESH=1`` (which on a one-card machine lists the card
    as ``parallel/mesh.VIRTUAL_WIDTH`` virtual ordinals).  A one-card
    machine, and every machine without a card, keeps the single-card
    supervised path exactly.  ``COMETBFT_TPU_MESH=0`` vetoes activation
    outright; a mesh configured explicitly (the simulator, tests) is left
    untouched."""
    if _MESH_PROBED[0]:
        return
    _MESH_PROBED[0] = True
    from cometbft_tpu_torch.parallel import elastic

    if not elastic.enabled() or elastic.configured():
        return
    force = os.environ.get("COMETBFT_TPU_MESH")
    if force == "0" or not torch.cuda.is_available():
        return
    count = torch.cuda.device_count()
    if count < 2 and force != "1":
        return
    from cometbft_tpu_torch.parallel import mesh as pmesh

    devices = [torch.device("cuda", i) for i in range(count)]
    if count < 2:
        devices = devices * pmesh.VIRTUAL_WIDTH
    elastic.configure(pmesh.register_devices(devices))


def reset_mesh_probe() -> None:
    """Forget the one-time activation probe (tests)."""
    _MESH_PROBED[0] = False


def verify_batch(
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device=None,
) -> np.ndarray:
    """Verify a batch; returns (n,) bool numpy array of per-signature
    results.  ``device=None`` means the CUDA card: the batch goes to the
    kernel unpadded, one launch.  ``device="cpu"`` runs the plain version
    on a bucket-padded batch.

    Supervised by default (``ops/supervisor``): the dispatch runs under a
    watchdog and breakers, and the bits are always verdicts.  On a card a
    failed or wedged launch raises ``BackendError`` (a WARNING and the
    breaker record it); on the CPU the host reference re-verifies the
    batch, visibly (a WARNING and the per-tier counter).  On a machine
    with an elastic mesh the supervised path shards the batch over it
    first (``parallel/elastic``; ``_maybe_enable_mesh`` decides once per
    process).  ``COMETBFT_TPU_SUPERVISOR=0`` restores the raw path, where
    a failed launch raises as it comes."""
    from cometbft_tpu_torch.ops import supervisor

    dev = resolve_device(device)
    if supervisor.enabled():
        _maybe_enable_mesh()
        return supervisor.verify_supervised(pubs, msgs, sigs, dev)
    tier = "cuda" if dev.type == "cuda" else "torch"
    n = len(pubs)
    with tracing.span(
        "verify.dispatch", tier=tier, lanes=supervisor._lanes(tier, n), n=n,
        dispatch=dispatch_stats.dispatch_count(),
    ):
        return _fetch(_dispatch(pubs, msgs, sigs, dev))


def verify_batches_overlapped(
    work: "Sequence[tuple[Sequence[bytes], Sequence[bytes], Sequence[bytes]]]",
    device=None,
    inflight: int = 2,
) -> "list[np.ndarray]":
    """Verify several (pubs, msgs, sigs) batches with host/device overlap:
    batch i+1 is packed (SHA-512 and packing on the host) while the card
    verifies batch i, with at most ``inflight`` batches dispatched and not
    yet fetched.  One launch per non-empty batch; bitwise-equal to
    ``verify_batch`` per batch.  On the CPU the batches run one after
    another.  Supervised by default: a failure raises on a card and
    re-verifies the affected batch on the host on the CPU, and the rest of
    the window skips the failed tier.

    Returns a list of (n,) bool arrays, one per input batch."""
    from cometbft_tpu_torch.ops import supervisor

    dev = resolve_device(device)
    if supervisor.enabled():
        return supervisor.verify_batches_overlapped_supervised(work, dev, inflight)
    depth = max(int(inflight), 1)
    out: list = [None] * len(work)
    pending: "deque[tuple[int, _Flight]]" = deque()
    for i, (pubs, msgs, sigs) in enumerate(work):
        while len(pending) >= depth:
            j, f = pending.popleft()
            out[j] = _fetch(f)
        pending.append((i, _dispatch(pubs, msgs, sigs, dev)))
    while pending:
        j, f = pending.popleft()
        out[j] = _fetch(f)
    return out


def verify_segments(
    work: "Sequence[tuple[Sequence[bytes], Sequence[bytes], Sequence[bytes]]]",
    device=None,
) -> "list[np.ndarray]":
    """Fused multi-segment verification: concatenate several (pubs, msgs,
    sigs) segments into ONE device batch and split the accept bits back
    out per segment, so K consecutive commits cost one launch instead of
    K.  Bitwise-equal to calling ``verify_batch`` per segment: every lane is
    verified independently, so fusing cannot couple results across
    segments.

    Falls back to ``verify_batches_overlapped`` when the concatenation
    would overflow the largest bucket, as the JAX package does.

    Returns a list of (n_i,) bool arrays, one per input segment."""
    sizes = [len(p) for p, _, _ in work]
    if sum(sizes) > _BUCKETS[-1]:
        return verify_batches_overlapped(work, device)
    pubs: list = []
    msgs: list = []
    sigs: list = []
    for p, m, s in work:
        pubs.extend(p)
        msgs.extend(m)
        sigs.extend(s)
    if len(work) > 1:
        dispatch_stats.record_fused(len(work))
    return _split(verify_batch(pubs, msgs, sigs, device), sizes)


def _split(bits: np.ndarray, sizes) -> "list[np.ndarray]":
    """Per-segment slices of the bits of a fused batch."""
    offs = np.cumsum([0, *sizes])
    return [bits[offs[i] : offs[i + 1]] for i in range(len(sizes))]


# -- in-flight seam ------------------------------------------------------------
#
# The async half of ``verify_segments``: ``dispatch_segments`` packs one
# fused batch and launches it without waiting for its verdicts, and
# ``fetch_segments`` resolves them later, so a caller that keeps K handles
# in flight (the light client's chain sync, blocksync's window prefetch,
# the verify scheduler) packs commit i+1 while the card verifies commit i.
# Bitwise-equal to ``verify_segments`` for any single handle.


class _SegmentsHandle:
    """One fused multi-segment verify between dispatch and fetch: a
    supervised in-flight verify (``sup``), or a raw flight when the
    supervisor is off or there is nothing to verify."""

    __slots__ = ("sizes", "flight", "sup")

    def __init__(self, sizes, flight=None, sup=None):
        self.sizes = sizes
        self.flight = flight
        self.sup = sup

    @property
    def tier(self):
        """The tier that served (or, raw, runs) this verify; ``None``
        before a supervised fetch and for empty work."""
        if self.sup is not None:
            return self.sup.tier
        return self.flight.tier if self.flight.n else None


def dispatch_segments(work, lane=None, device=None) -> _SegmentsHandle:
    """Pack the segments of ``work`` as one batch and launch it (on a CUDA
    device, without waiting); ``fetch_segments`` returns the verdicts.
    ``lane`` pins the fused dispatch at one elastic-mesh ordinal
    (round-robined by the verify scheduler) so K concurrent flushes spread
    over the lanes; with no active mesh, or an unhealthy lane, the
    single-card chain takes it (``ops/supervisor.dispatch_verify``).  A
    lane needs the supervisor: the raw path ignores it."""
    from cometbft_tpu_torch.ops import supervisor

    dev = resolve_device(device)
    sizes = [len(p) for p, _, _ in work]
    pubs = [x for p, _, _ in work for x in p]
    msgs = [x for _, m, _ in work for x in m]
    sigs = [x for _, _, s in work for x in s]
    if len(work) > 1:
        dispatch_stats.record_fused(len(work))
    if pubs and supervisor.enabled():
        _maybe_enable_mesh()
        return _SegmentsHandle(
            sizes,
            sup=supervisor.dispatch_verify(pubs, msgs, sigs, lane=lane, device=dev),
        )
    return _SegmentsHandle(sizes, flight=_dispatch(pubs, msgs, sigs, dev))


def fetch_segments(h: _SegmentsHandle) -> "list[np.ndarray]":
    """Wait for one dispatched handle: a list of (n_i,) bool arrays, one
    per input segment.  A failed launch raises here on a card (supervised,
    as ``BackendError``); on the CPU, supervised, the host answers."""
    from cometbft_tpu_torch.ops import supervisor

    if h.sup is not None:
        return _split(supervisor.fetch_verify(h.sup), h.sizes)
    return _split(_fetch(h.flight), h.sizes)


def verify_pipelined(
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    inflight: "int | None" = None,
    device=None,
) -> np.ndarray:
    """Verify one large batch in chunks with ``inflight`` (default 2)
    chunks dispatched at once, through ``verify_batches_overlapped`` (so
    supervised by default, as the JAX package's chunks go through the
    supervisor's in-flight seam).  A chunk is the largest bucket that the
    batch fills (as the JAX package with one mesh lane: a 10,240 batch is
    one chunk; the chunks do not round-robin over mesh lanes).  Bitwise-equal to ``verify_batch``:
    chunking splits lanes, never couples them."""
    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    n = len(pubs)
    fits = [b for b in _BUCKETS if b <= n]
    chunk = fits[-1] if fits else _BUCKETS[0]
    work = [
        (pubs[lo : lo + chunk], msgs[lo : lo + chunk], sigs[lo : lo + chunk])
        for lo in range(0, n, chunk)
    ]
    bits = verify_batches_overlapped(work, device, inflight or 2)
    return np.concatenate(bits) if bits else np.zeros(0, dtype=bool)


# -- the warm-boot hook -------------------------------------------------------


def warm_kernels(device=None) -> "dict[str, str]":
    """The Ed25519 family's warm-boot hook (``ops/warmboot``): load the host
    library and, on a card, the kernel's, then the batch seam's
    known-answer check (``crypto.batch.gpu_self_check``) unless ``device``
    passed it already.  A pass latches the device in
    ``crypto.batch._SELF_CHECKED``, so the first commit runs neither the
    build nor the check.  Returns {library: build status}; raises whatever
    the build, the load or the check raised."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import _build, cuda_verify

    dev = resolve_device(device)
    names = [native.NAME] + ([cuda_verify.NAME] if dev.type == "cuda" else [])
    native.lib()  # loads it and binds its functions
    for name in names[1:]:
        _build.load(name)
    cbatch.self_check_once("_SELF_CHECKED", cbatch.gpu_self_check, dev)
    return _build.statuses(names)
