"""Multi-card sharding of the Ed25519 verify kernel: the port of the JAX
package's ``parallel/mesh.py``.

A 10k-validator commit is one batch of 10k independent signature checks.
The JAX package shards that batch over a 1-D TPU mesh with a ``shard_map``
whose body runs the Pallas kernel and one ``psum`` sums the accept count.
Here a mesh is a list of CUDA devices, one per shard: each shard's slice of
the packed batch is copied to its device on that ordinal's own verify
stream and verified by one launch of ``csrc/ed25519_verify.cu``
(``ops/cuda_verify.verify_core_cuda``); its bits come back behind its own
event, and the accept count is the sum of the shards' counts on the host,
where the JAX package's ``psum`` ran.  On the CPU each shard runs the
kernel's plain version (``ops/verify.verify_core``).

Ordinals are stable: ``register_devices`` numbers devices first-seen, keyed
by ``(device.type, device.index)``, the CUDA devices first in index order,
so ordinal == CUDA index on a normal host and a post-shrink mesh never
renumbers the surviving cards.  A mesh may list one device more
than once: each repeat is a virtual ordinal of its own (its own breaker,
its own stream), the counterpart of the JAX tests' forced host device
count.  Virtual ordinals on one card share its SMs, so their times are not
multi-card numbers.

Left out on purpose: ``sharded_verify_fn``'s jit cache, ``mesh_tag`` and
``sharded_verify_call`` (the XLA executable cache) and buffer donation.
The port compiles one library per kernel whatever the width
(``ops/_build``), and each shard's inputs are fresh tensors.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import dispatch_stats
from cometbft_tpu_torch.ops import verify as ov

# Packed batch arrays from ops.verify.prepare_batch, batch-major.
ARG_ORDER = ("a_bytes", "r_bytes", "s_bytes", "m_bytes", "s_ok")
# Virtual ordinals of the one card when COMETBFT_TPU_MESH=1 asks for a mesh
# on a machine with a single CUDA device (ops/verify._maybe_enable_mesh).
VIRTUAL_WIDTH = 4


class Mesh:
    """A 1-D mesh: ``devices[i]`` runs shard i under stable ordinal
    ``ordinals[i]``."""

    __slots__ = ("devices", "ordinals")

    def __init__(self, devices, ordinals):
        self.devices = [torch.device(d) for d in devices]
        self.ordinals = [int(o) for o in ordinals]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, ordinals={self.ordinals})"


# -- stable ordinals ----------------------------------------------------------

_ORDINAL_BY_KEY: dict = {}  # (type, index, repeat) -> stable ordinal
_DEVICE_BY_ORDINAL: dict = {}  # stable ordinal -> torch.device


def _key(device: torch.device, repeat: int) -> tuple:
    return (device.type, -1 if device.index is None else device.index, repeat)


def _ensure_base_registry() -> None:
    """Number the CUDA devices first, in index order, before any other
    registration (a no-op without a card)."""
    if any(k[0] == "cuda" for k in _ORDINAL_BY_KEY) or not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        o = len(_ORDINAL_BY_KEY)
        _ORDINAL_BY_KEY[_key(d, 0)] = o
        _DEVICE_BY_ORDINAL[o] = d


def register_devices(devices) -> "list[int]":
    """Assign (or look up) stable ordinals for ``devices``; returns them in
    order.  The k-th repeat of a device in the list is its k-th virtual
    ordinal."""
    _ensure_base_registry()
    out = []
    seen: Counter = Counter()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        key = _key(d, seen[_key(d, 0)])
        seen[_key(d, 0)] += 1
        o = _ORDINAL_BY_KEY.get(key)
        if o is None:
            o = len(_ORDINAL_BY_KEY)
            _ORDINAL_BY_KEY[key] = o
            _DEVICE_BY_ORDINAL[o] = d
        out.append(o)
    return out


def stable_ordinal(device, repeat: int = 0) -> int:
    """The device's stable ordinal (its ``repeat``-th virtual one), or -1
    when it was never registered (sorts last in shard iteration)."""
    return _ORDINAL_BY_KEY.get(_key(torch.device(device), repeat), -1)


def device_for_ordinal(ordinal: int) -> Optional[torch.device]:
    _ensure_base_registry()
    return _DEVICE_BY_ORDINAL.get(int(ordinal))


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over every CUDA device, or over ``devices`` (a device
    may repeat: virtual ordinals).  With no card and no devices given it
    raises, as every entry point of the port does."""
    if devices is None:
        if not torch.cuda.is_available():
            ov.resolve_device(None)  # raises: no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [ov.resolve_device(d) for d in devices]
    return Mesh(devices, register_devices(devices))


def mesh_of(ordinals: "Sequence[int]") -> Mesh:
    """The mesh over the devices of the given stable ordinals."""
    devices = [device_for_ordinal(o) for o in ordinals]
    missing = [o for o, d in zip(ordinals, devices) if d is None]
    if missing:
        raise ValueError(f"ordinals {missing} name no registered device")
    return Mesh(devices, ordinals)


def pad_to_mesh(arrays: dict, mesh: Mesh) -> dict:
    """Pad the batch axis (axis 0, batch-major layout) up to a multiple of
    the mesh size; the padding lanes are zero, ``s_ok`` False."""
    n_dev = mesh.size
    b = arrays["s_ok"].shape[0]
    pad = (-b) % n_dev
    if pad == 0:
        return arrays
    out = {}
    for k, v in arrays.items():
        if v.ndim == 1:
            out[k] = np.concatenate([v, np.zeros((pad,), v.dtype)])
        else:
            out[k] = np.concatenate([v, np.zeros((pad, v.shape[1]), v.dtype)], axis=0)
    return out


def mesh_tier(mesh: Mesh) -> str:
    """The supervisor tier the shards run: ``cuda`` when every device of
    the mesh is a card, ``torch`` (the plain version) otherwise."""
    return "cuda" if all(d.type == "cuda" for d in mesh.devices) else "torch"


# -- per-shard launch and fetch -----------------------------------------------


class _Shard:
    """One shard between its launch and its fetch: on a card the device
    tensors, the page-locked bits and the event; on the CPU its inputs,
    verified at fetch.  A launch that raised keeps its error for the
    fetch, where it is attributed to the ordinal."""

    __slots__ = ("ordinal", "device", "lo", "per", "host", "refs", "bits",
                 "event", "error")

    def __init__(self, ordinal, device, lo, per, host):
        self.ordinal = ordinal
        self.device = device
        self.lo = lo
        self.per = per
        self.host = host
        self.refs = None
        self.bits = None
        self.event = None
        self.error = None


def _launch_one(sh: _Shard) -> None:
    """Copy one shard to its card and launch the kernel on it, on the
    ordinal's verify stream, without waiting."""
    from cometbft_tpu_torch.ops import cuda_verify

    stream = ov._stream(sh.device, sh.ordinal)
    try:
        with torch.cuda.device(sh.device), torch.cuda.stream(stream):
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                 .to(sh.device, non_blocking=True) for k, v in sh.host.items()}
            accept = cuda_verify.verify_core_cuda(**t)
            sh.bits = torch.empty((sh.per,), dtype=torch.bool, pin_memory=True)
            sh.bits.copy_(accept, non_blocking=True)
            sh.refs = (t, accept)
            sh.event = torch.cuda.Event()
            sh.event.record(stream)
    except RuntimeError as e:
        sh.error = e


def _launch_shards(arrays: dict, mesh: Mesh) -> "list[_Shard]":
    """Slice a mesh-padded batch into one contiguous shard per device and
    launch every card's shard (a CPU shard waits for its fetch)."""
    lanes = arrays["s_ok"].shape[0]
    per = lanes // mesh.size
    shards = []
    for i, (dev, o) in enumerate(zip(mesh.devices, mesh.ordinals)):
        host = {k: arrays[k][i * per:(i + 1) * per] for k in ARG_ORDER}
        sh = _Shard(o, dev, i * per, per, host)
        if dev.type == "cuda":
            _launch_one(sh)
        shards.append(sh)
    return shards


def _pull(sh: _Shard) -> np.ndarray:
    """One shard's (per,) bool accept bits: its event waited for on a
    card, the plain version run on the CPU."""
    if sh.error is not None:
        raise sh.error
    if sh.device.type == "cpu":
        t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sh.host.items()}
        return ov.verify_core(**t).numpy()
    sh.event.synchronize()
    out = sh.bits.numpy().copy()
    sh.refs = None
    return out


def fetch_sharded(shards: "list[_Shard]", tier: str, lanes: int,
                  injector=None, watchdog: bool = False) -> "tuple[np.ndarray, int]":
    """Fetch the shards one by one, in stable-ordinal order: one
    ``mesh.shard`` span per ordinal (device, lanes per shard, tier, and
    the shard's accept count), its wall time on
    ``cometbft_crypto_shard_dispatch_seconds{device=}``.  Returns (the
    (lanes,) bits, the accept count summed on the host over the shards:
    the JAX package's ``psum``).

    A shard's launch or fetch error, a malformed shard, an injected fault
    (``injector``, called with the ordinal and ``None`` batch arguments)
    or a shard watchdog fire (``watchdog``) raises
    ``parallel.elastic.ShardFailure`` naming its ordinal; the elastic
    supervisor turns that into a shrink.  The raw path leaves both off."""
    from cometbft_tpu_torch.crypto.backend_health import BackendOutputError
    from cometbft_tpu_torch.ops import supervisor
    from cometbft_tpu_torch.parallel import elastic

    out = np.zeros(lanes, dtype=bool)
    n_ok = 0
    for sh in sorted(shards, key=lambda s: (s.ordinal < 0, s.ordinal)):
        t0 = time.perf_counter()
        with tracing.span("mesh.shard", device=sh.ordinal, lanes=sh.per,
                          tier=tier) as sp:

            def pull(sh=sh):
                transform = (injector(sh.ordinal, None, None, None)
                             if injector is not None else None)
                data = _pull(sh)
                return transform(data) if transform is not None else data

            try:
                if watchdog:
                    data = supervisor.watchdog_call(
                        pull, backend=elastic.breaker_name(sh.ordinal),
                        note_anomaly=False)
                else:
                    data = pull()
                data = np.asarray(data)
                if data.shape != (sh.per,) or data.dtype != np.bool_:
                    raise BackendOutputError(
                        f"mesh shard {sh.ordinal} returned shape {data.shape} "
                        f"dtype {data.dtype}, want ({sh.per},) bool")
            except Exception as e:  # noqa: BLE001 — a dead card surfaces
                # here, at fetch: a typed, ordinal-attributed failure
                raise elastic.ShardFailure(sh.ordinal, e) from e
            ok = int(data.sum())
            sp.set(ok=ok)
        n_ok += ok
        out[sh.lo:sh.lo + sh.per] = data
        dispatch_stats.record_shard_time(tier, sh.ordinal, sh.per,
                                         time.perf_counter() - t0)
    return out, n_ok


def verify_batch_sharded(
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    mesh: Optional[Mesh] = None,
    count: bool = False,
):
    """The mesh-sharded counterpart of ``ops.verify.verify_batch``: one
    ``prepare_batch``, padded to a multiple of the mesh size, one kernel
    launch per shard; returns (n,) bool (and, with ``count``, the accept
    count summed on the host over the shards).  Unsupervised, as the JAX
    package's: a failed shard raises ``ShardFailure``.

    The dispatch records the same ``verify.dispatch`` attribution as the
    single-card paths (tier, lanes, dispatch ordinal) with the mesh
    width, and the fetch a ``mesh.shard`` child span per ordinal."""
    mesh = mesh or make_mesh()
    tier = mesh_tier(mesh)
    arrays, n, structural = ov.prepare_batch(pubs, msgs, sigs)
    arrays = pad_to_mesh(arrays, mesh)
    lanes = arrays["s_ok"].shape[0]
    dispatch_stats.record_dispatch(lanes, n)
    seq = dispatch_stats.dispatch_count()
    t0 = time.perf_counter()
    with tracing.span("verify.dispatch", tier=tier, lanes=lanes, n=n,
                      dispatch=seq, mesh=mesh.size):
        host, n_ok = fetch_sharded(_launch_shards(arrays, mesh), tier, lanes)
    dispatch_stats.record_dispatch_time(tier, lanes, time.perf_counter() - t0)
    bits = (host[: len(structural)] & structural)[:n]
    return (bits, n_ok) if count else bits


# -- the elastic (supervised) device path --------------------------------------
#
# The device side of parallel/elastic.py: one mesh attempt over a CHOSEN
# set of stable ordinals, per-shard fault injection at fetch time, and the
# shard watchdog.  The shrink ladder, breakers and membership live in
# elastic.py (torch-free).


def dispatch_elastic(
    ordinals: "Sequence[int]",
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    injector=None,
) -> np.ndarray:
    """One supervised mesh dispatch over the devices with the given stable
    ordinals.  Raises ``parallel.elastic.ShardFailure`` on any
    ordinal-attributable problem (injected fault, launch or fetch error,
    malformed shard, shard watchdog fire); the elastic supervisor shrinks
    and re-dispatches.  Any other exception means the mesh itself is
    broken and the caller falls to the single-card chain."""
    from cometbft_tpu_torch.ops import supervisor

    m = mesh_of(ordinals)
    tier = mesh_tier(m)
    arrays, n, structural = ov.prepare_batch(pubs, msgs, sigs)
    arrays = pad_to_mesh(arrays, m)
    lanes = arrays["s_ok"].shape[0]
    dispatch_stats.record_dispatch(lanes, n)
    seq = dispatch_stats.dispatch_count()
    t0 = time.perf_counter()
    with tracing.span("verify.dispatch", tier=tier, lanes=lanes, n=n,
                      dispatch=seq, mesh=m.size):
        shards = supervisor.watchdog_call(
            lambda: _launch_shards(arrays, m), backend="mesh", note_anomaly=False)
        host, _ = fetch_sharded(shards, tier, lanes, injector=injector,
                                watchdog=True)
    dispatch_stats.record_dispatch_time(tier, lanes, time.perf_counter() - t0)
    return (host[: len(structural)] & structural)[:n]


def run_single_shard(
    ordinal: int,
    pubs: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    lanes: int,
) -> np.ndarray:
    """One shard's worth of verify work on ONE ordinal: the re-admission
    probe's dispatch (``parallel/elastic._probe_ordinal``) and a pinned
    lane's work (``elastic.fetch_lane``) when no mesh runner is installed.
    On a card one launch on the ordinal's own stream, waited for; on the
    CPU the plain version.  Returns (lanes,) bool, padding lanes False."""
    device = device_for_ordinal(ordinal)
    if device is None:
        raise ValueError(f"ordinal {ordinal} names no registered device")
    arrays, n, structural = ov.prepare_batch(pubs, msgs, sigs)
    sh = _Shard(int(ordinal), device, 0, arrays["s_ok"].shape[0],
                {k: arrays[k] for k in ARG_ORDER})
    if device.type == "cuda":
        _launch_one(sh)
    accept = _pull(sh)
    real = (accept[: len(structural)] & structural)[:n]
    out = np.zeros(int(lanes) if lanes else n, dtype=bool)
    out[: min(n, out.shape[0])] = real[: out.shape[0]]
    return out


def warm_shrink_shape(width: int, lanes: int) -> dict:
    """The warm-boot shrink-ladder pass's hook for one mesh shape
    (``ops/warmboot.mesh_shrink_matrix``): the JAX package precompiles the
    sharded executable there; the port compiles nothing per width, so it
    runs one known-answer sharded verify over the first ``width`` ordinals
    of the configured mesh at ``lanes`` lanes (one forged lane among valid
    ones) and checks its bits and its host-summed count.  Returns
    {"mesh{width}-{lanes}": {"status": "checked", "seconds": s}}; raises
    on a wrong answer."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.parallel import elastic

    ordinals = list(elastic._ORDINALS or range(int(width)))[: int(width)]
    m = mesh_of(ordinals)
    seed = b"\x5b" * 32
    pub = ref.pubkey_from_seed(seed)
    msgs = [b"mesh-warm-%d" % i for i in range(int(lanes))]
    sigs = [ref.sign(seed, msg) for msg in msgs]
    sigs[-1] = sigs[-1][:-1] + bytes([sigs[-1][-1] ^ 1])
    t0 = time.perf_counter()
    bits, n_ok = verify_batch_sharded([pub] * len(msgs), msgs, sigs, m, count=True)
    want = np.ones(len(msgs), dtype=bool)
    want[-1] = False
    if not (bits == want).all() or n_ok != int(want.sum()):
        raise RuntimeError(
            f"mesh warm check at width {width}: {int((bits != want).sum())} "
            f"lanes wrong, host-summed count {n_ok}")
    return {f"mesh{int(width)}-{int(lanes)}": {
        "status": "checked", "seconds": time.perf_counter() - t0}}
