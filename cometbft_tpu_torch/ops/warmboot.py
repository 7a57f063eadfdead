"""Warm-boot pass: build, load and self-check every key type and plane at
boot, so that a node's first commit after a restart meets loaded,
checked kernels.

The port's counterpart of ``cometbft_tpu/ops/warmboot.py``.  Where the JAX
package compiles a matrix of padding buckets into executables, the port
has one library per kernel whatever the lanes (``ops/_build``, whose
build directory is the cache: a library built by an earlier boot is found,
not rebuilt).  So the pass walks families, not shapes; each family's hook
loads its libraries (building what is missing) and runs its known-answer
check on the card:

  ============  ==================  ===========================================
  family        breaker             hook
  ============  ==================  ===========================================
  ed25519       ``cuda``            ``ops/verify.warm_kernels``: host_prep +
                                    ed25519_verify, ``gpu_self_check``
  secp256k1     ``secp_device``     ``ops/secp_verify.warm_ladder``:
                                    secp256k1_verify, ``secp_self_check``
  bls           ``bls_g1``          ``ops/bls_g1.warm_kernels``: bls12381 +
                                    bls_g1, ``bls_self_check``
  tree          ``merkle_device``   ``ops/sha256_tree.warm_kernels``:
                                    sha256_tree, a root against crypto/merkle
  aead          ``aead_device``     ``ops/chacha_aead.warm_kernels``:
                                    chacha20_poly1305, RFC 8439 2.8.2
  x25519        ``x25519_device``   ``ops/x25519_ladder.warm_ladder``:
                                    x25519_ladder, RFC 7748 5.2
  ============  ==================  ===========================================

The three signature families latch the card in the same process-wide sets
the batch seam reads (``crypto.batch._SELF_CHECKED``,
``_SECP_SELF_CHECKED``, ``_BLS_SELF_CHECKED``), so the first commit runs
no build and no self-check.  The measurement builds (``fe_chain``, the
stage builds of ``ops/profile``) are not warmed.

The JAX package's contract holds: a family whose breaker is OPEN is
skipped; a failed build, load or check records a failure on that
family's breaker and a demotion, logs a WARNING, and the pass goes on, so
boot never wedges.  That family's first real batch then meets the same
fault and raises ``BackendError``: no other tier serves it.  ``run()``
never raises; ``start()`` runs the pass once per process.

Enablement: an explicit ``COMETBFT_TPU_WARMBOOT`` (``0`` or anything else)
wins; otherwise the pass is on when ``COMETBFT_TPU_CRYPTO_BACKEND`` asks
for the card (``gpu`` or ``tpu``) or the trust gate
(``verifysched.backend_trusted``) is open, and off otherwise, so a CPU
process never starts ``nvcc``.  ``enabled()`` never touches the card.  As
in the JAX package, an empty ``COMETBFT_TPU_WARMBOOT_SECP_BUCKETS``,
``_BLS_BUCKETS``, ``_MERKLE_BUCKETS`` or ``_TRANSPORT_BUCKETS`` skips that
family (transport: both AEAD and X25519); their values name lane buckets
in the JAX package and mean nothing more here.

The elastic mesh's shrink ladder (``COMETBFT_TPU_WARMBOOT_MESH_SHRINK=1``,
``mesh_shrink_matrix``): the JAX package compiles the sharded executable
of the full width and of the first shrink step there.  The port compiles
nothing per width, so its pass runs one known-answer sharded verify at
each (width, lanes) shape of the matrix
(``parallel/mesh.warm_shrink_shape``): a card that fails it is found at
boot, not by the first post-shrink batch.  Counters are in
``ops/warm_stats``; the pass is a
``warmboot.run`` span with a ``warmboot.shape`` child a family
(``libs/tracing``), as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from cometbft_tpu_torch.crypto import backend_health as bh

logger = logging.getLogger("cometbft_tpu_torch.crypto")

_LOCK = threading.Lock()
_THREAD: "list[Optional[threading.Thread]]" = [None]
_DONE = threading.Event()  # a pass completed in this process

# (family, breaker, the bucket variable whose empty value skips it); no
# family is named as a library, so the two share the report's statuses
FAMILIES = (
    ("ed25519", "cuda", None),
    ("secp256k1", bh.SECP_DEVICE, "COMETBFT_TPU_WARMBOOT_SECP_BUCKETS"),
    ("bls", bh.BLS_G1, "COMETBFT_TPU_WARMBOOT_BLS_BUCKETS"),
    ("tree", bh.MERKLE_DEVICE, "COMETBFT_TPU_WARMBOOT_MERKLE_BUCKETS"),
    ("aead", bh.AEAD_DEVICE, "COMETBFT_TPU_WARMBOOT_TRANSPORT_BUCKETS"),
    ("x25519", bh.X25519_DEVICE, "COMETBFT_TPU_WARMBOOT_TRANSPORT_BUCKETS"),
)


def enabled() -> bool:
    """Whether ``start`` runs the pass: the module docstring's rule."""
    env = os.environ.get("COMETBFT_TPU_WARMBOOT")
    if env is not None:
        return env != "0"
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.verifysched import service

    if service.gate_device() is not None:
        return False  # a gate opened on a named device: no card to warm
    return cbatch.env_backend() == "gpu" or service.backend_trusted()


def matrix() -> "list[tuple[str, str]]":
    """(family, breaker) pairs to warm, in order, without the families
    whose bucket variable is set and empty."""
    out = []
    for family, breaker, env in FAMILIES:
        raw = os.environ.get(env) if env else None
        if raw is not None and not [x for x in raw.split(",") if x.strip()]:
            continue
        out.append((family, breaker))
    return out


def mesh_shrink_enabled() -> bool:
    """``COMETBFT_TPU_WARMBOOT_MESH_SHRINK=1`` opts the pass into the
    elastic mesh's shrink ladder (default off, as in the JAX package)."""
    return os.environ.get("COMETBFT_TPU_WARMBOOT_MESH_SHRINK", "0") == "1"


def mesh_shrink_matrix() -> "list[tuple[int, int]]":
    """(width, lanes) mesh shapes to warm: the full width AND the first
    shrink step (N-1) at the smallest bucket, the shape of the first
    post-shrink dispatch.  Empty when the shrink warm-up is off, the mesh
    supervisor is off, or fewer than 2 ordinals are configured."""
    if not mesh_shrink_enabled():
        return []
    from cometbft_tpu_torch.parallel import elastic

    if not elastic.enabled() or not elastic.configured():
        return []
    n = elastic.total_width()
    if n < 2:
        return []
    from cometbft_tpu_torch.ops import verify as ov

    lanes = ov.bucket_size(1, ov._BUCKETS[0])
    return [(w, lanes) for w in (n, n - 1) if w >= 2]


def _warm_mesh(width: int, lanes: int) -> "dict[str, dict]":
    """One shrink-ladder shape's known-answer sharded verify: the seam
    tests replace, as ``_warm_family``.  Returns {shape tag: info}."""
    from cometbft_tpu_torch.parallel import mesh as pmesh

    return pmesh.warm_shrink_shape(width, lanes)


def _warm_family(family: str) -> "dict[str, str]":
    """One family's hook on the card: {library: build status}.  The seam
    tests replace, as the JAX package's ``_warm_extra``."""
    if family == "ed25519":
        from cometbft_tpu_torch.ops import verify

        return verify.warm_kernels()
    if family == "secp256k1":
        from cometbft_tpu_torch.ops import secp_verify

        return secp_verify.warm_ladder()
    if family == "bls":
        from cometbft_tpu_torch.ops import bls_g1

        return bls_g1.warm_kernels()
    if family == "tree":
        from cometbft_tpu_torch.ops import sha256_tree

        return sha256_tree.warm_kernels()
    if family == "aead":
        from cometbft_tpu_torch.ops import chacha_aead

        return chacha_aead.warm_kernels()
    if family == "x25519":
        from cometbft_tpu_torch.ops import x25519_ladder

        return x25519_ladder.warm_ladder()
    raise ValueError(f"unknown warm-boot family {family!r}")


def run() -> dict:
    """Warm every family of ``matrix()`` now, in this thread; returns a
    report: ``statuses`` maps each library to its build status (``hit``,
    ``built``, ``error:<Type>``) and a family that failed or was skipped to
    ``error:<Type>`` or ``skipped:breaker-open``; ``family_seconds`` is each
    family's load and check.  Never raises."""
    from cometbft_tpu_torch.libs import tracing

    # the with-block makes the root span exception-safe: a raise anywhere
    # in the walk must not leak it onto the thread-local stack (every
    # later span on this thread would mis-parent under it)
    with tracing.span("warmboot.run"):
        return _run_families(time.perf_counter())


def _run_families(t0: float) -> dict:
    """The family walk half of ``run()``, executed inside the root span."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import warm_stats

    reg = bh.registry()
    statuses: dict = {}
    family_seconds: dict = {}
    warmed = failures = 0
    for family, breaker in matrix():
        if reg.breaker(breaker).state == bh.OPEN:
            statuses[family] = "skipped:breaker-open"
            continue
        t = time.perf_counter()
        try:
            # warm progress is span-visible: one span a family, child of
            # the pass's root span
            with tracing.span("warmboot.shape", family=family,
                              tier=breaker) as shape_sp:
                libs = _warm_family(family)
                shape_sp.set(tags=len(libs))
        except Exception as e:  # noqa: BLE001 — a failure demotes the
            # family through its breaker; boot itself never wedges
            failures += 1
            statuses[family] = f"error:{type(e).__name__}"
            reg.breaker(breaker).record_failure(e)
            reg.record_demotion(breaker)
            logger.warning("warm-boot: %s failed (%r); %s demoted via its "
                           "breaker, continuing", family, e, breaker)
        else:
            statuses.update(libs)
            warmed += len(libs)
        family_seconds[family] = time.perf_counter() - t
    # the elastic mesh's shrink ladder: no breaker here (no single tier
    # stands for the whole mesh; a sick card demotes through its own
    # mesh_dev* breaker at dispatch time), and a failure never wedges boot
    for width, lanes in mesh_shrink_matrix():
        key = f"mesh{width}-{lanes}"
        try:
            with tracing.span("warmboot.shape", family="mesh",
                              tier=f"mesh{width}", lanes=lanes) as shape_sp:
                infos = _warm_mesh(width, lanes)
                shape_sp.set(tags=len(infos))
            for tag, info in infos.items():
                statuses[tag] = str(info.get("status", "?"))
                warmed += 1
        except Exception as e:  # noqa: BLE001 — boot never wedges
            failures += 1
            statuses.setdefault(key, f"error:{type(e).__name__}")
            logger.warning("warm-boot: mesh shrink shape %s failed (%r); "
                           "continuing", key, e)
    seconds = time.perf_counter() - t0
    warm_stats.record_warm_run(seconds, warmed, 0, failures)
    logger.info("warm-boot: %d libraries warm in %.1fs (%d failures)", warmed,
                seconds, failures)
    return {
        "statuses": statuses,
        "family_seconds": family_seconds,
        "warmed": warmed,
        "failures": failures,
        "pruned": 0,
        "seconds": seconds,
    }


def start() -> "Optional[threading.Thread]":
    """Run the pass on a background daemon thread (node boot).  A no-op when
    disabled, running, or already completed in this process; returns the
    thread (the finished one after completion)."""
    if not enabled():
        return None
    with _LOCK:
        t = _THREAD[0]
        if t is not None and (t.is_alive() or _DONE.is_set()):
            return t
        t = threading.Thread(target=_run_once, name="crypto-warmboot",
                             daemon=True)
        _THREAD[0] = t
        t.start()
        return t


def _run_once() -> None:
    try:
        run()
    finally:
        _DONE.set()


def ensure_started() -> None:
    """Idempotent ``start`` for lazy call sites (the verify scheduler's
    dispatcher kicks it when the scheduler first runs)."""
    try:
        start()
    except Exception:  # noqa: BLE001 — warm boot is never load-bearing
        pass


def reset() -> None:
    """Forget the started thread and the completion latch (tests)."""
    with _LOCK:
        _THREAD[0] = None
        _DONE.clear()
