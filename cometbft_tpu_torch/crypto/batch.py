"""The pluggable batch-verification seam — where the GPU plugs in.

Reference: crypto/batch/batch.go:10-27 and crypto.BatchVerifier
(crypto/crypto.go:44-52).  ``create_batch_verifier(pub_key)`` hands back a
backend-selected verifier; everything above this seam (commit verification)
is backend-agnostic, exactly as in the reference design.

Backends for Ed25519 keys:
  * ``gpu`` — batched verification through ``ops.verify.verify_batch``:
    the hand-written CUDA kernel on the card (``device=None`` or a CUDA
    device), or its plain PyTorch version for ``device="cpu"``.
  * ``cpu`` — host verification through the pure-Python ZIP-215 oracle,
    one signature at a time.

secp256k1 keys get ``Secp256k1BatchVerifier``: batched ECDSA through
``ops.secp_verify.verify_batch`` under the supervisor's single-tier call
(breaker ``secp_device``), the CUDA kernel on the card, its plain PyTorch
version for ``device="cpu"`` or ``backend="cpu"``.  (The reference
verifies secp256k1 one signature at a time; batching it is the JAX
package's extension, BASELINE config 4.)

BLS12-381 keys get ``BlsBatchVerifier``: the random-linear-combination
check e(G1, sum r_i*S_i) == prod e(r_i*pk_i, H(m_i)) with 128-bit random
r_i, its r_i * pk_i in one supervised call of ``ops.bls_g1`` (breaker
``bls_g1``; the CUDA kernel ``csrc/bls_g1.cu`` on the card, its plain
PyTorch version on the CPU), and everything else (structural checks,
hashes to G2, the G2 scaling, the aggregate, the pairing product) in the
port's host library ``csrc/bls12381.cpp``.

The Ed25519 and secp256k1 verifiers report per-signature validity
directly, so failure attribution needs no recheck pass (the reference's
types/validation.go:308-317); the BLS verifier verifies each signature on
its own when the combination fails.  All sit behind the signature cache
(``crypto/sigcache``): only entries whose verdict is not cached reach the
backend.

There is no silent demotion: with no CUDA device and no explicit CPU
request ``default_backend`` raises, a card that fails a known-answer
self-check (one per key type) raises naming the check, and on a card a
batch its kernel did not serve raises ``BackendError``.

``COMETBFT_TPU_CRYPTO_BACKEND`` is the operator's request, read first, as
in the JAX package: ``cpu`` gives the CPU verifier for every key type and
closes the trust gate (``verifysched.backend_trusted``); ``gpu``, or the
JAX package's name ``tpu``, asks for the card; ``auto`` or unset keeps
the default (the card, or a raise without one).  Any other value raises
``ValueError``.  An explicit ``backend`` or ``device`` argument wins over
the variable.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import keys as ck
from cometbft_tpu_torch.crypto import sigcache
from cometbft_tpu_torch.crypto.backend_health import (
    BLS_G1,
    SECP_DEVICE,
    BackendError,
    BackendOutputError,
)
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey, Secp256k1PubKey

_SELF_CHECKED: set = set()  # CUDA devices that passed the self-check
_SECP_SELF_CHECKED: set = set()  # ... and the secp256k1 self-check
_BLS_SELF_CHECKED: set = set()  # ... and the BLS12-381 G1 self-check
_LOCK = threading.Lock()
logger = logging.getLogger("cometbft_tpu_torch.crypto")


class SelfCheckError(RuntimeError):
    """The card failed the known-answer verify check."""


def gpu_self_check(device=None) -> None:
    """Verify a known-good + known-bad signature pair on the card before
    trusting it for consensus; a kernel regression otherwise makes the node
    reject every valid commit.  Raises ``SelfCheckError`` on a wrong answer
    (the JAX package logs and demotes to the CPU; the port refuses).  It
    runs the kernel itself, outside the supervisor's chain: a tier below
    it answering in its place would hide the fault it checks for."""
    from cometbft_tpu_torch.ops import verify as ov

    seed = b"\x42" * 32
    pub = ref.pubkey_from_seed(seed)
    msg = b"cometbft-tpu backend self-check"
    sig = ref.sign(seed, msg)
    bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    dev = ov.resolve_device(device)
    bits = ov._fetch(ov._dispatch([pub, pub], [msg, msg], [sig, bad], dev))
    if not (bool(bits[0]) and not bool(bits[1])):
        raise SelfCheckError(
            "GPU crypto backend failed its known-answer self-check "
            f"(valid signature -> {bool(bits[0])}, tampered signature -> "
            f"{bool(bits[1])}); refusing to verify consensus signatures on it"
        )


def secp_self_check(device=None) -> None:
    """The secp256k1 counterpart of ``gpu_self_check``: a known-good and a
    tampered signature through the secp256k1 kernel, outside the
    supervisor, before the card is trusted with secp256k1 commits.  Raises
    ``SelfCheckError`` on a wrong answer (the JAX package's
    ``_secp_device_ok`` falls back to host verification; the port
    refuses)."""
    from cometbft_tpu_torch.ops import secp_verify as sv

    priv = Secp256k1PrivKey.from_secret(b"cometbft-tpu secp self-check")
    pub = priv.pub_key().bytes()
    msg = b"secp backend self-check"
    sig = priv.sign(msg)
    bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    bits = sv.verify_batch([pub, pub], [msg, msg], [sig, bad], device)
    if not (bool(bits[0]) and not bool(bits[1])):
        raise SelfCheckError(
            "GPU secp256k1 backend failed its known-answer self-check "
            f"(valid signature -> {bool(bits[0])}, tampered signature -> "
            f"{bool(bits[1])}); refusing to verify consensus signatures on it"
        )


def bls_self_check(device=None) -> None:
    """The BLS12-381 counterpart of ``gpu_self_check``: known-answer G1
    scalar multiplications through ``ops.bls_g1`` outside the supervisor,
    once per device, before the card is trusted with BLS commits: the JAX
    package's known answer (the generator times 0x1234) and one 128-bit
    lane, both against the pure-Python oracle, in one launch.  Raises
    ``SelfCheckError`` on a wrong answer (the JAX package's
    ``_bls_device_ok`` falls back to host arithmetic; the port refuses)."""
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls_g1

    gen = bls.E1.affine(bls.G1_GEN)
    k = 0xB7E151628AED2A6ABF7158809CF4F3C7  # e's fraction, 128 bits
    pt = bls.E1.affine(bls.E1.mul_scalar(bls.G1_GEN, 7))
    got = bls_g1.batch_scalar_mul([gen, pt], [0x1234, k], device=device)
    want = [bls.E1.affine(bls.E1.mul_scalar(bls.G1_GEN, 0x1234)),
            bls.E1.affine(bls.E1.mul_scalar(bls.G1_GEN, 7 * k))]
    if got != want:
        raise SelfCheckError(
            "GPU BLS12-381 G1 backend failed its known-answer self-check "
            f"(lanes right: {[g == w for g, w in zip(got, want)]}); refusing "
            "to verify consensus signatures on it"
        )


def self_check_once(latch: str, check, dev) -> None:
    """Run ``check(dev)`` unless ``dev`` already passed it in this process,
    and latch it when it passes.  ``latch`` names one of this module's
    process-wide sets (``_SELF_CHECKED``, ``_SECP_SELF_CHECKED``,
    ``_BLS_SELF_CHECKED``), read by name at each call: the batch seam and
    the warm-boot hooks (``ops/warmboot``) fill the same sets, so a card
    checked at boot is not checked again by its first batch."""
    key = str(dev)
    with _LOCK:
        done = globals()[latch]
        if key not in done:
            check(dev)
            done.add(key)


def env_backend() -> Optional[str]:
    """The backend that ``COMETBFT_TPU_CRYPTO_BACKEND`` asks for: ``"cpu"``,
    ``"gpu"`` (also for ``tpu``, the JAX package's accelerator), or None
    when it is unset or ``auto``.  Raises ``ValueError`` on any other
    value."""
    env = os.environ.get("COMETBFT_TPU_CRYPTO_BACKEND", "")
    if env in ("", "auto"):
        return None
    if env in ("gpu", "tpu"):
        return "gpu"
    if env == "cpu":
        return "cpu"
    raise ValueError(f"unknown COMETBFT_TPU_CRYPTO_BACKEND: {env!r}")


def default_backend() -> str:
    """'cpu' when ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``; otherwise 'gpu' when
    a CUDA device is visible *and* it passes the known-answer self-check
    (run once per process).  Raises when there is no CUDA device: the
    caller must ask for the CPU explicitly (``backend="cpu"``,
    ``device="cpu"`` or the variable)."""
    from cometbft_tpu_torch.ops import verify as ov

    if env_backend() == "cpu":
        return "cpu"
    self_check_once("_SELF_CHECKED", gpu_self_check, ov.resolve_device(None))
    return "gpu"


class BatchVerifier:
    """Collects (pubkey, msg, sig) triples; verify() returns the overall
    result plus per-signature validity bits."""

    def add(self, pub_key, msg: bytes, sig: bytes) -> None:
        raise NotImplementedError

    def verify(self) -> tuple[bool, list[bool]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class _CollectingVerifier(BatchVerifier):
    """Shared collection + the two pre-device filters every backend wants:

    1. signature-cache prefilter — verdicts already known (e.g. votes
       verified at gossip time) never reach the backend again; only cache
       MISSES are verified, and fresh verdicts are written back;
    2. structural short-circuit — entries whose pub/sig lengths make them
       impossible for ed25519 are resolved to False on the host, so garbage
       does not occupy device lanes.

    Subclasses implement ``_verify_pending(pubs, msgs, sigs)`` over the
    surviving entries, returning definitive verdicts or raising.
    ``COMETBFT_TPU_SIGCACHE=0`` turns filter 1 off."""

    PUB_SIZES = (32,)
    SIG_SIZES = (64,)

    def __init__(self):
        self.pubs: list[bytes] = []
        self.msgs: list[bytes] = []
        self.sigs: list[bytes] = []

    def add(self, pub_key, msg: bytes, sig: bytes) -> None:
        data = pub_key.bytes() if hasattr(pub_key, "bytes") else bytes(pub_key)
        self.pubs.append(data)
        self.msgs.append(msg)
        self.sigs.append(sig)

    def __len__(self) -> int:
        return len(self.pubs)

    def _verify_pending(
        self, pubs: list[bytes], msgs: list[bytes], sigs: list[bytes]
    ) -> list[bool]:
        raise NotImplementedError

    def verify(self) -> tuple[bool, list[bool]]:
        if not self.pubs:
            return False, []
        bits, pending = sigcache.partition_misses(
            self.pubs, self.msgs, self.sigs, self.PUB_SIZES, self.SIG_SIZES
        )
        if pending:
            # An infrastructure failure raises out of ``_verify_pending``
            # before anything is written back: nothing is cached, and the
            # caller sees an error, not a False bit.
            got = self._verify_pending(
                [self.pubs[i] for i in pending],
                [self.msgs[i] for i in pending],
                [self.sigs[i] for i in pending],
            )
            sigcache.writeback(
                self.pubs, self.msgs, self.sigs, bits, pending, got
            )
        if any(b is None for b in bits):
            raise BackendError(
                "batch backend produced no definitive verdict for some "
                "entries (infrastructure failure, not a signature verdict)"
            )
        bits = [bool(b) for b in bits]
        return all(bits), bits


class CpuBatchVerifier(_CollectingVerifier):
    def _verify_pending(self, pubs, msgs, sigs) -> list[bool]:
        return [
            ck.Ed25519PubKey(p).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)
        ]


class GpuBatchVerifier(_CollectingVerifier):
    """The ``TpuBatchVerifier`` counterpart: one ``verify_batch`` call (one
    kernel launch on a CUDA device) for all pending entries.  On the
    default device, with the verify scheduler active, they go through
    ``verifysched.verify_segment_sync``: fewer than a flush's worth
    coalesce with concurrent gossip-time work into one flush, more are one
    direct supervised launch, as here.  A verifier on the device a caller
    holds the gate open on (``verifysched.open_gate``) bridges to the
    scheduler there."""

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    def _verify_pending(self, pubs, msgs, sigs) -> list[bool]:
        from cometbft_tpu_torch import verifysched
        from cometbft_tpu_torch.ops import verify as ov

        if verifysched.scheduler_active() and verifysched.on_gate_device(self.device):
            # the scheduler resolves only definitive supervised verdicts,
            # at the caller's ambient priority class
            return verifysched.verify_segment_sync(pubs, msgs, sigs)
        return [bool(b) for b in ov.verify_batch(pubs, msgs, sigs, self.device)]


class Secp256k1BatchVerifier(_CollectingVerifier):
    """Batched ECDSA over secp256k1 keys (33-byte SEC1, 64-byte R||S): all
    pending entries in one supervised call of ``ops.secp_verify.
    verify_batch`` (breaker ``secp_device``), one kernel launch on the card.

    On a card the first batch runs ``secp_self_check``; a batch the kernel
    did not serve raises ``BackendError`` (the JAX class answers it on the
    host instead).  On the CPU the plain PyTorch version is the device tier,
    and the host oracle answers below it, as for Ed25519.  The tier that
    served each batch is counted in ``ops.dispatch_stats``
    (``tier_counts("secp256k1")``)."""

    PUB_SIZES = (33,)
    SIG_SIZES = (64,)

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    def _verify_pending(self, pubs, msgs, sigs) -> list[bool]:
        from cometbft_tpu_torch.ops import dispatch_stats, supervisor
        from cometbft_tpu_torch.ops import secp_verify as sv
        from cometbft_tpu_torch.ops.verify import resolve_device

        dev = resolve_device(self.device)
        n = len(pubs)
        if dev.type == "cuda":
            self_check_once("_SECP_SELF_CHECKED", secp_self_check, dev)
        if not supervisor.enabled():
            return [bool(b) for b in sv.verify_batch(pubs, msgs, sigs, dev)]

        def validate(bits) -> None:
            bits = np.asarray(bits)
            if bits.shape != (n,) or bits.dtype != np.bool_:
                raise BackendOutputError(
                    f"secp device returned shape {bits.shape} dtype "
                    f"{bits.dtype} for {n} inputs"
                )

        bits = supervisor.supervised_device_call(
            SECP_DEVICE, lambda: sv.verify_batch(pubs, msgs, sigs, dev),
            validate, fallback_units=n, device=dev, inputs=(pubs, msgs, sigs),
        )
        if bits is None:  # the CPU only: the host oracle answers
            dispatch_stats.record_tier("host", n, ck.SECP256K1_KEY_TYPE)
            logger.warning("secp256k1 batch of %d signatures served by the "
                           "host tier", n)
            return [Secp256k1PubKey(p).verify_signature(m, s)
                    for p, m, s in zip(pubs, msgs, sigs)]
        dispatch_stats.record_tier("cuda" if dev.type == "cuda" else "torch", n,
                                   ck.SECP256K1_KEY_TYPE)
        return [bool(b) for b in bits]


class BlsBatchVerifier(_CollectingVerifier):
    """Random-linear-combination batch verification for bls12_381 (the JAX
    class's ``_verify_native``):

        e(G1, sum r_i*S_i)  ==  prod e(r_i*pk_i, H(m_i)),   r_i random 128-bit

    n + 1 Miller loops and one final exponentiation instead of n
    verifies.  In order: the structural filter (96-byte keys and
    signatures, KeyValidate and SigValidate(false) in the host library);
    a lone entry verified on its own; r_i = ``secrets.randbits(128) | 1``;
    the r_i * pk_i in one supervised call of ``ops.bls_g1`` (breaker
    ``bls_g1``: one kernel launch on the card); r_i * S_i, H(m_i), the
    aggregate and the pairing product in the host library; each entry
    verified on its own (attribution) when the combination fails or a
    host-library op returns an error (the reference's recheck pass,
    types/validation.go:308-317; crypto/bls12381/key_bls12381.go:160-188).

    On a card the first batch runs ``bls_self_check``, and a G1 call the
    kernel did not serve raises ``BackendError`` (the JAX class drops to
    host arithmetic).  On the CPU the plain PyTorch version is the device
    tier and the host library's ``bls_g1_scalar_mul`` answers below it.
    The tier that served each G1 call is counted in ``ops.dispatch_stats``
    (``tier_counts("bls12_381")``)."""

    PUB_SIZES = (96,)  # bls12381.PUB_KEY_SIZE (uncompressed G1)
    SIG_SIZES = (96,)  # bls12381.SIGNATURE_SIZE (compressed G2)

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    def _verify_pending(self, pubs, msgs, sigs) -> list[bool]:
        import secrets

        from cometbft_tpu_torch.crypto import bls12381 as bls
        from cometbft_tpu_torch.ops.verify import resolve_device

        dev = resolve_device(self.device)
        lib = bls._nat()
        bits = [False] * len(pubs)
        entries = [
            i for i, (pub, sig) in enumerate(zip(pubs, sigs))
            if len(pub) == bls.PUB_KEY_SIZE and len(sig) == bls.SIGNATURE_SIZE
            and lib.bls_pubkey_validate(pub, len(pub)) == 1
            and lib.bls_sig_validate(sig) == 1
        ]
        if len(entries) <= 1:
            for i in entries:
                bits[i] = bls.verify(pubs[i], msgs[i], sigs[i])
            return bits
        rs = [secrets.randbits(128) | 1 for _ in entries]
        r_bytes = [r.to_bytes(16, "big") for r in rs]
        g1_parts = self._neg_scaled_pubkeys(
            [pubs[i] for i in entries], [msgs[i] for i in entries],
            [sigs[i] for i in entries], rs, dev,
        )
        if g1_parts is None:
            return self._per_signature(pubs, msgs, sigs, entries, bits)
        scaled_sigs, hashes = [], []
        for i, rb in zip(entries, r_bytes):
            so = ctypes.create_string_buffer(96)
            ho = ctypes.create_string_buffer(96)
            if (lib.bls_g2_scalar_mul_compressed(sigs[i], rb, 16, so) != 0
                    or lib.bls_hash_to_g2(msgs[i], len(msgs[i]), ho) != 0):
                return self._per_signature(pubs, msgs, sigs, entries, bits)
            scaled_sigs.append(so.raw)
            hashes.append(ho.raw)
        agg = ctypes.create_string_buffer(96)
        if lib.bls_aggregate_sigs(b"".join(scaled_sigs), len(entries), agg) != 0:
            return self._per_signature(pubs, msgs, sigs, entries, bits)
        g1cat = b"".join(g1_parts) + bls.g1_serialize(bls.G1_GEN)
        g2cat = b"".join(hashes) + agg.raw
        if lib.bls_pairing_product_is_one_serialized(
                g1cat, g2cat, len(entries) + 1) == 1:
            for i in entries:
                bits[i] = True
            return bits
        # attribution: the combination failed, find the culprits
        return self._per_signature(pubs, msgs, sigs, entries, bits)

    @staticmethod
    def _per_signature(pubs, msgs, sigs, entries, bits) -> list[bool]:
        """Verify each structurally valid entry on its own: the refuge when
        the combination fails, and when a host-library batch op errors
        (an infrastructure failure, not evidence against any signature)."""
        from cometbft_tpu_torch.crypto import bls12381 as bls

        for i in entries:
            bits[i] = bls.verify(pubs[i], msgs[i], sigs[i])
        return bits

    @staticmethod
    def _neg_scaled_pubkeys(pubs, msgs, sigs, rs, dev):
        """[-(r_i * pk_i)] serialized, from the G1 kernel (its plain version
        on the CPU) under the supervisor; on the CPU, where the device tier
        did not serve, from the host library; None if that errs."""
        from cometbft_tpu_torch.crypto import bls12381 as bls
        from cometbft_tpu_torch.ops import bls_g1, dispatch_stats, supervisor

        n = len(pubs)
        if dev.type == "cuda":
            self_check_once("_BLS_SELF_CHECKED", bls_self_check, dev)
        if not supervisor.enabled():
            return bls_g1.neg_scaled_pubkeys(pubs, rs, dev)

        def validate(out) -> None:
            if len(out) != n or any(len(p) != bls.PUB_KEY_SIZE for p in out):
                raise BackendOutputError(
                    f"bls_g1 returned {len(out)} points for {n} inputs"
                )

        out = supervisor.supervised_device_call(
            BLS_G1, lambda: bls_g1.neg_scaled_pubkeys(pubs, rs, dev), validate,
            fallback_units=n, device=dev, inputs=(pubs, msgs, sigs),
        )
        if out is not None:
            dispatch_stats.record_tier("cuda" if dev.type == "cuda" else "torch",
                                       n, ck.BLS12381_KEY_TYPE)
            return out
        # the CPU only: the host library answers
        dispatch_stats.record_tier("host", n, ck.BLS12381_KEY_TYPE)
        logger.warning("bls12_381 G1 batch of %d keys served by the host tier", n)
        lib = bls._nat()
        out = []
        for pub, r in zip(pubs, rs):
            buf = ctypes.create_string_buffer(96)
            if lib.bls_g1_scalar_mul(pub, r.to_bytes(16, "big"), 16, buf) != 0:
                return None
            out.append(bls.g1_negate_serialized(buf.raw))
        return out


def supports_batch_verifier(pub_key) -> bool:
    """Reference: crypto/batch/batch.go:21 — ed25519 there; bls12_381 joins
    by the aggregate path (key_bls12381.go:160-188); secp256k1 is the JAX
    package's extension (BASELINE config 4)."""
    return getattr(pub_key, "type_", None) in (
        ck.ED25519_KEY_TYPE, ck.SECP256K1_KEY_TYPE, ck.BLS12381_KEY_TYPE,
    )


def create_batch_verifier(
    pub_key, backend: Optional[str] = None, device=None
) -> BatchVerifier:
    """Reference: crypto/batch/batch.go:10, routed by key type as the JAX
    package's.  For Ed25519, ``backend=None`` picks the default (the card,
    self-checked), unless ``device`` names a device explicitly, which
    selects the ``gpu`` backend on that device.  A secp256k1 key gets
    ``Secp256k1BatchVerifier`` and a BLS12-381 key ``BlsBatchVerifier`` on
    ``device`` (None: the card), or on the CPU for ``backend="cpu"``.  With
    neither ``backend`` nor ``device``, ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``
    means ``backend="cpu"``."""
    if not supports_batch_verifier(pub_key):
        raise ValueError(f"key type does not support batch verification: {pub_key}")
    if backend is None and device is None and env_backend() == "cpu":
        backend = "cpu"
    if pub_key.type_ in (ck.SECP256K1_KEY_TYPE, ck.BLS12381_KEY_TYPE):
        if backend == "cpu":
            device = "cpu"
        elif backend not in (None, "gpu"):
            raise ValueError(f"unknown crypto backend: {backend}")
        if pub_key.type_ == ck.SECP256K1_KEY_TYPE:
            return Secp256k1BatchVerifier(device)
        return BlsBatchVerifier(device)
    if backend is None:
        backend = "gpu" if device is not None else default_backend()
    if backend == "gpu":
        return GpuBatchVerifier(device)
    if backend == "cpu":
        return CpuBatchVerifier()
    raise ValueError(f"unknown crypto backend: {backend}")
