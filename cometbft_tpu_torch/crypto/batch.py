"""The pluggable batch-verification seam — where the GPU plugs in.

Reference: crypto/batch/batch.go:10-27 and crypto.BatchVerifier
(crypto/crypto.go:44-52).  ``create_batch_verifier(pub_key)`` hands back a
backend-selected verifier; everything above this seam (commit verification)
is backend-agnostic, exactly as in the reference design.

Backends:
  * ``gpu`` — batched verification through ``ops.verify.verify_batch``:
    the hand-written CUDA kernel on the card (``device=None`` or a CUDA
    device), or its plain PyTorch version for ``device="cpu"``.
  * ``cpu`` — host verification through the pure-Python ZIP-215 oracle,
    one signature at a time.

Both report per-signature validity directly, so failure attribution needs
no recheck pass (the reference's types/validation.go:308-317), and both
sit behind the signature cache (``crypto/sigcache``): only entries whose
verdict is not cached reach the backend.

There is no silent demotion: with no CUDA device and no explicit CPU
request ``default_backend`` raises, and a card that fails the known-answer
self-check raises naming the check.
"""

from __future__ import annotations

import threading
from typing import Optional

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import keys as ck
from cometbft_tpu_torch.crypto import sigcache

_SELF_CHECKED: set = set()  # CUDA devices that passed the self-check
_LOCK = threading.Lock()


class SelfCheckError(RuntimeError):
    """The card failed the known-answer verify check."""


def gpu_self_check(device=None) -> None:
    """Verify a known-good + known-bad signature pair on the card before
    trusting it for consensus; a kernel regression otherwise makes the node
    reject every valid commit.  Raises ``SelfCheckError`` on a wrong answer
    (the JAX package logs and demotes to the CPU; the port refuses)."""
    from cometbft_tpu_torch.ops import verify as ov

    seed = b"\x42" * 32
    pub = ref.pubkey_from_seed(seed)
    msg = b"cometbft-tpu backend self-check"
    sig = ref.sign(seed, msg)
    bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    bits = ov.verify_batch([pub, pub], [msg, msg], [sig, bad], device)
    if not (bool(bits[0]) and not bool(bits[1])):
        raise SelfCheckError(
            "GPU crypto backend failed its known-answer self-check "
            f"(valid signature -> {bool(bits[0])}, tampered signature -> "
            f"{bool(bits[1])}); refusing to verify consensus signatures on it"
        )


def default_backend() -> str:
    """'gpu' when a CUDA device is visible *and* it passes the known-answer
    self-check (run once per process).  Raises when there is no CUDA
    device: the caller must ask for ``backend="cpu"`` or ``device="cpu"``
    explicitly."""
    from cometbft_tpu_torch.ops import verify as ov

    dev = ov.resolve_device(None)
    key = str(dev)
    with _LOCK:
        if key not in _SELF_CHECKED:
            gpu_self_check(dev)
            _SELF_CHECKED.add(key)
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


class BackendError(RuntimeError):
    """The backend gave no definitive verdict for some entries: an
    infrastructure failure, never a signature verdict."""


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
    kernel launch on a CUDA device) for all pending entries."""

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    def _verify_pending(self, pubs, msgs, sigs) -> list[bool]:
        from cometbft_tpu_torch.ops import verify as ov

        return [bool(b) for b in ov.verify_batch(pubs, msgs, sigs, self.device)]


def supports_batch_verifier(pub_key) -> bool:
    """Reference: crypto/batch/batch.go:21 — ed25519."""
    return getattr(pub_key, "type_", None) == ck.ED25519_KEY_TYPE


def create_batch_verifier(
    pub_key, backend: Optional[str] = None, device=None
) -> BatchVerifier:
    """Reference: crypto/batch/batch.go:10.  ``backend=None`` picks the
    default (the card, self-checked), unless ``device`` names a device
    explicitly, which selects the ``gpu`` backend on that device."""
    if not supports_batch_verifier(pub_key):
        raise ValueError(f"key type does not support batch verification: {pub_key}")
    if backend is None:
        backend = "gpu" if device is not None else default_backend()
    if backend == "gpu":
        return GpuBatchVerifier(device)
    if backend == "cpu":
        return CpuBatchVerifier()
    raise ValueError(f"unknown crypto backend: {backend}")
