"""Batched transaction ingestion (docs/tx-ingest.md).

The first *user-facing* workload on the crypto seam: signed-tx envelopes
(``envelope``), the ``SigVerifyingApp`` ABCI middleware that hoists tx
signature checks out of applications (``middleware``), and the ingest
coalescer that admits whole gossip bursts through one batched CheckTx
round trip with envelope signatures verified as the verifysched bulk
class (``coalescer``).  ``stats`` holds the jax-free process-wide
counters ``libs/metrics`` exposes as ``cometbft_mempool_*``.

Kill switch: ``COMETBFT_TPU_TXINGEST=0`` restores the per-tx
``check_tx`` admission path bit-for-bit.

The port's copy: ``IngestCoalescer`` and ``SigVerifyingApp`` take
``device`` (None: the card), and batches go through the port's verify
scheduler at ``PRIO_MEMPOOL`` to the Ed25519 kernel.
"""

from cometbft_tpu_torch.txingest import envelope, stats
from cometbft_tpu_torch.txingest.coalescer import (
    IngestCoalescer,
    ingest_enabled,
    ingest_active,
)
from cometbft_tpu_torch.txingest.envelope import (
    CODE_BAD_ENVELOPE,
    CODE_BAD_SIGNATURE,
    CODE_STALE_NONCE,
    CODESPACE,
    Envelope,
    EnvelopeError,
    decode,
    encode,
    is_envelope,
    sign_tx,
)
from cometbft_tpu_torch.txingest.middleware import SigVerifyingApp

__all__ = [
    "CODE_BAD_ENVELOPE",
    "CODE_BAD_SIGNATURE",
    "CODE_STALE_NONCE",
    "CODESPACE",
    "Envelope",
    "EnvelopeError",
    "IngestCoalescer",
    "SigVerifyingApp",
    "decode",
    "encode",
    "envelope",
    "ingest_active",
    "ingest_enabled",
    "is_envelope",
    "sign_tx",
    "stats",
]
