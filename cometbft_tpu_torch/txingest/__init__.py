"""Batched transaction ingestion: only ``stats``, the process-wide
counters the mempool keeps, is ported so far; the envelopes, the
``SigVerifyingApp`` middleware and the ingest coalescer wait for ROADMAP
"Node assembly" stage (c)."""

from cometbft_tpu_torch.txingest import stats

__all__ = ["stats"]
