from cometbft_tpu_torch.evidence.pool import EvidencePool, EvidenceInvalidError

__all__ = ["EvidencePool", "EvidenceInvalidError"]
