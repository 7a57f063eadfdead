from cometbft_tpu_torch.light.client import SEQUENTIAL, SKIPPING, LightClient
from cometbft_tpu_torch.light.provider import HTTPProvider, NodeProvider, Provider
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import (
    TrustOptions,
    verify,
    verify_adjacent,
    verify_non_adjacent,
)

__all__ = [
    "LightClient",
    "LightStore",
    "Provider",
    "HTTPProvider",
    "NodeProvider",
    "TrustOptions",
    "SEQUENTIAL",
    "SKIPPING",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
