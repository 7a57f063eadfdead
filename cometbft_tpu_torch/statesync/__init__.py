from cometbft_tpu_torch.statesync.reactor import (
    CHUNK_CHANNEL,
    SNAPSHOT_CHANNEL,
    StatesyncReactor,
)
from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider
from cometbft_tpu_torch.statesync.syncer import Syncer

__all__ = [
    "StatesyncReactor",
    "Syncer",
    "LightClientStateProvider",
    "SNAPSHOT_CHANNEL",
    "CHUNK_CHANNEL",
]
