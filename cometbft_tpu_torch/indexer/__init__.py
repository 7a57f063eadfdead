from cometbft_tpu_torch.indexer.kv import KVBlockIndexer, KVTxIndexer, TxResult
from cometbft_tpu_torch.indexer.service import IndexerService

__all__ = ["KVTxIndexer", "KVBlockIndexer", "TxResult", "IndexerService"]
