"""Datasets (counterpart of ``d9d_tpu/dataset``)."""

from d9d_tpu_torch.dataset.padding import (
    PaddingSide1D,
    TokenPoolingType,
    pad_stack_1d,
    token_pooling_mask_from_attention_mask,
)
from d9d_tpu_torch.dataset.sharded import (
    BufferSortedDataset,
    Dataset,
    DatasetImplementingSortKeyProtocol,
    ShardIndexingMode,
    ShardedDataset,
    shard_dataset_data_parallel,
)

__all__ = [
    "BufferSortedDataset",
    "Dataset",
    "DatasetImplementingSortKeyProtocol",
    "PaddingSide1D",
    "ShardIndexingMode",
    "ShardedDataset",
    "TokenPoolingType",
    "pad_stack_1d",
    "shard_dataset_data_parallel",
    "token_pooling_mask_from_attention_mask",
]
