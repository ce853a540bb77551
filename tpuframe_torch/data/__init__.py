"""Data: datasets, the one-process DataLoader, its buffer pool and the
device prefetcher."""

from tpuframe_torch.data.datasets import ArrayDataset, SyntheticImageDataset, item_rng
from tpuframe_torch.data.loader import BatchBufferPool, DataLoader, DevicePrefetcher

__all__ = [
    "ArrayDataset",
    "BatchBufferPool",
    "DataLoader",
    "DevicePrefetcher",
    "SyntheticImageDataset",
    "item_rng",
]
