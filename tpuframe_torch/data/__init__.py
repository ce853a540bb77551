"""Data: datasets, the one-process DataLoader, its buffer pool and the
device prefetcher."""

from tpuframe_torch.data.datasets import (
    ArrayDataset,
    SyntheticImageDataset,
    Timer,
    hf_get_num_classes,
    hfds_download,
    item_rng,
    make_image_dataset,
)
from tpuframe_torch.data.loader import BatchBufferPool, DataLoader, DevicePrefetcher

__all__ = [
    "ArrayDataset",
    "BatchBufferPool",
    "DataLoader",
    "DevicePrefetcher",
    "SyntheticImageDataset",
    "Timer",
    "hf_get_num_classes",
    "hfds_download",
    "item_rng",
    "make_image_dataset",
]
