"""Data: transforms, datasets, the DataLoader with its buffer pool and the
device prefetcher, and the streaming shard formats (TFS and MDS)."""

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
from tpuframe_torch.data.mds import MDSDataset, MDSWriter, mds_to_tfs
from tpuframe_torch.data.streaming import ShardWriter, StreamingDataset, clean_stale_cache
from tpuframe_torch.data.transforms import (
    CenterCrop,
    Compose,
    GrayscaleToRGB,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    Resize,
    ToFloat,
    default_image_transforms,
    uint8_image_transforms,
)

__all__ = [
    "ArrayDataset",
    "SyntheticImageDataset",
    "Timer",
    "hf_get_num_classes",
    "hfds_download",
    "make_image_dataset",
    "BatchBufferPool",
    "DataLoader",
    "DevicePrefetcher",
    "MDSDataset",
    "MDSWriter",
    "mds_to_tfs",
    "ShardWriter",
    "StreamingDataset",
    "clean_stale_cache",
    "Compose",
    "Resize",
    "RandomCrop",
    "CenterCrop",
    "RandomHorizontalFlip",
    "GrayscaleToRGB",
    "Normalize",
    "ToFloat",
    "default_image_transforms",
    "uint8_image_transforms",
]
