"""Map-style datasets: in-memory arrays and deterministic synthetic images.

The port's own copy of ``tpuframe/data/datasets.py`` (numpy only):
``item_rng``, ``ArrayDataset`` and ``SyntheticImageDataset``, so both
packages draw the same samples from the same seed, and the HF-dataset
helpers ``make_image_dataset``, ``hfds_download`` (``datasets`` is imported
only when it is called) and ``hf_get_num_classes``, and ``Timer``.
"""

from __future__ import annotations

import timeit
from typing import Any, Callable, Sequence

import numpy as np

__all__ = [
    "ArrayDataset",
    "SyntheticImageDataset",
    "Timer",
    "hf_get_num_classes",
    "hfds_download",
    "item_rng",
    "make_image_dataset",
]


def item_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """Per-item augmentation RNG: deterministic in (seed, epoch, idx) so runs
    reproduce exactly and every epoch re-randomizes.  One formula shared by
    every dataset class — augmentation randomness must not change when a
    pipeline switches dataset implementations."""
    return np.random.default_rng((seed * 1_000_003 + epoch) * 1_000_003 + idx)


class ArrayDataset:
    """In-memory (images, labels) with optional per-item transform.

    ``rng_seed`` makes augmentation deterministic per (seed, index, epoch);
    call :meth:`set_epoch` to reshuffle augmentation randomness each epoch.
    """

    def __init__(
        self,
        images: Sequence[Any],
        labels: Sequence[int],
        transform: Callable | None = None,
        rng_seed: int = 0,
    ):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images vs {len(labels)} labels")
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.transform = transform
        self.rng_seed = rng_seed
        self.epoch = 0
        self.num_classes = len(set(int(l) for l in labels))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        image = self.images[idx]
        if self.transform is not None:
            image = self.transform(image, item_rng(self.rng_seed, self.epoch, idx))
        return np.asarray(image), int(self.labels[idx])


def make_image_dataset(
    data: Any,
    image_key: str = "img",
    label_key: str = "label",
    transform: Callable | None = None,
) -> ArrayDataset:
    """An :class:`ArrayDataset` over a dict-like split (an HF dataset split
    or a dict) of images and labels."""
    return ArrayDataset(data[image_key], data[label_key], transform=transform)


def hfds_download(
    dataset_path: str,
    cache_dir: str,
    trust_remote_code: bool = False,
    **kwargs: Any,
):
    """An HF dataset dict loaded into ``cache_dir`` by ``datasets.load_dataset``.

    Without network egress this succeeds only for a dataset already in the
    cache; the error says so instead of timing out."""
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise ImportError("the 'datasets' package is required for HF ingest") from e
    try:
        return load_dataset(
            path=dataset_path,
            cache_dir=cache_dir,
            trust_remote_code=trust_remote_code,
            **kwargs,
        )
    except Exception as e:  # depends on the network and the cache
        raise RuntimeError(
            f"could not load HF dataset {dataset_path!r} from cache {cache_dir!r}; "
            "if this host has no network egress, pre-populate the cache or use "
            "tpuframe_torch.data.SyntheticImageDataset"
        ) from e


def hf_get_num_classes(dataset: Any, split_key: str, label_key: str = "label") -> int:
    """The number of distinct labels in ``dataset[split_key][label_key]``."""
    return len(set(dataset[split_key][label_key]))


class SyntheticImageDataset:
    """Deterministic synthetic image classification data (for tests/bench).

    Images are generated on-the-fly from the index (no memory footprint);
    labels are derived from the index so accuracy above chance is learnable
    (class-conditional mean shift).
    """

    def __init__(
        self,
        n: int = 1024,
        image_size: int = 32,
        channels: int = 3,
        num_classes: int = 10,
        seed: int = 0,
        transform: Callable | None = None,
    ):
        self.n = n
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.seed = seed
        self.transform = transform
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        label = idx % self.num_classes
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        img = rng.integers(
            0, 256, (self.image_size, self.image_size, self.channels), dtype=np.uint8
        )
        # class-conditional brightness shift makes the task learnable
        img = np.clip(img.astype(np.int32) + label * 8, 0, 255).astype(np.uint8)
        if self.transform is not None:
            img = self.transform(img, item_rng(self.seed, self.epoch, idx))
        return np.asarray(img), label


class Timer:
    """Wall-clock timer: started when made, :meth:`stop` gives the seconds."""

    def __init__(self):
        self.start = timeit.default_timer()

    def stop(self) -> float:
        self.end = timeit.default_timer()
        return self.end - self.start
