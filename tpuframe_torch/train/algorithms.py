"""Trainer algorithms: batch/label transforms applied at defined events.

The port's own copy of ``tpuframe/train/algorithms.py`` (numpy only).

Capability parity with the Composer example's algorithm list
(`03_composer/01_cifar_composer_resnet.ipynb:cell-16`:
``algorithms=[LabelSmoothing(0.1), CutMix(1.0), ChannelsLast()]``), designed
TPU-first: algorithms are *pure functions on host batches* (numpy, before
the copy to the device) so the train step sees the same shapes with or
without any algorithm stack.

Label-space algorithms (LabelSmoothing, CutMix, MixUp) emit soft labels
(N, C); the step's ``cross_entropy`` handles both hard and soft labels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Algorithm:
    """Base: transform (images, labels) before the device step."""

    def needs_num_classes(self) -> bool:
        return False

    def apply(
        self, images: np.ndarray, labels: np.ndarray, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        return images, labels


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    if labels.ndim == 2:
        return labels
    out = np.zeros((labels.shape[0], num_classes), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


@dataclasses.dataclass
class LabelSmoothing(Algorithm):
    """Uniform label smoothing (Composer ``LabelSmoothing(smoothing=0.1)``)."""

    smoothing: float = 0.1
    num_classes: int | None = None

    def needs_num_classes(self) -> bool:
        return True

    def apply(self, images, labels, rng):
        y = _one_hot(labels, self.num_classes)
        y = y * (1.0 - self.smoothing) + self.smoothing / y.shape[1]
        return images, y.astype(np.float32)


@dataclasses.dataclass
class CutMix(Algorithm):
    """CutMix: paste a random crop from a shuffled partner image; labels mix
    by pasted area (Composer ``CutMix(alpha=1.0)``)."""

    alpha: float = 1.0
    num_classes: int | None = None

    def needs_num_classes(self) -> bool:
        return True

    def apply(self, images, labels, rng):
        n, h, w = images.shape[:3]
        lam = float(rng.beta(self.alpha, self.alpha))
        perm = rng.permutation(n)
        cut = np.sqrt(1.0 - lam)
        ch, cw = int(h * cut), int(w * cut)
        cy, cx = int(rng.integers(h)), int(rng.integers(w))
        y0, y1 = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
        x0, x1 = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
        mixed = images.copy()
        mixed[:, y0:y1, x0:x1] = images[perm, y0:y1, x0:x1]
        area = (y1 - y0) * (x1 - x0) / (h * w)
        y = _one_hot(labels, self.num_classes)
        y = (1.0 - area) * y + area * y[perm]
        return mixed, y.astype(np.float32)


@dataclasses.dataclass
class MixUp(Algorithm):
    """Convex image/label mixing with a shuffled partner (mixup paper)."""

    alpha: float = 0.2
    num_classes: int | None = None

    def needs_num_classes(self) -> bool:
        return True

    def apply(self, images, labels, rng):
        lam = float(rng.beta(self.alpha, self.alpha))
        perm = rng.permutation(images.shape[0])
        imgs = images.astype(np.float32)
        mixed = lam * imgs + (1.0 - lam) * imgs[perm]
        y = _one_hot(labels, self.num_classes)
        y = lam * y + (1.0 - lam) * y[perm]
        return mixed.astype(images.dtype if images.dtype == np.float32 else np.float32), y.astype(np.float32)


@dataclasses.dataclass
class ChannelsLast(Algorithm):
    """No-op: the port's ResNet keeps its activations and parameters in
    ``channels_last`` already (the memory-format win Composer's
    ChannelsLast buys on CUDA is the default here)."""


def resolve_algorithms(
    algorithms: Sequence[Algorithm], num_classes: int
) -> list[Algorithm]:
    """Fill in num_classes on algorithms that need it but weren't told."""
    out = []
    for alg in algorithms:
        if alg.needs_num_classes() and getattr(alg, "num_classes", None) is None:
            alg = dataclasses.replace(alg, num_classes=num_classes)
        out.append(alg)
    return out


def apply_algorithms(
    algorithms: Sequence[Algorithm],
    images: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    for alg in algorithms:
        images, labels = alg.apply(images, labels, rng)
    return images, labels
