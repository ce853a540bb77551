"""Host-side image transforms (numpy, HWC), explicit-rng functional style.

The port's own copy of ``tpuframe/data/transforms.py`` (numpy, and PIL
where it imports): the same classes, the same draws from the same
``np.random.Generator``, so both packages augment an image alike, bit for
bit.  The reference's torchvision pipeline is resize -> random horizontal
flip -> to float -> grayscale->RGB -> ImageNet-stats normalize; here
arrays stay HWC uint8/float32 numpy and every transform takes an explicit
generator (``data.datasets.item_rng``), so workers reproduce by
construction.  ``Resize`` is PIL bilinear where PIL imports and numpy
nearest where it does not (:data:`RESIZE_BACKEND` says which).

On the card the float and normalize stages move into kernel K1:
``uint8_image_transforms`` keeps samples uint8, the loader ships bytes
(``DataLoader(transfer_dtype="uint8")``) and ``Trainer(normalize=(
IMAGENET_MEAN, IMAGENET_STD))`` normalizes them there.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

#: ImageNet statistics used throughout the reference.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def _to_array(img) -> np.ndarray:
    """Accept PIL images or arrays; return HWC (or HW) numpy."""
    arr = np.asarray(img)
    return arr


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, img, rng: np.random.Generator | None = None) -> np.ndarray:
        if rng is None:
            rng = np.random.default_rng()
        out = _to_array(img)
        for t in self.transforms:
            out = t(out, rng)
        return out

    def __repr__(self):
        return f"Compose({self.transforms!r})"


class Resize:
    """Resize to (size, size) — PIL bilinear when available, else numpy nearest."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        h, w = img.shape[:2]
        if (h, w) == (self.size, self.size):
            return img
        try:
            from PIL import Image

            if img.dtype == np.uint8:
                out = np.asarray(
                    Image.fromarray(img).resize((self.size, self.size), Image.BILINEAR)
                )
            else:
                # float images: PIL only supports single-channel 'F' mode, so
                # resize channel-by-channel without any dtype truncation.
                chans = img[:, :, None] if img.ndim == 2 else img
                out = np.stack(
                    [
                        np.asarray(
                            Image.fromarray(chans[:, :, c].astype(np.float32), "F")
                            .resize((self.size, self.size), Image.BILINEAR)
                        )
                        for c in range(chans.shape[-1])
                    ],
                    axis=-1,
                ).astype(img.dtype)
                if img.ndim == 2:
                    out = out[:, :, 0]
            return out
        except ImportError:
            ys = (np.arange(self.size) * h / self.size).astype(np.int64)
            xs = (np.arange(self.size) * w / self.size).astype(np.int64)
            return img[ys][:, xs]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.random() < self.p:
            return img[:, ::-1]
        return img


class RandomCrop:
    """Pad-then-crop (torchvision RandomCrop(size, padding) semantics)."""

    def __init__(self, size: int, padding: int = 0):
        self.size = int(size)
        self.padding = int(padding)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.padding:
            pad = [(self.padding, self.padding), (self.padding, self.padding)]
            if img.ndim == 3:
                pad.append((0, 0))
            img = np.pad(img, pad, mode="constant")
        h, w = img.shape[:2]
        top = int(rng.integers(0, h - self.size + 1))
        left = int(rng.integers(0, w - self.size + 1))
        return img[top : top + self.size, left : left + self.size]


class CenterCrop:
    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        h, w = img.shape[:2]
        top = max(0, (h - self.size) // 2)
        left = max(0, (w - self.size) // 2)
        return img[top : top + self.size, left : left + self.size]


class ToFloat:
    """uint8 [0,255] -> float32 [0,1]; ensures a channel dim exists."""

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        if img.ndim == 2:
            img = img[:, :, None]
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        return img.astype(np.float32)


class GrayscaleToRGB:
    """1-channel -> 3-channel by repeat (the reference's grayscale step)."""

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[-1] == 1:
            return np.repeat(img, 3, axis=-1)
        return img


class Normalize:
    def __init__(
        self,
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
    ):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        return (img.astype(np.float32) - self.mean) / self.std


def uint8_image_transforms(
    image_size: int,
    random_flip: bool = True,
    convert_rgb: bool = True,
) -> Compose:
    """Geometric-only pipeline that keeps samples uint8 end to end.

    The host half of the uint8-over-PCIe path: decode -> resize -> flip
    stay byte-sized, batches assemble into uint8 ring buffers
    (``DataLoader(transfer_dtype="uint8")`` — 4x less host->HBM traffic
    than f32), and the ``ToFloat``+``Normalize`` stages move on-device
    as the normalize kernel K1 (``tpuframe_torch.ops.normalize_images``,
    through ``Trainer(normalize=(IMAGENET_MEAN, IMAGENET_STD))``).
    """
    ts: list[Transform] = [Resize(image_size)]
    if random_flip:
        ts.append(RandomHorizontalFlip())
    if convert_rgb:
        ts.append(GrayscaleToRGB())
    return Compose(ts)


def default_image_transforms(
    image_size: int,
    normalize_transform: bool = True,
    convert_rgb: bool = True,
    random_flip: bool = True,
) -> Compose:
    """The reference's default pipeline: resize, flip, float, RGB, normalize."""
    ts: list[Transform] = [Resize(image_size)]
    if random_flip:
        ts.append(RandomHorizontalFlip())
    ts.append(ToFloat())
    if convert_rgb:
        ts.append(GrayscaleToRGB())
    if normalize_transform:
        ts.append(Normalize())
    return Compose(ts)
