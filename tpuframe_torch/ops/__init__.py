"""Ops with a hand-written Hopper kernel beside a plain PyTorch version."""

from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference

__all__ = ["normalize_images", "normalize_images_reference", "use_kernel"]
