"""Ops with a hand-written Hopper kernel beside a plain PyTorch version."""

from tpuframe_torch.ops.cross_entropy import (
    cross_entropy_bwd,
    cross_entropy_bwd_reference,
    cross_entropy_fwd,
    cross_entropy_reference,
    fused_cross_entropy,
)
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference

__all__ = [
    "cross_entropy_bwd",
    "cross_entropy_bwd_reference",
    "cross_entropy_fwd",
    "cross_entropy_reference",
    "fused_cross_entropy",
    "normalize_images",
    "normalize_images_reference",
    "use_kernel",
]
