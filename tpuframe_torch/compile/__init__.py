"""Batch-shape contract of the serve path."""

from tpuframe_torch.compile.precompile import ShapeGuard, batch_signature, format_signature

__all__ = ["ShapeGuard", "batch_signature", "format_signature"]
