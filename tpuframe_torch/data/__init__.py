"""Host batch buffers (the loader comes with the training slice)."""

from tpuframe_torch.data.loader import BatchBufferPool

__all__ = ["BatchBufferPool"]
