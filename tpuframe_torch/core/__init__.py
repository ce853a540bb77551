"""Runtime: the device every entry point resolves."""

from tpuframe_torch.core.runtime import Runtime, initialize, resolve_device

__all__ = ["Runtime", "initialize", "resolve_device"]
