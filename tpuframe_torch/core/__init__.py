"""Runtime: the device, the process group and the mesh."""

from tpuframe_torch.core.runtime import (
    Mesh,
    MeshSpec,
    Runtime,
    current_runtime,
    initialize,
    process_count,
    process_index,
    resolve_device,
    shutdown,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "Runtime",
    "current_runtime",
    "initialize",
    "process_count",
    "process_index",
    "resolve_device",
    "shutdown",
]
