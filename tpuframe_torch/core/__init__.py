"""Core: configuration, the workspace layout, and the runtime (the
device, the process group and the mesh)."""

from tpuframe_torch.core.config import AUTO, Config, load_config
from tpuframe_torch.core.runtime import (
    AXIS_ORDER,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    Mesh,
    MeshSpec,
    Runtime,
    current_runtime,
    initialize,
    is_main_process,
    process_count,
    process_index,
    reset_runtime,
    resolve_device,
    shutdown,
    simulate_cpu_devices,
)
from tpuframe_torch.core.workspace import Workspace, export_worker_env

__all__ = [
    "AUTO",
    "AXIS_ORDER",
    "Config",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshSpec",
    "PIPELINE_AXIS",
    "Runtime",
    "SEQUENCE_AXIS",
    "Workspace",
    "current_runtime",
    "export_worker_env",
    "initialize",
    "is_main_process",
    "load_config",
    "process_count",
    "process_index",
    "reset_runtime",
    "resolve_device",
    "shutdown",
    "simulate_cpu_devices",
]
