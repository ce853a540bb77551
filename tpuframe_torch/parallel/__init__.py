"""Mixed-precision policy, the data-parallel plan and the compressed
gradient wire."""

from tpuframe_torch.parallel.comms_env import COMMS_ENV_VARS, CommsConfig
from tpuframe_torch.parallel.compression import (
    GradLayout,
    comms_template,
    grad_layout,
    init_comms_state,
    make_compressed_pmean,
    sync_gradients,
    wire_plan,
)
from tpuframe_torch.parallel.precision import (
    Policy,
    align_model_dtype,
    bf16_compute,
    full_precision,
    get_policy,
    pure_bf16,
)
from tpuframe_torch.parallel.sharding import ParallelPlan

__all__ = [
    "COMMS_ENV_VARS",
    "CommsConfig",
    "GradLayout",
    "ParallelPlan",
    "Policy",
    "align_model_dtype",
    "bf16_compute",
    "comms_template",
    "full_precision",
    "get_policy",
    "grad_layout",
    "init_comms_state",
    "make_compressed_pmean",
    "pure_bf16",
    "sync_gradients",
    "wire_plan",
]
