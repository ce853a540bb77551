"""Mixed-precision policy, the data-parallel and ZeRO plans, the memory
estimator and the compressed gradient wire."""

from tpuframe_torch.parallel.comms_env import COMMS_ENV_VARS, CommsConfig
from tpuframe_torch.parallel.compression import (
    GradLayout,
    comms_template,
    grad_layout,
    init_comms_state,
    make_compressed_pmean,
    quantized_pmean,
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
from tpuframe_torch.parallel.memory import plan_memory, suggest_fit
from tpuframe_torch.parallel.sharding import (
    ParallelPlan,
    flax_orders,
    infer_shard_dim,
    mesh_axes,
    path_str,
)
from tpuframe_torch.parallel.zero import (
    ZeroConfig,
    host_offload_sharding,
    supports_host_offload,
    zero_0,
    zero_1,
    zero_2,
    zero_3,
    zero_3_offload,
)

__all__ = [
    "COMMS_ENV_VARS",
    "CommsConfig",
    "GradLayout",
    "ParallelPlan",
    "Policy",
    "ZeroConfig",
    "align_model_dtype",
    "bf16_compute",
    "comms_template",
    "flax_orders",
    "full_precision",
    "get_policy",
    "grad_layout",
    "host_offload_sharding",
    "infer_shard_dim",
    "init_comms_state",
    "make_compressed_pmean",
    "mesh_axes",
    "path_str",
    "plan_memory",
    "pure_bf16",
    "quantized_pmean",
    "suggest_fit",
    "supports_host_offload",
    "sync_gradients",
    "wire_plan",
    "zero_0",
    "zero_1",
    "zero_2",
    "zero_3",
    "zero_3_offload",
]
