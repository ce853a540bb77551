"""Mixed-precision policy, the data-parallel, ZeRO, tensor-parallel and
pipeline plans and their composition, the memory estimator and the
compressed gradient wire."""

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
from tpuframe_torch.parallel.pipeline import (
    PP_SCHEDULES,
    PipelinedTransformerLM,
    gpipe_spmd,
    pipeline_param_spec,
    stack_stage_params,
)
from tpuframe_torch.parallel.sharding import (
    ParallelPlan,
    Rule,
    flax_orders,
    infer_shard_dim,
    mesh_axes,
    path_str,
    spec_from_json,
    spec_to_json,
)
from tpuframe_torch.parallel.compose import compose, default_tp_rules, pipeline_rules  # noqa: E402
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
    "PP_SCHEDULES",
    "ParallelPlan",
    "PipelinedTransformerLM",
    "Policy",
    "Rule",
    "ZeroConfig",
    "align_model_dtype",
    "bf16_compute",
    "comms_template",
    "compose",
    "default_tp_rules",
    "flax_orders",
    "full_precision",
    "get_policy",
    "gpipe_spmd",
    "grad_layout",
    "host_offload_sharding",
    "infer_shard_dim",
    "init_comms_state",
    "make_compressed_pmean",
    "mesh_axes",
    "path_str",
    "pipeline_param_spec",
    "pipeline_rules",
    "plan_memory",
    "pure_bf16",
    "quantized_pmean",
    "spec_from_json",
    "spec_to_json",
    "stack_stage_params",
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
