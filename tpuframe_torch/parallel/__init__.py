"""Mixed-precision policy (the mesh and data parallelism come with the DP slice)."""

from tpuframe_torch.parallel.precision import (
    Policy,
    align_model_dtype,
    bf16_compute,
    full_precision,
    get_policy,
    pure_bf16,
)

__all__ = [
    "Policy",
    "align_model_dtype",
    "bf16_compute",
    "full_precision",
    "get_policy",
    "pure_bf16",
]
