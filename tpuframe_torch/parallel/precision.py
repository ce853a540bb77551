"""Mixed-precision policy: float32 master params, bf16 compute, f32 outputs.

Port of ``tpuframe/parallel/precision.py`` with torch dtypes.  Parameters
stay in ``param_dtype`` between calls; a step casts them and the batch to
``compute_dtype`` and its outputs to ``output_dtype``.  Integer and bool
tensors pass through every cast untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "Policy",
    "align_model_dtype",
    "bf16_compute",
    "full_precision",
    "get_policy",
    "pure_bf16",
]


def _cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast floating tensors in a tensor, dict, list or tuple to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype assignment for the three tensor populations of a step.

    - ``param_dtype``: master copies held between steps.
    - ``compute_dtype``: what the forward runs in.
    - ``output_dtype``: logits, losses and metrics.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_params_for_compute(self, params: Any) -> Any:
        return _cast_floating(params, self.compute_dtype)

    def cast_batch(self, batch: Any) -> Any:
        return _cast_floating(batch, self.compute_dtype)

    def cast_outputs(self, outputs: Any) -> Any:
        return _cast_floating(outputs, self.output_dtype)

    def cast_to_param(self, tree: Any) -> Any:
        return _cast_floating(tree, self.param_dtype)


def align_model_dtype(model: Any, policy: Policy) -> Any:
    """Set the model's compute dtype to the policy's, in place.

    A bf16 policy over a model left at float32 would cast its bf16
    parameters back up inside every layer and run the whole graph in f32.
    Models without a ``set_compute_dtype`` method pass through untouched.
    Returns the model.
    """
    setter = getattr(model, "set_compute_dtype", None)
    if setter is not None:
        setter(policy.compute_dtype)
    return model


def full_precision() -> Policy:
    return Policy()


def bf16_compute() -> Policy:
    """f32 master params, bf16 compute, f32 outputs."""
    return Policy(compute_dtype=torch.bfloat16)


def pure_bf16() -> Policy:
    """Everything bf16 except the outputs."""
    return Policy(
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        output_dtype=torch.float32,
    )


_NAMED = {
    "fp32": full_precision,
    "float32": full_precision,
    "bf16": bf16_compute,
    "bfloat16": bf16_compute,
    "pure_bf16": pure_bf16,
}


def get_policy(name: str | Policy) -> Policy:
    """Resolve a policy by name (config-file friendly)."""
    if isinstance(name, Policy):
        return name
    try:
        return _NAMED[name]()
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; known: {sorted(_NAMED)}"
        ) from None
