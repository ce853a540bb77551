"""Inference step: the port of ``make_predict_fn`` from ``tpuframe/train/step.py``.

The train and eval steps come with the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from tpuframe_torch.parallel.precision import Policy, full_precision

__all__ = ["make_predict_fn"]


def make_predict_fn(
    policy: Policy | None = None,
    input_transform: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """Logits function for inference: ``predict(model, x)``.

    The casts are the JAX step's: ``input_transform`` (the fused normalize
    on the serve path) runs first, the model's parameters are cast to the
    compute dtype while its buffers (BatchNorm running statistics) stay as
    they are, the batch is cast to the compute dtype, and the logits to the
    output dtype.  Runs under ``torch.inference_mode``; the parameters are
    cast on every call, as the JAX step casts them.
    """
    policy = policy or full_precision()

    @torch.inference_mode()
    def predict(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if input_transform is not None:
            x = input_transform(x)
        params = policy.cast_params_for_compute(
            {n: p.detach() for n, p in model.named_parameters()})
        state = {**params, **dict(model.named_buffers())}
        logits = functional_call(model, state, (policy.cast_batch(x),))
        return policy.cast_outputs(logits)

    return predict
