"""Train state: everything a step updates, in torch idiom.

Port of ``tpuframe/train/state.py``.  The JAX state is one immutable pytree
(params, opt_state, batch_stats, step, rng) that each step replaces; here
the same parts are an ``nn.Module`` (parameters and BatchNorm buffers),
a ``torch.optim.Optimizer`` with its :class:`OptimizerSpec` (LR schedule,
global-norm clip), the step count, the health sentinel's device scalars and
a ``torch.Generator``, and a step updates them in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tpuframe_torch.fault.health import init_health_state
from tpuframe_torch.train.optim import OptimizerSpec, clip_by_global_norm_

__all__ = ["TrainState", "create_train_state"]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the step counters.

    ``step`` counts train steps taken (skipped ones included, as the JAX
    ``state.step`` does); the LR schedule is read at it before each update.
    ``health`` is the sentinel's state (``fault.health.init_health_state``).
    ``generator`` seeds the step's randomness (dropout-style layers).
    """

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    health: dict
    generator: torch.Generator

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in ``.grad``: the global-norm clip
        when the spec has one, ``lr = schedule(step)``, ``optimizer.step()``,
        then ``step += 1``."""
        if self.spec.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                 self.spec.max_grad_norm)
        lr = self.spec.lr_at(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: nn.Module, spec: OptimizerSpec, *, seed: int = 0) -> TrainState:
    """A :class:`TrainState` over an initialized ``model`` (torch modules
    arrive initialized; ``models.from_jax_variables`` carries JAX weights
    in), with the optimizer built by ``spec`` over its parameters."""
    device = next(model.parameters()).device
    return TrainState(
        step=0,
        model=model,
        optimizer=spec.build(model.parameters()),
        spec=spec,
        health=init_health_state(device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )

