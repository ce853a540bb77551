"""Exponential moving average of the parameters (Composer's and timm's EMA).

Port of ``tpuframe/train/ema.py``.  The JAX package keeps the average in
the optimizer state (an :class:`EmaState` around the inner ``opt_state``),
updated in the same jitted step.  The port keeps it beside the optimizer,
in ``TrainState.ema``: :func:`with_ema` marks an ``OptimizerSpec``,
``create_train_state`` makes the :class:`EmaState`, and
``TrainState.apply_gradients`` folds the post-update parameters in right
after ``optimizer.step()`` (under ``ops.fused_adamw`` those are the ones
K4 wrote in that step).  A step the health sentinel skips restores the
average with the rest of the state, and ``TrainState.state_dict`` holds it
(under ``"ema"``), so a checkpoint resume keeps it.

Usage::

    spec = with_ema(make_optimizer("adamw", 3e-4), decay=0.999)
    state = create_train_state(model, spec)
    ...
    averaged = ema_params(state)          # {name: tensor}

or ``Trainer(ema_decay=0.999)``, which evaluates, predicts and exports
with the averaged weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

__all__ = ["EmaState", "ema_params", "update_ema_", "with_ema"]


class EmaState(NamedTuple):
    """The average, by parameter name, and its decay.  (JAX's holds the
    inner ``opt_state`` too; the port's optimizer stays in
    ``TrainState.optimizer``.)"""

    ema: dict
    decay: float


def with_ema(spec: Any, decay: float = 0.999) -> Any:
    """``spec`` (an ``OptimizerSpec``) whose train state also tracks
    ``ema = d * ema + (1 - d) * params``.

    The average starts at the initial parameters (no zero init, so no
    debiasing), and each update folds the post-update parameters in: it
    lags the live weights by the usual horizon of ``1 / (1 - decay)``
    steps.  ``decay`` outside (0, 1) raises ``ValueError``."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    return dataclasses.replace(spec, ema_decay=float(decay))


def init_ema(named_params: dict, decay: float) -> EmaState:
    """The average at the initial parameters: a copy of each one."""
    return EmaState({n: p.detach().clone() for n, p in named_params.items()}, float(decay))


@torch.no_grad()
def update_ema_(ema: EmaState, named_params: dict) -> None:
    """``ema <- decay * ema + (1 - decay) * params`` in place, in JAX's
    order of operations."""
    names = list(ema.ema)
    avg = [ema.ema[n] for n in names]
    live = [named_params[n].detach() for n in names]
    torch._foreach_mul_(avg, ema.decay)
    torch._foreach_add_(avg, torch._foreach_mul(live, 1.0 - ema.decay))


def ema_params(state_or_ema: Any) -> dict:
    """The averaged parameters, by name, from a ``TrainState`` (or its
    :class:`EmaState`).

    Raises ``ValueError`` when the state has no average: returning the
    live parameters would make an "EMA eval" a lie."""
    ema = (state_or_ema if isinstance(state_or_ema, EmaState)
           else getattr(state_or_ema, "ema", None))
    if isinstance(ema, EmaState):
        return ema.ema
    raise ValueError(
        "optimizer state carries no EMA — wrap the optimizer with "
        "with_ema(spec) or pass Trainer(ema_decay=...)")
