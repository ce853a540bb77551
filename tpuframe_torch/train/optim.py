"""Optimizers: the Trainer's named table and DeepSpeed-shaped config dicts.

Port of ``tpuframe/train/optim.py`` and of the Trainer's ``_make_optimizer``
(``tpuframe/train/trainer.py:1639-1654``).  An optax chain holds the
global-norm clip, the optimizer and its LR schedule in one object; torch
keeps the clip and the schedule outside ``torch.optim``, so the port's
recipe is an :class:`OptimizerSpec`: a factory of the ``torch.optim``
optimizer, the learning rate (a float or a schedule of the step) and the
clip.  ``create_train_state`` builds the optimizer from it; the train step
clips, sets the LR and steps (``TrainState.apply_gradients``).

Every hyperparameter is passed to torch explicitly, never left to a
library default:

- ``optax.sgd(lr, momentum=m)`` is ``torch.optim.SGD(momentum=m,
  dampening=0, nesterov=False)``.
- ``optax.adam`` is ``Adam(betas=(0.9, 0.999), eps=1e-8)``.
- The Trainer's named ``"adamw"`` is ``optax.adamw`` with its default
  weight decay 1e-4; the config path defaults to 1e-2 (``optim.py:34``).
  torch's ``AdamW`` defaults to 1e-2, so both are passed.
- ``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm > max_norm``; :func:`clip_by_global_norm_` ports that formula
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``).

The optimizer state is created when the optimizer is (zero momentum and
moments, a zero step count), as optax's ``init`` creates it, so a step
that the health sentinel skips can restore it like any other tensor.
``lion``, ``lamb`` and ``adafactor`` have no torch counterpart with optax's
semantics and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from tpuframe_torch.train.schedules import Schedule
from tpuframe_torch.train.schedules import from_config as schedule_from_config

__all__ = [
    "OptimizerSpec",
    "clip_by_global_norm_",
    "init_optimizer_state",
    "make_optimizer",
    "optimizer_from_config",
]

_LATER = ("{name!r} has no torch.optim counterpart with optax's semantics; it is "
          "queued in ROADMAP.md, Queue 1, slice 2 ('lion/lamb/adafactor')")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """How to build and drive one optimizer.

    ``factory(params)`` builds the ``torch.optim.Optimizer``; ``lr`` is a
    float or a schedule ``count -> lr`` read at the count of applied
    updates before each one (``TrainState.apply_gradients``);
    ``max_grad_norm`` (None = no clip) is optax's global-norm clip."""

    factory: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
    lr: float | Schedule
    max_grad_norm: float | None = None

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        opt = self.factory(list(params))
        init_optimizer_state(opt)
        return opt


def _sgd(lr0: float, momentum: float):
    def factory(params):
        # on the card the fused step takes a scheduled lr as a device scalar;
        # the foreach step would read it back to the host every step
        fused = bool(params) and all(p.is_cuda for p in params)
        return torch.optim.SGD(params, lr=lr0, momentum=momentum, dampening=0.0,
                               nesterov=False, weight_decay=0.0, fused=fused)
    return factory


def _adam(lr0: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float | None = None):
    def factory(params):
        cuda = any(p.is_cuda for p in params)
        # capturable keeps the step count on the card, so a skipped step
        # restores it there without a host sync, and takes a scheduled lr
        # as a device scalar
        kw = dict(lr=lr0, betas=tuple(float(b) for b in betas), eps=float(eps), capturable=cuda)
        if weight_decay is None:
            return torch.optim.Adam(params, weight_decay=0.0, **kw)
        return torch.optim.AdamW(params, weight_decay=float(weight_decay), **kw)
    return factory


@torch.no_grad()
def init_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Create the state torch would create on the first ``step()``: SGD's
    momentum buffers, Adam's step count and moments (all zeros)."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            if isinstance(opt, torch.optim.SGD):
                if group["momentum"]:
                    state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
                dev = p.device if group["capturable"] else "cpu"
                state["step"] = torch.zeros((), dtype=torch.float32, device=dev)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``, else
    leave it.  Returns the global norm (a device scalar, no host sync)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.stack([n.float() for n in torch._foreach_norm(grads)]).square().sum().sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def make_optimizer(name: str, lr: float | Schedule,
                   max_grad_norm: float | None = None) -> OptimizerSpec:
    """The Trainer's named optimizers (``optimizer="sgd"`` etc.), with the
    JAX Trainer's hyperparameters."""
    lr0 = float(lr(0)) if callable(lr) else float(lr)
    table = {
        "adam": lambda: _adam(lr0),
        "adamw": lambda: _adam(lr0, weight_decay=1e-4),  # optax.adamw's default
        "sgd": lambda: _sgd(lr0, 0.9),
    }
    key = name.lower()
    if key in ("lamb", "lion", "adafactor"):
        raise NotImplementedError(_LATER.format(name=name))
    try:
        factory = table[key]()
    except KeyError:
        raise ValueError(
            f"unknown optimizer {name!r}; known: "
            f"{sorted(table) + ['adafactor', 'lamb', 'lion']}") from None
    return OptimizerSpec(factory, lr, max_grad_norm)


def optimizer_from_config(cfg: Mapping[str, Any], *,
                          total_steps: int | None = None) -> OptimizerSpec:
    """One :class:`OptimizerSpec` from a DeepSpeed-shaped config: its
    ``optimizer`` block, ``scheduler`` (optional; its schedule replaces the
    static lr) and ``gradient_clipping`` (optional, global norm).  ``lr:
    "auto"`` with no scheduler is an error."""
    opt_block = cfg.get("optimizer", {})
    kind = str(opt_block.get("type", "AdamW"))
    k = kind.lower()
    if k in ("lamb", "lion", "adafactor"):
        raise NotImplementedError(_LATER.format(name=kind))
    if k not in ("adamw", "adam", "sgd"):
        raise ValueError(
            f"unknown optimizer type {kind!r}; known: "
            "['adafactor', 'adam', 'adamw', 'lamb', 'lion', 'sgd']")
    p = dict(opt_block.get("params", {}))
    if "scheduler" in cfg:
        lr: float | Schedule = schedule_from_config(cfg, total_steps=total_steps)
    else:
        lr = p.get("lr")
        if lr in (None, "auto"):
            raise ValueError(
                "config has no scheduler and optimizer.params.lr is "
                f"{lr!r}; set an explicit lr or add a scheduler block")
        lr = float(lr)
    lr0 = float(lr(0)) if callable(lr) else float(lr)
    if k == "sgd":
        factory = _sgd(lr0, float(p.get("momentum", 0.0)))
    else:
        betas = p.get("betas", (0.9, 0.999))
        wd = float(p.get("weight_decay", 1e-2)) if k == "adamw" else None
        factory = _adam(lr0, betas, float(p.get("eps", 1e-8)), wd)
    clip = cfg.get("gradient_clipping")
    max_norm = None if clip in (None, "auto", 0, 0.0) else float(clip)
    return OptimizerSpec(factory, lr, max_norm)
