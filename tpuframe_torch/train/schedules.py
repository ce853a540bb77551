"""LR schedules: the reference examples' schedulers as plain functions of
the step.

Port of ``tpuframe/train/schedules.py``.  Each schedule is ``step -> lr``
(a Python float), with the JAX package's formulas: DeepSpeed ``WarmupLR``
and ``WarmupDecayLR``, torch ``CosineAnnealingLR`` (holding ``eta_min``
past ``t_max``), ``StepLR``-style staircase decay, and linear warmup into
cosine decay (optax's ``warmup_cosine_decay_schedule``).

An optax schedule is read at the update count before its increment, so the
port's train step sets each param group's ``lr = schedule(count)`` before
``optimizer.step()``, with ``count`` the number of updates applied so far
(a step the health sentinel skips applies none; ``train.state``).

``from_config`` accepts the DeepSpeed-shaped ``{"type": ..., "params":
{...}}`` dict; ``"auto"`` values resolve against ``total_steps``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

__all__ = [
    "cosine_annealing",
    "from_config",
    "resolve_schedule",
    "step_decay",
    "warmup_cosine",
    "warmup_decay_lr",
    "warmup_lr",
]

Schedule = Callable[[int], float]


def _clip(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


def warmup_lr(max_lr: float, warmup_steps: int, *, min_lr: float = 0.0,
              warmup_type: str = "linear") -> Schedule:
    """DeepSpeed ``WarmupLR``: ramp to ``max_lr``, then hold.

    ``warmup_type="log"`` ramps by ``log(step + 1) / log(warmup_steps)``
    (denominator at least ``log 2``); ``warmup_steps=0`` is a constant
    ``max_lr`` (:func:`from_config` clamps DeepSpeed's ``>= 2``)."""
    if warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")
    if warmup_type not in ("linear", "log"):
        raise ValueError(f"warmup_type must be 'linear' or 'log', got {warmup_type!r}")
    if warmup_steps == 0:
        return lambda step: float(max_lr)
    log_denom = math.log(max(2, warmup_steps))

    def schedule(step: int) -> float:
        s = float(step)
        frac = math.log1p(s) / log_denom if warmup_type == "log" else s / warmup_steps
        return min_lr + (max_lr - min_lr) * _clip(frac, 0.0, 1.0)

    return schedule


def warmup_decay_lr(max_lr: float, warmup_steps: int, total_steps: int, *,
                    min_lr: float = 0.0) -> Schedule:
    """DeepSpeed ``WarmupDecayLR``: linear warmup, then linear decay back to
    the ``min_lr`` floor at ``total_steps``."""
    if total_steps <= warmup_steps:
        raise ValueError(
            f"total_steps ({total_steps}) must exceed warmup_steps ({warmup_steps})")
    ramp = warmup_lr(max_lr, warmup_steps, min_lr=min_lr)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return ramp(step)
        decay = _clip((total_steps - step) / (total_steps - warmup_steps), 0.0, 1.0)
        return min_lr + (max_lr - min_lr) * decay

    return schedule


def cosine_annealing(base_lr: float, t_max: int, *, eta_min: float = 0.0) -> Schedule:
    """torch ``CosineAnnealingLR`` from ``base_lr`` to ``eta_min`` over
    ``t_max`` steps, holding ``eta_min`` after."""
    if t_max <= 0:
        raise ValueError(f"t_max must be > 0, got {t_max}")

    def schedule(step: int) -> float:
        t = _clip(float(step), 0.0, float(t_max))
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t / t_max))

    return schedule


def step_decay(base_lr: float, step_size: int, *, gamma: float = 0.1) -> Schedule:
    """torch ``StepLR``: multiply by ``gamma`` every ``step_size`` steps
    (optax ``exponential_decay(staircase=True)``)."""
    if step_size <= 0 or gamma == 0:
        return lambda step: float(base_lr)

    def schedule(step: int) -> float:
        if step <= 0:
            return float(base_lr)
        return base_lr * gamma ** math.floor(step / step_size)

    return schedule


def warmup_cosine(max_lr: float, warmup_steps: int, total_steps: int, *,
                  end_lr: float = 0.0, init_lr: float = 0.0) -> Schedule:
    """Linear warmup from ``init_lr`` to ``max_lr`` over ``warmup_steps``,
    then cosine decay to ``end_lr`` at ``total_steps`` (optax's
    ``warmup_cosine_decay_schedule``)."""
    decay_steps = total_steps - warmup_steps
    if not decay_steps > 0:
        raise ValueError(
            f"the cosine decay needs total_steps > warmup_steps, got {total_steps} "
            f"and {warmup_steps}")
    alpha = 0.0 if max_lr == 0.0 else end_lr / max_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            count = _clip(float(step), 0.0, float(warmup_steps))
            return (init_lr - max_lr) * (1 - count / warmup_steps) + max_lr
        count = min(float(step - warmup_steps), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return max_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def _resolve_auto(value: Any, name: str, fallback: int | None) -> int:
    """DeepSpeed-style ``"auto"`` resolution against a caller-known total."""
    if value in ("auto", None):
        if fallback is None:
            raise ValueError(
                f"scheduler param {name!r} is 'auto' but no total_steps was "
                "supplied to resolve it (pass total_steps=, or set the param "
                "explicitly)")
        return int(fallback)
    return int(value)


def from_config(cfg: Mapping[str, Any], *, total_steps: int | None = None) -> Schedule:
    """A schedule from a DeepSpeed-shaped scheduler dict: the full config
    (its ``"scheduler"`` key) or the block ``{"type": ..., "params":
    {...}}`` itself."""
    sched = cfg.get("scheduler", cfg)
    kind = str(sched.get("type", "")).strip()
    params = dict(sched.get("params", {}))
    k = kind.lower()
    if k in ("warmuplr", "warmup"):
        return warmup_lr(
            max_lr=float(params["warmup_max_lr"]),
            warmup_steps=max(2, int(params.get("warmup_num_steps", 0))),
            min_lr=float(params.get("warmup_min_lr", 0.0)),
            warmup_type=params.get("warmup_type", "linear"),
        )
    if k == "warmupdecaylr":
        return warmup_decay_lr(
            max_lr=float(params["warmup_max_lr"]),
            warmup_steps=max(2, int(params.get("warmup_num_steps", 0))),
            total_steps=_resolve_auto(
                params.get("total_num_steps", "auto"), "total_num_steps", total_steps),
            min_lr=float(params.get("warmup_min_lr", 0.0)),
        )
    if k in ("warmupcosinelr", "warmup_cosine"):
        total = _resolve_auto(
            params.get("total_num_steps", "auto"), "total_num_steps", total_steps)
        peak = params.get("warmup_max_lr", params.get("max_lr"))
        if peak is None:
            raise ValueError(
                "WarmupCosineLR needs 'warmup_max_lr' (or 'max_lr') — a "
                "missing peak would silently train at lr 0")
        return warmup_cosine(
            max_lr=float(peak),
            warmup_steps=int(params.get("warmup_num_steps", 0)),
            total_steps=total,
            end_lr=float(params.get("cos_min_ratio", 0.0)) * float(peak),
        )
    if k in ("cosineannealinglr", "cosine", "cosine_annealing"):
        return cosine_annealing(
            base_lr=float(params["base_lr"]),
            t_max=_resolve_auto(params.get("T_max", "auto"), "T_max", total_steps),
            eta_min=float(params.get("eta_min", 0.0)),
        )
    if k in ("steplr", "step", "step_decay"):
        return step_decay(
            base_lr=float(params["base_lr"]),
            step_size=int(params["step_size"]),
            gamma=float(params.get("gamma", 0.1)),
        )
    if k in ("constant", "constantlr"):
        lr = float(params.get("lr", params.get("base_lr", 0.0)))
        return lambda step: lr
    if not kind:
        raise ValueError(
            "scheduler dict has no 'type' key; expected the DeepSpeed shape "
            '{"type": "WarmupLR", "params": {...}} (or a config with a '
            '"scheduler" key)')
    raise ValueError(
        f"unknown scheduler type {kind!r}; known: WarmupLR, WarmupDecayLR, "
        "WarmupCosineLR, CosineAnnealingLR, StepLR, constant")


def resolve_schedule(spec: float | Mapping[str, Any] | Schedule, *,
                     total_steps: int | None = None) -> float | Schedule:
    """Trainer-facing resolver: float -> constant, dict -> :func:`from_config`,
    callable -> as is."""
    if isinstance(spec, Mapping):
        return from_config(spec, total_steps=total_steps)
    if callable(spec):
        return spec
    return float(spec)
