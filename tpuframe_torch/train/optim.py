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
that the health sentinel skips can restore it like any other tensor.  A
parameter with ``requires_grad=False`` (a frozen backbone,
``models.transfer.freeze``) gets no state and is never stepped, as
``optax.set_to_zero`` leaves it.

``lion``, ``lamb`` and ``adafactor`` have no torch counterpart with optax's
semantics, so the port writes them here in plain PyTorch (:class:`Lion`,
:class:`Lamb`, :class:`Adafactor`): optax computes them outside any Pallas
kernel.  Each keeps optax's chain in its order and its float32 arithmetic;
every parameter has its own step count, a float32 scalar on its device,
where optax keeps one count for the tree (they agree: every stepped
parameter has a gradient every step, a zero one where autograd left none).
Defaults: the Trainer's names take bare optax's (``optax.lion(lr)``: b1
0.9, b2 0.99, weight decay 1e-3; ``optax.lamb(lr)``: eps 1e-6, no decay;
``optax.adafactor(lr)``), the config path
``tpuframe/train/optim.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from tpuframe_torch.train.schedules import Schedule
from tpuframe_torch.train.schedules import from_config as schedule_from_config

__all__ = [
    "Adafactor",
    "Lamb",
    "Lion",
    "OptimizerSpec",
    "clip_by_global_norm_",
    "init_optimizer_state",
    "make_optimizer",
    "optimizer_from_config",
]

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
    #: the parameters' moving average (``train.ema.with_ema``), None = off
    ema_decay: float | None = None

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
    momentum buffers, Adam's step count and moments (all zeros), the
    port's optimizers' own.  Frozen parameters get none."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not p.requires_grad or opt.state.get(p):
                continue
            state = opt.state[p]
            if isinstance(opt, torch.optim.SGD):
                if group["momentum"]:
                    state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
                dev = p.device if group["capturable"] else "cpu"
                state["step"] = torch.zeros((), dtype=torch.float32, device=dev)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         grad_sq: torch.Tensor | None = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``, else
    leave it.  ``grad_sq`` is the summed squares where the caller has them
    (a plan that splits the parameters: their global sum).  Returns the
    global norm (a device scalar, no host sync)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    if grad_sq is not None:
        norm = grad_sq.float().sqrt()
    else:
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
        # bare optax defaults (tpuframe/train/trainer.py:1646-1649)
        "lamb": lambda: _port(Lamb, lr0),
        "lion": lambda: _port(Lion, lr0),
        "adafactor": lambda: _port(Adafactor, lr0),
    }
    try:
        factory = table[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(table)}") from None
    return OptimizerSpec(factory, lr, max_grad_norm)


def optimizer_from_config(cfg: Mapping[str, Any], *, total_steps: int | None = None,
                          fused: bool = False) -> OptimizerSpec:
    """One :class:`OptimizerSpec` from a DeepSpeed-shaped config: its
    ``optimizer`` block, ``scheduler`` (optional; its schedule replaces the
    static lr) and ``gradient_clipping`` (optional, global norm).  ``lr:
    "auto"`` with no scheduler is an error.  ``fused`` steps ``AdamW``
    through ``ops.fused_adamw`` (kernel K4) with the same
    hyperparameters."""
    opt_block = cfg.get("optimizer", {})
    kind = str(opt_block.get("type", "AdamW"))
    k = kind.lower()
    if k not in ("adafactor", "adam", "adamw", "lamb", "lion", "sgd"):
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
    elif k == "lion":
        b1, b2 = p.get("betas", (0.9, 0.99))
        factory = _port(Lion, lr0, b1=float(b1), b2=float(b2),
                        weight_decay=float(p.get("weight_decay", 1e-3)))
    elif k == "lamb":  # the config's betas and eps do not reach optax.lamb
        factory = _port(Lamb, lr0, weight_decay=float(p.get("weight_decay", 0.0)))
    elif k == "adafactor":
        factory = _port(Adafactor, lr0,
                        min_dim_size_to_factor=int(p.get("min_dim_size_to_factor", 128)),
                        decay_rate=float(p.get("decay_rate", 0.8)),
                        weight_decay_rate=(float(p["weight_decay"]) if "weight_decay" in p
                                           else None))
    else:
        betas = p.get("betas", (0.9, 0.999))
        wd = float(p.get("weight_decay", 1e-2)) if k == "adamw" else None
        factory = _adam(lr0, betas, float(p.get("eps", 1e-8)), wd)
    clip = cfg.get("gradient_clipping")
    max_norm = None if clip in (None, "auto", 0, 0.0) else float(clip)
    if fused and k == "adamw":
        from tpuframe_torch.ops.fused_adamw import fused_adamw

        b1, b2 = (float(b) for b in p.get("betas", (0.9, 0.999)))
        return fused_adamw(lr, b1, b2, float(p.get("eps", 1e-8)),
                           float(p.get("weight_decay", 1e-2)), max_norm)
    return OptimizerSpec(factory, lr, max_norm)


# -- optax's lion, lamb and adafactor in plain PyTorch ---------------------------


def _port(cls, lr0: float, **hp):
    def factory(params):
        return cls(params, lr=lr0, **hp)
    return factory


class _PortOptimizer(torch.optim.Optimizer):
    """Common frame of the optax ports: the state of every trainable
    parameter is made with the optimizer (optax's ``init``); ``step()``
    walks every parameter that has a gradient, advances its count and
    hands it to ``_update``, which returns optax's (negated) update ``u``;
    the parameter becomes ``p + u`` (``optax.apply_updates``).
    ``group["lr"]`` may be a float or a device scalar (a schedule read on
    the device)."""

    def __init__(self, params, defaults: dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self.state[p] = self.initial_state(p)

    def initial_state(self, p: torch.Tensor) -> dict:
        """The zero state of one parameter (its count first)."""
        return {"step": torch.zeros((), dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, group, count) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.initial_state(p))
                count = state["step"]  # optax's count before this update
                p.add_(self._update(p, p.grad, state, group, count))
                count.add_(1.0)
        return loss


class Lion(_PortOptimizer):
    """``optax.lion``: ``u = sign((1 - b1) g + b1 m)``, ``m <- (1 - b2) g +
    b2 m``, then decoupled decay ``u + wd p``, then ``-lr``.  ``sign(0)`` is
    0, as in ``jnp.sign``."""

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    def initial_state(self, p):
        return {**super().initial_state(p), "mu": torch.zeros_like(p)}

    def _update(self, p, g, state, group, count):
        b1, b2, mu = group["b1"], group["b2"], state["mu"]
        u = torch.sign((1.0 - b1) * g + b1 * mu)
        mu.copy_((1.0 - b2) * g + b2 * mu)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return -group["lr"] * u


class Lamb(_PortOptimizer):
    """``optax.lamb``: Adam's moments with bias correction (eps outside the
    root, ``eps_root`` 0), then ``+ wd p``, then the trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0), then ``-lr``."""

    #: computes over whole tensors (the trust ratio's norms)
    per_tensor = True

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))

    def initial_state(self, p):
        return {**super().initial_state(p), "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _update(self, p, g, state, group, count):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = state["mu"], state["nu"]
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        t = count + 1.0
        # the corrections in float32, as optax's 1 - decay**count (a
        # scalar base over the float32 count: no host-to-device copy)
        mu_hat = mu / (1.0 - torch.pow(b1, t))
        nu_hat = nu / (1.0 - torch.pow(b2, t))
        u = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0), torch.ones_like(p_norm),
                            p_norm / u_norm)
        return -group["lr"] * (u * ratio)


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int):
    """optax's choice: the two largest dims (second largest, largest), when
    the second largest is at least ``min_dim_size_to_factor``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_PortOptimizer):
    """``optax.adafactor``: factored second moments over the two largest
    dims when both reach ``min_dim_size_to_factor`` (else a full one), with
    ``beta2_t = 1 - (t + 1) ** -decay_rate`` and ``eps`` added to the
    squared gradient; then the update clipped to block RMS 1.0, times the
    lr, times the parameter's RMS (at least ``eps_scale``), plus
    ``weight_decay_rate * p`` when given (after the lr, as optax chains
    it), negated."""

    #: computes over whole tensors (the factored moments, the block RMS)
    per_tensor = True

    def __init__(self, params, lr: float = 1e-2, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, eps: float = 1e-30, clipping_threshold: float = 1.0,
                 eps_scale: float = 1e-3, weight_decay_rate: float | None = None):
        super().__init__(params, dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                                      decay_rate=decay_rate, eps=eps,
                                      clipping_threshold=clipping_threshold,
                                      eps_scale=eps_scale, weight_decay_rate=weight_decay_rate))

    def initial_state(self, p):
        state = super().initial_state(p)
        dims = _factored_dims(p.shape, self.defaults["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            state["v_row"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
            state["v_col"] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
        return state

    def _update(self, p, g, state, group, count):
        # beta2_t in float32, as optax's 1 - t ** -0.8 on a float32 t
        decay = 1.0 - torch.pow(count + 1.0, -group["decay_rate"])
        g_sq = g * g + group["eps"]
        dims = _factored_dims(p.shape, group["min_dim_size_to_factor"])
        if dims is None:
            v = state["v"]
            v.copy_(decay * v + (1.0 - decay) * g_sq)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.copy_(decay * v_row + (1.0 - decay) * g_sq.mean(dim=d0))
            v_col.copy_(decay * v_col + (1.0 - decay) * g_sq.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).pow(-0.5)
            u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        u = u / torch.clamp(torch.sqrt((u * u).mean()) / group["clipping_threshold"], min=1.0)
        u = u * group["lr"]
        rms = torch.sqrt((p * p).mean())
        u = u * torch.where(rms <= group["eps_scale"],
                            torch.full_like(rms, group["eps_scale"]), rms)
        if group["weight_decay_rate"] is not None:
            u = u + group["weight_decay_rate"] * p
        return -u
