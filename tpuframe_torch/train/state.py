"""Train state: everything a step updates, in torch idiom.

Port of ``tpuframe/train/state.py``.  The JAX state is one immutable pytree
(params, opt_state, batch_stats, step, rng) that each step replaces; here
the same parts are an ``nn.Module`` (parameters and BatchNorm buffers),
a ``torch.optim.Optimizer`` with its :class:`OptimizerSpec` (LR schedule,
global-norm clip), the step count, the health sentinel's device scalars and
a ``torch.Generator``, and a step updates them in place.

The LR schedule is read at the count of *applied* updates, as optax reads
its own count inside ``opt_state``: a step the health sentinel skips
restores that count with the rest of the state.  The count is a device
scalar, so reading the schedule at it needs no host sync: the schedule's
values are kept in a float32 table on the device (filled on the host,
grown by doubling, read by indexing with the count).

:meth:`TrainState.state_dict` is what a checkpoint holds, the torch form
of the JAX ``_state_data`` (``tpuframe/ckpt/checkpoint.py:60-76``), and
:meth:`TrainState.load_state_dict` restores it in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

from tpuframe_torch.fault.health import init_health_state
from tpuframe_torch.train.optim import OptimizerSpec, clip_by_global_norm_

__all__ = ["TrainState", "create_train_state", "param_count"]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the step counters.

    ``step`` counts train steps taken (skipped ones included, as the JAX
    ``state.step`` does).  ``updates`` (an int64 scalar on the model's
    device) counts the updates applied; the LR schedule is read at it.
    ``health`` is the sentinel's state (``fault.health.init_health_state``).
    ``generator`` seeds the step's randomness (dropout-style layers).
    ``comms`` holds the compressed wire's error-feedback residuals
    (``parallel.compression.init_comms_state``), empty by default.
    """

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    health: dict
    generator: torch.Generator
    updates: torch.Tensor
    comms: dict = dataclasses.field(default_factory=dict)
    _lr_table: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in ``.grad``: the global-norm clip
        when the spec has one, ``lr = schedule(updates)``,
        ``optimizer.step()``, then ``updates += 1`` and ``step += 1``."""
        if self.spec.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                 self.spec.max_grad_norm)
        lr = self._lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1
        self.step += 1
        return self

    def _lr(self) -> float | torch.Tensor:
        """The learning rate of this update: a float for a constant, else
        the schedule at ``updates`` as a device scalar."""
        if not callable(self.spec.lr):
            return float(self.spec.lr)
        # updates <= step, so the table must reach index step
        if self._lr_table is None or len(self._lr_table) <= self.step:
            size = max(64, 2 * (self.step + 1))
            self._lr_table = torch.tensor([float(self.spec.lr(i)) for i in range(size)],
                                          dtype=torch.float32, device=self.updates.device)
        return self._lr_table[self.updates]

    def state_dict(self) -> dict:
        """What a checkpoint saves: ``step`` (an int), ``updates``, the
        model's ``state_dict`` (parameters and buffers), the optimizer's
        per-parameter state keyed by parameter name (SGD's momentum,
        Adam's moments and step, ``FusedAdamW``'s int32 count and float32
        moments), the health sentinel's tensors, the generator's state as
        ``rng``, and ``comms`` only when it holds residuals, so an
        uncompressed state keeps the layout it had before the wire.  The
        tensors are the live ones (the generator's state a copy); the
        schedule's table is rebuilt, not saved."""
        names = {p: n for n, p in self.model.named_parameters()}
        optimizer = {}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if self.optimizer.state.get(p):
                    optimizer[names[p]] = dict(self.optimizer.state[p])
        data = {
            "step": self.step,
            "updates": self.updates,
            "model": self.model.state_dict(),
            "optimizer": optimizer,
            "health": dict(self.health),
            "rng": self.generator.get_state(),
        }
        if self.comms:
            data["comms"] = dict(self.comms)
        return data

    @torch.no_grad()
    def load_state_dict(self, data: Mapping[str, Any]) -> "TrainState":
        """Restore :meth:`state_dict` in place: each saved tensor is copied
        into the live tensor of the same key, which keeps its device, dtype
        and address (the optimizer's launch tables and the step's
        snapshots hold addresses), bit for bit where the dtypes agree.
        ``comms`` is restored when both sides have it.  Keys or shapes that
        differ raise ``ValueError``."""
        live = self.state_dict()
        if "comms" not in data:
            live.pop("comms", None)
        elif "comms" not in live:
            raise ValueError("the saved state has comms residuals; this state has none")
        _copy_into(live, data, "")
        self.step = int(data["step"])
        self.generator.set_state(data["rng"].cpu())
        return self


def _copy_into(live: Mapping, saved: Mapping, where: str) -> None:
    """Copy the tensors of ``saved`` into those of ``live``, key by key."""
    missing = sorted(set(live) - set(saved))
    extra = sorted(set(saved) - set(live))
    if missing or extra:
        raise ValueError(f"state keys differ at {where or 'the top'!r}: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for key, dst in live.items():
        src, at = saved[key], f"{where}/{key}" if where else str(key)
        if isinstance(dst, Mapping):
            _copy_into(dst, src, at)
        elif torch.is_tensor(dst):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{at}: saved shape {tuple(src.shape)}, live {tuple(dst.shape)}")
            if src is not dst:
                dst.copy_(src)


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
        updates=torch.zeros((), dtype=torch.int64, device=device),
    )


def param_count(state_or_params: Any) -> int:
    """The number of parameter elements: of a :class:`TrainState`'s model,
    of an ``nn.Module``'s parameters, or over the leaves of a (nested)
    mapping or sequence of tensors or arrays."""
    tree = state_or_params.model if isinstance(state_or_params, TrainState) else state_or_params
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, Mapping):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return math.prod(getattr(tree, "shape", ()))
