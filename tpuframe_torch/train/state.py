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

Under a ZeRO plan (``create_train_state(..., plan=)``) the state carries a
``parallel.zero.ZeroShards`` and the optimizer steps its owned slices:
the clip takes the plan-global norm, the new slices are gathered into the
parameters after each update, and a save holds every optimizer leaf at its
parameter's full shape (gathered), which a restore slices again.

Under a plan whose rules split parameters over ``model``, ``pipe`` or
``expert`` (tensor, pipeline and expert parallelism) each rank's model
holds its shards
(``parallel.tensor.shard_model``) and the optimizer steps them; the clip
takes the global norm, and a save holds every parameter, optimizer leaf
and moving average whole, the same keys and shapes under every plan,
which a restore slices onto this rank's shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

import contextlib

from tpuframe_torch.fault.health import init_health_state
from tpuframe_torch.parallel.tensor import full_tensor, shard_model
from tpuframe_torch.parallel.tensor import grad_sq as split_grad_sq
from tpuframe_torch.train.ema import EmaState, init_ema, update_ema_
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
    ``ema`` is the parameters' moving average (``train.ema``) when the
    spec asks for one.  ``plan`` is the ``ParallelPlan`` the state was laid
    out for (None: none given), and ``zero`` holds the owned slices under a
    ZeRO plan (``parallel.zero.ZeroShards``), None otherwise.
    """

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    health: dict
    generator: torch.Generator
    updates: torch.Tensor
    comms: dict = dataclasses.field(default_factory=dict)
    ema: EmaState | None = None
    plan: Any = None
    zero: Any = None
    _lr_table: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    def apply_gradients(self, grad_sq: torch.Tensor | None = None) -> "TrainState":
        """One update from the gradients in ``.grad``: the global-norm clip
        when the spec has one, ``lr = schedule(updates)``,
        ``optimizer.step()``, the moving average of the new parameters
        when there is one, then ``updates += 1`` and ``step += 1``.

        Under ZeRO the gradients are the owned slices' (and the whole
        leaves'), the clip's norm is the plan-global one (``grad_sq``, the
        summed squares, when the caller has it), and the new slices are
        gathered into the parameters after the update."""
        zero = self.zero
        if self.spec.max_grad_norm is not None:
            if zero is not None:
                zero.clip_(self.spec.max_grad_norm,
                           zero.global_grad_sq() if grad_sq is None else grad_sq)
            else:
                if grad_sq is None and _split(self.model):
                    grad_sq = split_grad_sq(self.model)
                clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                     self.spec.max_grad_norm, grad_sq)
        lr = self._lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        with zero.offloaded(self.optimizer) if zero is not None else contextlib.nullcontext():
            self.optimizer.step()
        if zero is not None:
            zero.after_update()
        if self.ema is not None:
            update_ema_(self.ema, dict(self.model.named_parameters()))
        self.updates += 1
        self.step += 1
        return self

    def _lr(self) -> float | torch.Tensor:
        """The learning rate of this update: a float for a constant, else
        the schedule at ``updates`` as a float32 device scalar (every
        optimizer, ``FusedAdamW``'s K4 included, reads it there).  While a
        CUDA graph captures the step, ``step`` is a device scalar and the
        table was reserved beforehand (:meth:`reserve_lr`): it must not
        move, the graph keeps its address."""
        if not callable(self.spec.lr):
            return float(self.spec.lr)
        # updates <= step, so the table must reach index step
        if not torch.is_tensor(self.step):
            self.reserve_lr(self.step)
        # index_select, not [updates]: a 0-d index may be read back as an int
        return self._lr_table.index_select(0, self.updates.reshape(1)).reshape(())

    def reserve_lr(self, steps: int) -> None:
        """Make the schedule's table reach index ``steps`` (a fit's planned
        step count before a graph captures its step); it grows by doubling
        and is filled on the host."""
        if not callable(self.spec.lr):
            return
        if self._lr_table is None or len(self._lr_table) <= steps:
            size = max(64, 2 * (int(steps) + 1))
            self._lr_table = torch.tensor([float(self.spec.lr(i)) for i in range(size)],
                                          dtype=torch.float32, device=self.updates.device)

    def state_dict(self) -> dict:
        """What a checkpoint saves: ``step`` (an int), ``updates``, the
        model's ``state_dict`` (parameters and buffers), the optimizer's
        per-parameter state keyed by parameter name (SGD's momentum,
        Adam's moments and step, ``FusedAdamW``'s int32 count and float32
        moments), the health sentinel's tensors, the generator's state as
        ``rng``, ``comms`` only when it holds residuals, so an
        uncompressed state keeps the layout it had before the wire, and
        ``ema`` (the average by parameter name) only when there is one.  The
        tensors are the live ones (the generator's state a copy); the
        schedule's table is rebuilt, not saved."""
        zero = self.zero
        names = {p: n for n, p in self.model.named_parameters()}
        if zero is not None:
            names.update({t: n for n, t in zero.shards.items()})
        optimizer = {}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if self.optimizer.state.get(p):
                    name = names[p]
                    optimizer[name] = {k: (zero.full_tensor(name, v)
                                           if zero is not None and torch.is_tensor(v) else v)
                                       for k, v in self.optimizer.state[p].items()}
        model = self.model.state_dict()
        if zero is not None:
            model.update(zero.full_params())
        layout, mesh = _split(self.model), getattr(self.model, "tp_mesh", None)
        if layout:
            params = dict(self.model.named_parameters())
            for name, splits in layout.items():
                model[name] = full_tensor(params[name], splits, mesh)
                if name in optimizer:
                    optimizer[name] = {
                        k: full_tensor(v, splits, mesh) if _like(v, params[name]) else v
                        for k, v in optimizer[name].items()}
        data = {
            "step": self.step,
            "updates": self.updates,
            "model": model,
            "optimizer": optimizer,
            "health": dict(self.health),
            "rng": self.generator.get_state(),
        }
        if self.comms:
            data["comms"] = dict(self.comms)
        if self.ema is not None:
            data["ema"] = {k: full_tensor(v, layout[k], mesh) if k in layout else v
                           for k, v in self.ema.ema.items()}
        return data

    @torch.no_grad()
    def load_state_dict(self, data: Mapping[str, Any]) -> "TrainState":
        """Restore :meth:`state_dict` in place: each saved tensor is copied
        into the live tensor of the same key, which keeps its device, dtype
        and address (the optimizer's launch tables and the step's
        snapshots hold addresses), bit for bit where the dtypes agree.
        ``comms`` is restored when both sides have it.  Keys or shapes that
        differ raise ``ValueError``, and so does an ``ema`` on one side
        only.  Under ZeRO the full-shape leaves are sliced into the owned
        ones (every rank calls this: the live full shapes are gathered)."""
        live = self.state_dict()
        if "comms" not in data:
            live.pop("comms", None)
        elif "comms" not in live:
            raise ValueError("the saved state has comms residuals; this state has none")
        if ("ema" in data) != ("ema" in live):
            raise ValueError("the saved state and this state disagree on an EMA: "
                             f"saved {'ema' in data}, live {'ema' in live}")
        _copy_into(live, data, "")
        if self.zero is not None:
            self.zero.load_full(live["model"], live["optimizer"], self.optimizer)
        layout, mesh = _split(self.model), getattr(self.model, "tp_mesh", None)
        if layout:  # the whole tensors sliced onto this rank's shards
            params = dict(self.model.named_parameters())
            for name, splits in layout.items():
                p = params[name]
                p.data.copy_(mesh.local_slice(live["model"][name], splits))
                for k, v in self.optimizer.state.get(p, {}).items():
                    if _like(v, p):
                        v.copy_(mesh.local_slice(live["optimizer"][name][k], splits))
                if self.ema is not None and name in self.ema.ema:
                    self.ema.ema[name].copy_(mesh.local_slice(live["ema"][name], splits))
        self.step = int(data["step"])
        self.generator.set_state(data["rng"].cpu())
        return self


def _split(model: nn.Module) -> dict:
    """The layout of a model a plan split (``parallel.tensor``), else {}."""
    return getattr(model, "tp_layout", None) or {}


def _like(v: Any, p: torch.Tensor) -> bool:
    """Whether an optimizer state value is shaped like its parameter."""
    return torch.is_tensor(v) and v.shape == p.shape and v.ndim > 0


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


def create_train_state(model: nn.Module, spec: OptimizerSpec, *, seed: int = 0,
                       plan: Any = None, grad_compression: Any = None) -> TrainState:
    """A :class:`TrainState` over an initialized ``model`` (torch modules
    arrive initialized; ``models.from_jax_variables`` carries JAX weights
    in), with the optimizer built by ``spec`` over its parameters.

    A ZeRO ``plan`` (stage 1-3 over more than one rank; every process
    calls this) builds the optimizer over the owned slices instead
    (``parallel.zero.ZeroShards``), with ``grad_compression`` the slices of
    the compressed wire; under stage 3 the parameters then rest as their
    shards, and under offload on the card the optimizer state lives in
    pinned host memory.  The model's full parameters exist on every rank
    first (torch builds them so)."""
    device = next(model.parameters()).device
    zero = None
    sp_ep = () if plan is None else tuple(a for a in ("seq", "expert") if plan.axis_size(a) > 1)
    if plan is not None and plan.split_axes:
        what = [w for w, on in (("zero_stage >= 1", plan.zero_stage >= 1),
                                ("offload_optimizer", plan.offload_optimizer),
                                ("grad_compression", grad_compression is not None)) if on]
        if what:
            raise NotImplementedError(
                f"{', '.join(what)} with the {'/'.join(plan.split_axes)} axis above 1 is not "
                "ported: ZeRO, offload and the compressed wire beside tensor and pipeline "
                "parallelism come with a later part of ROADMAP.md, Queue 1 item 7")
    if sp_ep:
        what = [w for w, on in (
            ("an active ZeRO stage (zero_stage >= 1 with fsdp above 1)",
             plan.zero_stage >= 1 and plan.axis_size(plan.fsdp_axis) > 1),
            ("offload_optimizer", plan.offload_optimizer),
            ("grad_compression", grad_compression is not None)) if on]
        if what:
            raise NotImplementedError(
                f"{', '.join(what)} with the {'/'.join(sp_ep)} axis above 1 is not ported: "
                "ZeRO, offload and the compressed wire beside sequence and expert parallelism "
                "come with the rest of ROADMAP.md, Queue 1 item 7")
    if plan is not None and (plan.split_axes or "expert" in sp_ep):
        shard_model(model, plan)
    if plan is not None and getattr(plan, "zero_stage", 0) >= 1:
        from tpuframe_torch.parallel.zero import ZeroShards

        zero = ZeroShards(model, plan, compressed=grad_compression is not None)
        if not zero.active:
            zero = None
    ema = (None if spec.ema_decay is None
           else init_ema(dict(model.named_parameters()), spec.ema_decay))
    if zero is not None:
        optimizer = spec.build(zero.opt_params)
        if getattr(optimizer, "per_tensor", False):
            raise NotImplementedError(
                f"{type(optimizer).__name__} computes over whole tensors (norms, factored "
                "moments); over owned slices it needs those reduced across the group, which "
                "is not ported (ROADMAP.md, Queue 3): use sgd, adam, adamw, fused_adamw or "
                "lion under ZeRO stages 1-3")
        zero.release_params()
        if plan._offload_active():
            zero.offload(optimizer)
    else:
        optimizer = spec.build(model.parameters())
        if _split(model) and getattr(optimizer, "per_tensor", False):
            raise NotImplementedError(
                f"{type(optimizer).__name__} computes over whole tensors (norms, factored "
                "moments); over tensor-parallel shards it needs those reduced across the "
                "group, which is not ported: use sgd, adam, adamw, fused_adamw or lion")
    return TrainState(
        step=0,
        model=model,
        optimizer=optimizer,
        spec=spec,
        health=init_health_state(device),
        generator=torch.Generator(device=device).manual_seed(seed),
        updates=torch.zeros((), dtype=torch.int64, device=device),
        ema=ema,
        plan=plan,
        zero=zero,
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
