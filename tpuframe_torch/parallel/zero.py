"""ZeRO: DeepSpeed's stage ladder as parallel plans, and the owned slices
that carry it.

Port of ``tpuframe/parallel/zero.py``.  Each stage is a
:class:`~tpuframe_torch.parallel.sharding.ParallelPlan`
(``ZeroConfig.plan``); :class:`ZeroShards` is what the JAX package's
shardings do inside XLA, done by hand over ``torch.distributed``:

- **Stages 1 and 2** (one stage, as in JAX).  Every leaf the plan shards
  (``ParallelPlan._state_spec``) gets a contiguous shard tensor, its owned
  slice: chunk ``i`` of ``F`` of the leaf's storage for the rank at index
  ``i`` of its fsdp group, a view of the parameter (the exact mean's bits
  do not depend on the partition, and a view costs no second copy).  The
  optimizer is built over the shards and the whole leaves, so its state
  exists for the owned slices only, and the shards persist across steps
  (K4's launch table holds their addresses).  The train step
  reduce-scatters the sliced gradients inside the fsdp group, sums the
  owned chunk across the data group (``train.step``), steps the shards,
  and all-gathers the new slices into the full parameters
  (:meth:`ZeroShards.after_update`).
- **Stage 3.**  The parameters rest as their shards between steps (their
  storage freed, shapes kept): :meth:`ZeroShards.gather_params` fills them
  on a step's entry and :meth:`ZeroShards.release_params` frees them on
  its exit, the scheme of the JAX compressed step.  No per-layer gather.
- **Under the compressed wire** the slices are ``update_shard_specs``'s,
  over every data axis, along JAX's shard dim (the wire's per-chunk scales
  depend on which elements a chunk holds): the wire's reduce-scatter hands
  each rank its owned chunk (``parallel.compression``).
- **Global norms.**  :meth:`ZeroShards.global_grad_sq` sums the slices'
  squares across the slice group and adds the whole leaves once, so the
  clip and the health verdict see one value on every rank.
- **Offload** (``offload_optimizer`` on the card): the optimizer state of
  at least one dim lives in pinned host memory and is copied to the card
  around each update (:meth:`ZeroShards.offloaded`).

A save holds each optimizer leaf at its parameter's full shape, as the JAX
package's global arrays do (:meth:`ZeroShards.full_tensor`); a restore
slices it again (:meth:`ZeroShards.load_full`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from tpuframe_torch.core.runtime import DATA_AXIS, Mesh, current_runtime
from tpuframe_torch.parallel.sharding import ParallelPlan, flax_orders, host_memory_available

__all__ = [
    "ZeroConfig",
    "ZeroShards",
    "host_offload_sharding",
    "supports_host_offload",
    "zero_0",
    "zero_1",
    "zero_2",
    "zero_3",
    "zero_3_offload",
]


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """Config-file-friendly description of a ZeRO stage."""

    stage: int = 0
    offload_optimizer: bool = False
    min_shard_elems: int = 2**14

    @classmethod
    def from_dict(cls, cfg: Mapping[str, Any]) -> "ZeroConfig":
        """Accept a DeepSpeed-shaped dict: ``{"zero_optimization": {"stage": N,
        "offload_optimizer": {"device": "cpu"}}}`` or the flat form."""
        zo = cfg.get("zero_optimization", cfg)
        offload = zo.get("offload_optimizer")
        if isinstance(offload, Mapping):
            offload = offload.get("device") not in (None, "none")
        return cls(
            stage=int(zo.get("stage", 0)),
            offload_optimizer=bool(offload),
            min_shard_elems=int(zo.get("min_shard_elems", 2**14)),
        )

    def plan(self, mesh: Mesh, rules: Sequence[Any] = ()) -> ParallelPlan:
        return ParallelPlan(mesh=mesh, zero_stage=self.stage, rules=tuple(rules),
                            min_shard_elems=self.min_shard_elems,
                            offload_optimizer=self.offload_optimizer)


def zero_0(mesh: Mesh, **kw) -> ParallelPlan:
    """Pure DP: replicate everything, average the gradients."""
    return ZeroConfig(stage=0).plan(mesh, **kw)


def zero_1(mesh: Mesh, **kw) -> ParallelPlan:
    """Optimizer-state sharding."""
    return ZeroConfig(stage=1).plan(mesh, **kw)


def zero_2(mesh: Mesh, **kw) -> ParallelPlan:
    """Gradient and optimizer sharding: the plan of stage 1, as in JAX (both
    free a sliced leaf's full gradient once its owned chunk is taken)."""
    return ZeroConfig(stage=2).plan(mesh, **kw)


def zero_3(mesh: Mesh, **kw) -> ParallelPlan:
    """Sharded parameters, gathered for the step."""
    return ZeroConfig(stage=3).plan(mesh, **kw)


def zero_3_offload(mesh: Mesh, **kw) -> ParallelPlan:
    """Stage 3 with the optimizer state in pinned host memory; on the CPU
    it warns and stays plain stage 3."""
    return ZeroConfig(stage=3, offload_optimizer=True).plan(mesh, **kw)


def host_offload_sharding(tensor: torch.Tensor) -> torch.Tensor:
    """The torch meaning of the JAX placement in ``pinned_host``: a copy of
    ``tensor`` in pinned host memory.  Raises where there is no host memory
    space apart from the device (a CPU runtime), as JAX's does."""
    if not supports_host_offload():
        raise RuntimeError("no pinned host memory space beside a CUDA device in this process")
    return tensor.detach().to("cpu").pin_memory()


def supports_host_offload() -> bool:
    return host_memory_available()


# -- the owned slices ---------------------------------------------------------


@dataclasses.dataclass
class _Slice:
    """One leaf cut ``world`` ways; this rank owns chunk ``index``.  On a
    ``dim`` (the compressed wire's slicing, whose per-chunk scales must
    cover JAX's elements): rows ``[index * rows, (index + 1) * rows)`` of
    the leaf with ``dim`` moved to the front.  With ``dim`` None (the exact
    mean's slicing, whose bits no partition changes): a run of the leaf's
    storage, its dims walked in ``order`` (the parameter's memory order:
    a channels_last conv is NHWC in memory), so the owned slice of a full
    parameter is a contiguous view.  ``group`` is the slicing's process
    group (None: the default group)."""

    dim: int | None
    world: int
    index: int
    group: Any
    shape: tuple
    order: tuple = ()

    @property
    def moved_shape(self) -> tuple:
        if self.dim is None:
            return (math.prod(self.shape),)
        rest = tuple(n for i, n in enumerate(self.shape) if i != self.dim)
        return (self.shape[self.dim],) + rest

    @property
    def rows(self) -> int:
        return self.moved_shape[0] // self.world

    @property
    def shard_shape(self) -> tuple:
        return (self.rows,) + self.moved_shape[1:]

    def _moved(self, full: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return full.permute(self.order).reshape(-1)
        return full.movedim(self.dim, 0)

    def owned(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-shape tensor (a view)."""
        return self._moved(full)[self.index * self.rows:(self.index + 1) * self.rows]

    def chunks(self, full: torch.Tensor) -> torch.Tensor:
        """A full-shape tensor as its (world, chunk) rows."""
        return self._moved(full).reshape(self.world, -1)

    def unchunk(self, rows: torch.Tensor) -> torch.Tensor:
        """(world, chunk) rows back to the full shape (a view where it can)."""
        moved = rows.reshape(self.moved_shape)
        if self.dim is None:
            walked = moved.reshape([self.shape[d] for d in self.order])
            return walked.permute([self.order.index(d) for d in range(len(self.shape))])
        return moved.movedim(0, self.dim)

    def same_as(self, other: "_Slice | None") -> bool:
        return (other is not None and self.dim == other.dim and self.world == other.world
                and self.index == other.index and self.group is other.group
                and self.order == other.order)


def _group_of(axis: str, plan: ParallelPlan):
    """This rank's process group along ``axis`` (None: the default group)."""
    if plan.axis_size(axis) == dist.get_world_size():
        return None
    return current_runtime(auto_init=False).groups[axis]


class ZeroShards:
    """The owned slices of ``model``'s trainable parameters under a ZeRO
    ``plan`` (module docstring).  ``compressed``: the slices of the
    compressed wire (``update_shard_specs``, over every data axis) in place
    of the plan's fsdp ones.

    ``opt_params`` is what the optimizer is built over, in the order of the
    trainable parameters: the shard of a sliced leaf, else the parameter
    itself.  A world of one rank, or a plan that shards nothing, leaves
    every leaf whole (stage 0 in effect)."""

    def __init__(self, model: nn.Module, plan: ParallelPlan, *, compressed: bool = False):
        self.model, self.plan, self.compressed = model, plan, compressed
        self.stage = plan.zero_stage
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.orders = flax_orders(model)
        wired = dist.is_available() and dist.is_initialized()
        if wired and plan.dp_size > 1:
            plan.check_world()
        rank = dist.get_rank() if wired else 0
        shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        #: the optimizer's slicing (sliced leaves only)
        self.opt: dict[str, _Slice] = {}
        #: stage 3: how each parameter rests between steps
        self.rest: dict[str, _Slice] = {}
        #: the data group a stage-1/2 owned chunk is summed over (None: no sum)
        self.replica_group = None
        self.replica_world = 1
        if not wired or plan.dp_size <= 1:
            self._build_tensors()
            return
        coords = plan.mesh.coords(rank)
        fsdp, F = plan.fsdp_axis, plan.axis_size(plan.fsdp_axis)
        if compressed:
            specs = plan.update_shard_specs({n: _Shape(s) for n, s in shapes.items()},
                                            self.orders)
            for name, (dim, _) in specs.items():
                self.opt[name] = _Slice(dim, dist.get_world_size(), rank, None, shapes[name])
        elif F > 1:
            group = _group_of(fsdp, plan)
            for name, shape in shapes.items():
                if _fsdp_dim(plan._state_spec(name, shape, self.orders.get(name)), fsdp) is not None:
                    self.opt[name] = _Slice(None, F, coords[fsdp], group, shape,
                                            _memory_order(self.params[name]))
            data = plan.axis_size(DATA_AXIS)
            if data > 1 and self.opt:
                self.replica_group, self.replica_world = _group_of(DATA_AXIS, plan), data
        if self.stage == 3 and F > 1:
            group = _group_of(fsdp, plan)
            for name, shape in shapes.items():
                dim = _fsdp_dim(plan.param_spec(name, shape, self.orders.get(name)), fsdp)
                if dim is None:
                    continue
                if compressed:  # the wire's form, so that it can share the shard
                    self.rest[name] = _Slice(dim, F, coords[fsdp], group, shape)
                else:
                    self.rest[name] = _Slice(None, F, coords[fsdp], group, shape,
                                             _memory_order(self.params[name]))
        self._build_tensors()

    @torch.no_grad()
    def _build_tensors(self) -> None:
        self.shards: dict[str, torch.Tensor] = {}
        #: shards that are views of their full parameter (stages 1 and 2,
        #: where the owned slice is contiguous): no second copy
        self.views: set[str] = set()
        for name, sl in self.opt.items():
            full = self.params[name].detach()
            own = sl.owned(full)
            if (name not in self.rest and own.is_contiguous()
                    and own.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()):
                self.views.add(name)
            else:
                own = own.contiguous().clone()
            self.shards[name] = nn.Parameter(own)
        #: stage-3 resting tensors: the optimizer's shard where the slicing
        #: is the same, else a tensor of their own
        self.resting: dict[str, torch.Tensor] = {}
        for name, sl in self.rest.items():
            if sl.same_as(self.opt.get(name)):
                self.resting[name] = self.shards[name]
            else:
                self.resting[name] = sl.owned(self.params[name].detach()).contiguous().clone()
        self.opt_params = [self.shards.get(n, p) for n, p in self.params.items()]
        self._gathered = True

    @property
    def active(self) -> bool:
        """Whether any leaf is sliced."""
        return bool(self.opt or self.rest)

    # -- stage 3: gather on entry, release on exit ---------------------------
    @torch.no_grad()
    def gather_params(self) -> None:
        """Stage 3: every resting parameter filled from the shards of its
        group (one all-gather a dtype and group)."""
        if self._gathered or not self.rest:
            self._gathered = True
            return
        for name in self.rest:
            p = self.params[name]
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self._gather_into({n: self.resting[n] for n in self.rest}, self.rest)
        self._gathered = True

    @torch.no_grad()
    def release_params(self) -> None:
        """Stage 3: free every resting parameter's storage (its shape
        stays; reading it before :meth:`gather_params` raises)."""
        if not self._gathered or not self.rest:
            self._gathered = not self.rest
            return
        for name in self.rest:
            self.params[name].untyped_storage().resize_(0)
        self._gathered = False

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The full parameters for a block (eval, predict, a save); they
        rest again after it when they rested before."""
        was = self._gathered
        self.gather_params()
        try:
            yield
        finally:
            if not was:
                self.release_params()

    def _gather_into(self, sources: Mapping[str, torch.Tensor],
                     slices: Mapping[str, _Slice]) -> None:
        """All-gather ``sources`` (owned slices) into the full parameters,
        one collective per (group, dtype)."""
        from tpuframe_torch.parallel.compression import _all_gather_chunks

        batches: dict[tuple, list[str]] = {}
        for name in sources:
            sl = slices[name]
            batches.setdefault((id(sl.group), sl.world, sources[name].dtype), []).append(name)
        for (_, world, _), names in batches.items():
            flat = torch.cat([sources[n].reshape(-1) for n in names])
            rows = _all_gather_chunks(flat, world, group=slices[names[0]].group, exact=True)
            start = 0
            for n in names:
                size = sources[n].numel()
                self.params[n].copy_(slices[n].unchunk(rows[:, start:start + size]))
                start += size

    # -- the update ------------------------------------------------------------
    def sliced_grads(self) -> list[torch.Tensor]:
        return [self.shards[n].grad for n in self.opt if self.shards[n].grad is not None]

    def whole_grads(self) -> list[torch.Tensor]:
        return [p.grad for n, p in self.params.items()
                if n not in self.opt and p.grad is not None]

    @torch.no_grad()
    def global_grad_sq(self) -> torch.Tensor:
        """The plan-global sum of squared gradients: the owned slices'
        summed across the slice group, the whole leaves' added once (the
        same value on every rank)."""
        device = next(iter(self.params.values())).device
        sliced, whole = self.sliced_grads(), self.whole_grads()
        sq = torch.zeros((), dtype=torch.float32, device=device)
        if sliced:
            sq = torch.stack([n.float() for n in torch._foreach_norm(sliced)]).square().sum()
        if self.opt:
            group = next(iter(self.opt.values())).group
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
        if whole:
            sq = sq + torch.stack([n.float() for n in torch._foreach_norm(whole)]).square().sum()
        return sq

    @torch.no_grad()
    def clip_(self, max_norm: float, grad_sq: torch.Tensor) -> None:
        """optax's global-norm clip at the plan-global norm."""
        norm = grad_sq.sqrt()
        grads = self.sliced_grads() + self.whole_grads()
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def after_update(self) -> None:
        """The new owned slices into the full parameters (all-gathered),
        and stage 3's resting tensors of their own re-sliced."""
        gather = {n: self.shards[n] for n in self.opt if not self.opt[n].same_as(self.rest.get(n))}
        if gather:
            self._gather_into(gather, self.opt)
        for n, sl in self.rest.items():
            if self.resting[n] is not self.shards.get(n):
                self.resting[n].copy_(sl.owned(self.params[n]))

    def sentinel_tensors(self) -> list[torch.Tensor]:
        """What a skipped step restores of the parameters: the full ones
        that persist (stages 0-2, and leaves that never rest), the shards
        and the resting tensors."""
        out = [p.data for n, p in self.model.named_parameters() if n not in self.rest]
        out += [t for n, t in self.shards.items() if n not in self.views]
        out += [t for n, t in self.resting.items() if t is not self.shards.get(n)]
        return out

    # -- offload ---------------------------------------------------------------
    def offload(self, optimizer: torch.optim.Optimizer) -> None:
        """Move the optimizer state of at least one dim into pinned host
        memory (scalars, the step counts, stay on the device)."""
        self._offloaded = optimizer
        for st in optimizer.state.values():
            for k, v in list(st.items()):
                if torch.is_tensor(v) and v.ndim > 0 and v.device.type == "cuda":
                    st[k] = v.to("cpu").pin_memory()

    @contextlib.contextmanager
    def offloaded(self, optimizer: torch.optim.Optimizer) -> Iterator[None]:
        """Around one update: the host state copied to the card, the
        update, the new state copied back (nothing without offload)."""
        if getattr(self, "_offloaded", None) is not optimizer:
            yield
            return
        device = next(iter(self.params.values())).device
        hosts = [(st, k, v) for st in optimizer.state.values() for k, v in st.items()
                 if torch.is_tensor(v) and v.ndim > 0 and v.device.type == "cpu"]
        for st, k, v in hosts:
            st[k] = v.to(device, non_blocking=True)
        _new_tables(optimizer)
        try:
            yield
        finally:
            for st, k, v in hosts:
                v.copy_(st[k], non_blocking=True)
                st[k] = v
            _new_tables(optimizer)
            torch.cuda.current_stream(device).synchronize()

    # -- checkpoints -------------------------------------------------------------
    @torch.no_grad()
    def full_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A new full-shape copy of ``name``'s owned-slice tensor ``t``
        (gathered over the slice group); ``t`` itself when ``name`` is
        whole or ``t`` is not slice-shaped (a scalar count)."""
        from tpuframe_torch.parallel.compression import _all_gather_chunks

        sl = self.opt.get(name)
        if sl is None or tuple(t.shape) != sl.shard_shape:
            return t
        device = self.params[name].device
        rows = _all_gather_chunks(t.to(device).reshape(-1), sl.world, group=sl.group, exact=True)
        return sl.unchunk(rows).contiguous()

    @torch.no_grad()
    def full_params(self) -> dict[str, torch.Tensor]:
        """Full copies of the resting parameters (stage 3)."""
        if not self.rest:
            return {}
        with self.gathered():
            return {n: self.params[n].detach().clone() for n in self.rest}

    @torch.no_grad()
    def load_full(self, params: Mapping[str, torch.Tensor],
                  opt_state: Mapping[str, Mapping[str, torch.Tensor]],
                  optimizer: torch.optim.Optimizer) -> None:
        """Slice full-shape parameters (``params``: the loaded values, by
        name; the live ones where absent) and optimizer state into the
        shards, the resting tensors and the owned state."""
        for n, sl in self.opt.items():
            full = params.get(n, self.params[n])
            self.shards[n].copy_(sl.owned(full))
            live = optimizer.state.get(self.shards[n], {})
            for k, v in opt_state.get(n, {}).items():
                if k in live and torch.is_tensor(v) and tuple(v.shape) == sl.shape:
                    live[k].copy_(sl.owned(v.to(live[k].device)))
        for n, sl in self.rest.items():
            if self.resting[n] is not self.shards.get(n):
                self.resting[n].copy_(sl.owned(params.get(n, self.params[n])))


def _memory_order(t: torch.Tensor) -> tuple:
    """``t``'s dims from the slowest to the fastest in memory."""
    return tuple(sorted(range(t.ndim), key=lambda d: -t.stride()[d]))


def _fsdp_dim(spec: tuple, axis: str) -> int | None:
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def _new_tables(optimizer: torch.optim.Optimizer) -> None:
    """A fused optimizer's launch tables hold the state's addresses: drop
    them when the state moves."""
    if hasattr(optimizer, "_launch_plans"):
        optimizer._launch_plans = {}


class _Shape:
    """A leaf known by its shape alone (for the plan's spec methods)."""

    def __init__(self, shape: tuple):
        self.shape = shape

