"""The parallel plan: how the port lays a train step over its processes.

Port of ``tpuframe/parallel/sharding.py``'s ``ParallelPlan``.  Every
process trains on its own share of the global batch and the gradients are
averaged across the processes, either exactly or through the compressed
wire (``parallel.compression``).  A plan's mesh must span the default
process group (:meth:`ParallelPlan.check_world`).

The **token group** is the ranks that hold different tokens: ``data`` x
``fsdp`` x ``seq`` among the ranks that share this rank's ``expert``,
``pipe`` and ``model`` coordinates (``Runtime.groups["tok"]``).  The
exact mean averages every gradient over it; nothing is averaged over
``expert`` (a replicated parameter is equal on every expert rank by
construction, an expert-split one differs there by design).

``zero_stage`` is DeepSpeed's ladder, as in the JAX package:

- 0: everything replicated (DDP);
- 1 and 2 (one stage): the optimizer state is sharded over ``fsdp``; the
  gradient of a sharded leaf is reduce-scattered, the owned slice updated,
  and the new slices all-gathered into the full parameter;
- 3: the parameters are sharded over ``fsdp`` too and gathered for the step.

A spec here is a tuple of axis names (or None) per dimension, the port's
form of a ``PartitionSpec``.  The dimension a leaf is sharded on is the
JAX package's choice, the largest divisible one (the first on a tie),
taken on the leaf's *flax* layout: a torch conv kernel is OIHW where flax's
is HWIO, a linear weight (out, in) where flax's kernel is (in, out), so
the methods take an ``order`` (the torch dims in flax order,
:func:`flax_orders`) and map the choice back.  Where in = out that picks
JAX's logical axis, so the wire's per-chunk scales cover the same
elements.

Tensor-parallel ``rules`` (:data:`Rule`: a regex over the parameter's
flax path and a spec) assign a spec to the first parameter path they
match; its axes (``model``, ``pipe``) name dims of the *flax* layout,
which ``param_spec`` maps to the torch dims through ``order`` as it does
the fsdp choice: ``P(None, "model")`` on a Dense kernel (in, out) splits
dim 0 of the (out, in) weight.  ``train.state.create_train_state`` keeps
each matched parameter as this rank's shard (``parallel.tensor``).
``pp_microbatches`` and ``pp_schedule`` pin the pipeline's schedule
(``parallel.pipeline``) on the plan, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
import warnings
from typing import Any, Iterator, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from tpuframe_torch.core.runtime import DATA_AXIS, FSDP_AXIS, Mesh, current_runtime

__all__ = ["ParallelPlan", "Rule", "flax_orders", "infer_shard_dim", "mesh_axes", "path_str",
           "spec_from_json", "spec_to_json"]

#: a spec: an axis name, a tuple of names, or None per dimension
Spec = tuple

#: a tensor-parallel rule: (regex over the flax parameter path, spec)
Rule = tuple[str, Spec]


def P(*entries) -> Spec:
    """A spec from its entries, as ``jax.sharding.PartitionSpec(*entries)``
    reads: ``P(None, "model")``."""
    return tuple(entries)


def spec_to_json(spec: Spec) -> list:
    """A spec as plain JSON, each entry None, a str, or a list of strs (the
    form checkpoint manifests and the plan's signature carry)."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def spec_from_json(entries: Sequence) -> Spec:
    """Inverse of :func:`spec_to_json`."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def to_torch_spec(spec: Spec, ndim: int, order: Sequence[int] | None) -> Spec:
    """A spec over the flax layout's dims as one over the torch dims:
    flax dim ``j`` is torch dim ``order[j]`` (identity without an order)."""
    if order is None or not spec:
        return tuple(spec)
    out: list = [None] * ndim
    for j, e in enumerate(spec):
        out[order[j]] = e
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def mesh_axes(mesh: Mesh) -> dict[str, int]:
    """``{axis_name: size}`` for a mesh: the manifest's topology key."""
    return {str(name): int(size) for name, size in mesh.shape.items()}


def host_memory_available(mesh: Mesh | None = None) -> bool:
    """Whether optimizer state can live in pinned host memory beside the
    device it is copied to: a CUDA runtime (the card has a host memory
    space).  The CPU has none to offload from, so an offload plan there
    downgrades with a warning, as on the JAX package's CPU backend."""
    del mesh
    try:
        return current_runtime(auto_init=False).platform == "gpu"
    except RuntimeError:
        return torch.cuda.is_available()


def path_str(path: Any) -> str:
    """Render a tree path as ``a/b/c``: a string as it is, else each key's
    ``key``, ``idx`` or ``name`` (as the JAX path keys carry them) or the
    key itself."""
    if isinstance(path, str):
        return path
    parts = []
    for key in path:
        if hasattr(key, "key"):
            parts.append(str(key.key))
        elif hasattr(key, "idx"):
            parts.append(str(key.idx))
        elif hasattr(key, "name"):
            parts.append(str(key.name))
        else:
            parts.append(str(key))
    return "/".join(parts)


def infer_shard_dim(shape: Sequence[int], axis_size: int, taken: Sequence[int] = (),
                    order: Sequence[int] | None = None) -> int | None:
    """The dimension to shard ``axis_size``-ways: the largest divisible one
    not already taken by another mesh axis (the first on a tie), None if
    nothing divides.  ``order`` (the dims of ``shape`` in flax order) makes
    the choice on the flax layout and returns the dim of ``shape``."""
    if order is not None:
        pos = {d: i for i, d in enumerate(order)}
        dim = infer_shard_dim([shape[d] for d in order], axis_size, [pos[t] for t in taken])
        return None if dim is None else int(order[dim])
    best = None
    for dim, size in enumerate(shape):
        if dim in taken or size % axis_size or size < axis_size:
            continue
        if best is None or size > shape[best]:
            best = dim
    return best


def flax_orders(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """For each parameter of ``model`` whose torch layout is not flax's,
    its dims in flax order (``models/interop.py``'s conversions): a conv
    weight OIHW is HWIO there, ``(2, 3, 1, 0)``; a linear weight (out, in)
    is an (in, out) kernel, ``(1, 0)``.  Embedding tables, norms, biases and
    plain parameters keep their layout and are not listed."""
    out: dict[str, tuple[int, ...]] = {}
    for mod_name, mod in model.named_modules():
        weight = getattr(mod, "weight", None)
        if not isinstance(weight, nn.Parameter):
            continue
        name = f"{mod_name}.weight" if mod_name else "weight"
        if isinstance(mod, nn.Conv2d) and weight.ndim == 4:
            out[name] = (2, 3, 1, 0)
        elif isinstance(mod, nn.Linear) and weight.ndim == 2:
            out[name] = (1, 0)
    return out


def _leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of a nested mapping of shaped leaves, ``a/b/c``."""
    if hasattr(tree, "shape"):
        yield "/".join(prefix), tree
        return
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Data-parallel and ZeRO policy over a
    :class:`~tpuframe_torch.core.runtime.Mesh` (module docstring).

    ``min_shard_elems`` keeps small leaves (biases, norm scales) whole.
    ``offload_optimizer`` keeps the sharded optimizer state in pinned host
    memory on the card (a warning and plain device state on the CPU).
    ``comms_groups`` and ``comms_fused`` pin the compressed sync's bucket
    groups and transport over the ``TPUFRAME_COMMS_*`` env knobs.
    ``rules`` are tensor-parallel rules (module docstring);
    ``pp_microbatches`` and ``pp_schedule`` pin the pipeline's microbatch
    count and schedule over ``TPUFRAME_PP_*``."""

    mesh: Mesh
    zero_stage: int = 0
    rules: Sequence[Any] = ()
    min_shard_elems: int = 2**14
    fsdp_axis: str = FSDP_AXIS
    data_axes: Sequence[str] = (DATA_AXIS, FSDP_AXIS)
    offload_optimizer: bool = False
    comms_groups: int | None = None
    comms_fused: bool | None = None
    pp_microbatches: int | None = None
    pp_schedule: str | None = None

    def __post_init__(self):
        from tpuframe_torch.parallel.comms_env import PP_SCHEDULE_CHOICES

        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {self.zero_stage}")
        if self.pp_microbatches is not None and self.pp_microbatches < 1:
            raise ValueError(
                f"pp_microbatches must be >= 1 (or None), got {self.pp_microbatches}")
        if self.pp_schedule is not None and self.pp_schedule not in PP_SCHEDULE_CHOICES:
            raise ValueError(f"pp_schedule must be one of {PP_SCHEDULE_CHOICES} (or None), "
                             f"got {self.pp_schedule!r}")
        if self.comms_groups is not None and self.comms_groups < 1:
            raise ValueError(f"comms_groups must be >= 1 (or None), got {self.comms_groups}")
        if self.comms_fused not in (None, True, False):
            raise ValueError(f"comms_fused must be a bool or None, got {self.comms_fused!r}")
        if self.offload_optimizer and not host_memory_available(self.mesh):
            warnings.warn(
                "offload_optimizer=True requested but this process runs on the CPU, which "
                "has no host memory space apart from its device; downgrading to plain "
                f"ZeRO-{self.zero_stage} (optimizer state stays with the device).",
                stacklevel=3)

    def _offload_active(self) -> bool:
        return self.offload_optimizer and host_memory_available(self.mesh)

    # -- identity / topology ----------------------------------------------
    def signature(self) -> str:
        """Stable short digest of the plan's policy and topology, the JAX
        package's digest for the same mesh and policy: the rules as
        :func:`spec_to_json`, the pipeline pins only where set."""
        payload = {
            "mesh": sorted(mesh_axes(self.mesh).items()),
            "zero_stage": self.zero_stage,
            "rules": [[pat, spec_to_json(spec)] for pat, spec in self.rules],
            "min_shard_elems": self.min_shard_elems,
            "fsdp_axis": self.fsdp_axis,
            "data_axes": list(self.data_axes),
            "offload": bool(self.offload_optimizer),
        }
        if self.comms_groups is not None and self.comms_groups != 1:
            payload["comms_groups"] = int(self.comms_groups)
        if self.comms_fused:
            payload["comms_fused"] = True
        if self.pp_microbatches is not None:
            payload["pp_microbatches"] = int(self.pp_microbatches)
        if self.pp_schedule is not None and self.pp_schedule != "interleaved":
            payload["pp_schedule"] = str(self.pp_schedule)
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def comms_schedule(self, config: Any = None) -> dict:
        """The compressed sync's schedule: bucket groups, fired in reverse
        bucket order (the reverse-backward leaf order); ``config`` (a
        ``CommsConfig``) supplies the env default where the plan pins
        nothing; the pipeline's schedule beside them."""
        groups = self.comms_groups
        if groups is None:
            groups = int(getattr(config, "groups", 1) or 1)
        fused = self.comms_fused
        if fused is None:
            fused = bool(getattr(config, "fused", False))
        return {
            "groups": int(groups),
            "order": "reverse_backward",
            "pinned": self.comms_groups is not None,
            "fused": bool(fused),
            "fused_pinned": self.comms_fused is not None,
            "pp_schedule": self.pp_schedule or "interleaved",
            "pp_pinned": self.pp_schedule is not None,
        }

    def describe_topology(self) -> dict:
        """The plan's topology as manifest-shaped JSON, the JAX dict."""
        axes = mesh_axes(self.mesh)
        return {
            "mesh_axes": axes,
            "world_size": int(self.mesh.devices.size),
            "plan_signature": self.signature(),
            "zero_stage": self.zero_stage,
            "pipeline_stages": int(axes.get("pipe", 1)),
            "tp_size": int(axes.get("model", 1)),
        }

    def rebind(self, mesh: Mesh) -> "ParallelPlan":
        """The same policy over another mesh, with one
        ``parallel/plan_rebind`` event, and a warning when an axis above 1
        collapses to 1 (ZeRO sharding vanishes when ``fsdp`` does, tensor
        parallelism when ``model`` does); the rules and pins carry over."""
        from tpuframe_torch.track.telemetry import get_telemetry

        old_axes, new_axes = mesh_axes(self.mesh), mesh_axes(mesh)
        new = dataclasses.replace(self, mesh=mesh)
        collapsed = sorted(a for a in old_axes
                           if old_axes.get(a, 1) > 1 and new_axes.get(a, 1) == 1)
        get_telemetry().event(
            "parallel/plan_rebind", from_axes=old_axes, to_axes=new_axes,
            from_world=int(self.mesh.devices.size), to_world=int(mesh.devices.size),
            collapsed=collapsed, signature=new.signature())
        if collapsed:
            warnings.warn(
                f"plan rebind collapsed mesh axis(es) {collapsed} to size 1 "
                f"({old_axes} -> {new_axes}): sharding over those axes is now inert (ZeRO "
                "partitions gather to every replica when fsdp collapses; TP rules naming a "
                "collapsed axis replicate). Re-check the memory budget fits the new world.",
                stacklevel=2)
        return new

    # -- axis helpers ------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    @property
    def dp_size(self) -> int:
        """Data-parallel ranks: the product of the data axes' sizes."""
        return math.prod(self.axis_size(a) for a in self.data_axes)

    @property
    def token_size(self) -> int:
        """The ranks a gradient is averaged over: the token group's size
        (``dp_size`` times ``seq``)."""
        return self.dp_size * self.axis_size("seq")

    @property
    def split_axes(self) -> tuple[str, ...]:
        """The axes above 1 that split the model rather than the batch:
        ``pipe`` and ``model``."""
        return tuple(a for a in ("pipe", "model") if self.axis_size(a) > 1)

    def check_world(self) -> int:
        """This plan's ``token_size`` (the ranks a gradient is averaged
        over); ``ValueError`` when the default process group's world size
        (1 without one) is not the mesh's size."""
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        size = int(self.mesh.devices.size)
        if world != size:
            raise ValueError(
                f"the plan's dp_size is {self.dp_size} (its mesh spans {size} ranks) but the "
                f"process group's world size is {world}: build the plan over the runtime's mesh "
                "(ParallelPlan(mesh=initialize().mesh)) in every process of the group")
        return self.token_size

    # -- batch -------------------------------------------------------------
    def batch_spec(self) -> Spec:
        """The batch's leading dim over every data axis above 1."""
        axes = tuple(a for a in self.data_axes if self.axis_size(a) > 1)
        if not axes:
            return ()
        return (axes if len(axes) > 1 else axes[0],)  # one axis by its name, as JAX's

    def shard_batch(self, batch: Mapping[str, Any], device: str | torch.device | None = None,
                    leading_microbatch: bool = False):
        """This process's local batch (numpy arrays or tensors) on its
        device: ``device``, else the runtime's.  Each process passes its own
        rows (the ``DataLoader`` shards them by process), grad-accum batches
        (``leading_microbatch``) with the microbatch dim first."""
        del leading_microbatch
        dev = torch.device(device) if device is not None else current_runtime().device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}

    # -- params ------------------------------------------------------------
    def _rule_spec(self, path: str) -> Spec | None:
        """The spec of the first rule whose regex matches ``path`` (a flax
        path ``a/b/c``), None where none does."""
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return tuple(spec)
        return None

    def _maybe_fsdp(self, shape: Sequence[int], base: Spec,
                    order: Sequence[int] | None = None) -> Spec:
        """Layer fsdp sharding onto ``base`` where the leaf is large enough
        and has a divisible dim (on its flax layout, given ``order``)."""
        size = self.axis_size(self.fsdp_axis)
        if size <= 1 or math.prod(shape) < self.min_shard_elems:
            return base
        named = {a for e in base if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        if self.fsdp_axis in named:
            return base
        entries = list(base) + [None] * (len(shape) - len(base))
        taken = [i for i, e in enumerate(entries) if e is not None]
        dim = infer_shard_dim(shape, size, taken, order)
        if dim is None:
            return base
        entries[dim] = self.fsdp_axis
        return tuple(entries)

    def param_spec(self, path: str, shape: Sequence[int],
                   order: Sequence[int] | None = None) -> Spec:
        """Where a parameter lives: split by its rule (the rule's flax dims
        mapped to the torch dims through ``order``), and (stage 3) over
        fsdp."""
        spec = to_torch_spec(self._rule_spec(path) or (), len(shape), order)
        if self.zero_stage == 3:
            spec = self._maybe_fsdp(shape, spec, order)
        return spec

    def _state_spec(self, path: str, shape: Sequence[int],
                    order: Sequence[int] | None = None) -> Spec:
        """Where a parameter's optimizer state lives: with the parameter,
        plus fsdp from stage 1 on."""
        spec = self._rule_spec(path) or ()
        spec = () if len(spec) > len(shape) else to_torch_spec(spec, len(shape), order)
        if self.zero_stage >= 1:
            spec = self._maybe_fsdp(shape, spec, order)
        return spec

    def update_shard_specs(self, params: Any,
                           orders: Mapping[str, Sequence[int]] | None = None
                           ) -> dict[str, tuple]:
        """The compressed step's weight-update sharding: for ZeRO stages
        1-3, every leaf of at least ``min_shard_elems`` elements with a dim
        divisible by the whole data-parallel world maps to ``{path: (dim,
        axes)}`` (the dim picked on the flax layout, ``orders`` by path);
        the rest stay whole."""
        axes = tuple(a for a in self.data_axes if self.axis_size(a) > 1)
        world = math.prod(self.axis_size(a) for a in axes) if axes else 1
        out: dict[str, tuple] = {}
        if world <= 1 or self.zero_stage not in (1, 2, 3):
            return out
        orders = orders or {}
        for path, leaf in _leaves(params):
            shape = tuple(int(d) for d in (getattr(leaf, "shape", ()) or ()))
            if not shape or math.prod(shape) < self.min_shard_elems:
                continue
            dim = infer_shard_dim(shape, world, order=orders.get(path))
            if dim is not None:
                out[path] = (dim, axes)
        return out

    def describe(self, params: Any, orders: Mapping[str, Sequence[int]] | None = None
                 ) -> dict[str, str]:
        """Human-readable spec per parameter path."""
        orders = orders or {}
        return {path: f"{tuple(leaf.shape)} -> "
                      f"{self.param_spec(path, tuple(leaf.shape), orders.get(path))}"
                for path, leaf in _leaves(params)}
