"""Where the port runs: the device, the process group and the mesh.

Port of ``tpuframe/core/runtime.py``.  Entry points run on ``cuda`` unless
the caller asks for ``device="cpu"`` (the tests do); without CUDA they
raise rather than carry on on the CPU.

One process drives one device.  :func:`initialize` reads the torchrun
contract (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) or the names the JAX package reads
(``TPUFRAME_PROCESS_ID``, ``TPUFRAME_NUM_PROCESSES``,
``TPUFRAME_COORDINATOR``), and builds a ``torch.distributed`` process
group when a rendezvous is named: ``nccl`` for a CUDA device, ``gloo`` for
the CPU.  ``TPUFRAME_COORDINATOR`` may also be an ``init_method`` URL
(``tcp://host:port``, ``file:///path``).  A failed ``nccl`` init raises; it
never gives way to gloo.

The mesh names the layout over the processes: the ``data`` and ``fsdp``
axes (ZeRO shards over ``fsdp``), ``pipe`` (pipeline stages), ``seq``
(sequence parallelism: a rank holds its run of L / n positions), ``expert``
(expert parallelism: a rank holds E / n experts) and ``model`` (tensor
parallelism).  ``seq`` or ``expert`` above 1 beside ``pipe`` or ``model``
above 1 raises (ROADMAP.md, Queue 1 item 7).  Ranks follow the JAX
package's device order, the grid reshaped in :data:`AXIS_ORDER`, so a
rank's coordinates are those of the JAX device with the same id in the
same ``MeshSpec``.  :func:`initialize` builds each axis's process groups
once (``Runtime.groups``), and those of the data plane (``"dp"``: ``data``
x ``fsdp``) and of the token group (``"tok"``: ``data`` x ``fsdp`` x
``seq``, the ranks that hold different tokens).

``TPUFRAME_SIMULATE_DEVICES`` is the one request for the CPU besides an
explicit ``device="cpu"``: the launcher sets it in its workers for
``Distributor(simulate_devices=1)`` (the JAX package's virtual CPU
devices), and :func:`resolve_device` then takes the CPU where no device is
named.  A value above 1 raises, as :func:`simulate_cpu_devices` does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXIS_ORDER",
    "DATA_AXIS",
    "SIMULATE_ENV",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshSpec",
    "PIPELINE_AXIS",
    "Runtime",
    "SEQUENCE_AXIS",
    "current_runtime",
    "initialize",
    "is_main_process",
    "process_count",
    "process_index",
    "reset_runtime",
    "resolve_device",
    "shutdown",
    "simulate_cpu_devices",
    "simulated_devices",
]

PIPELINE_AXIS = "pipe"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"

AXIS_ORDER = (PIPELINE_AXIS, DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS, EXPERT_AXIS, MODEL_AXIS)


#: the launcher's request for CPU workers (module docstring)
SIMULATE_ENV = "TPUFRAME_SIMULATE_DEVICES"


def check_simulated_devices(n: int) -> int:
    """``n`` simulated devices a process: 1 is the CPU; above 1 raises
    ``NotImplementedError``, as :func:`simulate_cpu_devices` does."""
    n = int(n)
    if n > 1:
        raise NotImplementedError(
            f"simulate_devices={n}: torch has no virtual CPU devices. The port simulates "
            f"{n} devices as {n} gloo processes of one CPU device each "
            f"(Distributor(num_processes={n}, simulate_devices=1))")
    if n < 1:
        raise ValueError(f"simulate_devices must be >= 1, got {n}")
    return n


def simulated_devices() -> int | None:
    """The launcher's request in ``TPUFRAME_SIMULATE_DEVICES`` (1), or None
    when it is unset or empty; any other value raises."""
    raw = os.environ.get(SIMULATE_ENV, "").strip()
    return check_simulated_devices(int(raw)) if raw else None


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (the CPU when the launcher asked for simulated
    devices, :data:`SIMULATE_ENV`); a CUDA device raises when CUDA is
    absent.

    Only ``cuda`` and ``cpu`` devices are accepted."""
    if device is None and simulated_devices():
        return torch.device("cpu")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected cuda or cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axis sizes over the world's processes, one device each: the
    port's counterpart of a ``jax.sharding.Mesh``.  ``shape`` maps every
    axis of :data:`AXIS_ORDER` to its size."""

    shape: Mapping[str, int]

    @property
    def devices(self) -> np.ndarray:
        """The ranks as the JAX mesh's device grid: ``arange(world)``
        reshaped in :data:`AXIS_ORDER`."""
        sizes = [int(self.shape.get(a, 1)) for a in AXIS_ORDER]
        return np.arange(math.prod(sizes)).reshape(sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s index along each axis of the grid."""
        where = np.argwhere(self.devices == rank)[0]
        return {a: int(i) for a, i in zip(AXIS_ORDER, where)}

    def lines(self, axis: str | tuple[str, ...]) -> list[list[int]]:
        """The rank groups along ``axis`` (or along several axes together):
        every line (plane) of the grid through it, in grid order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        grid = np.moveaxis(self.devices, [AXIS_ORDER.index(a) for a in axes],
                           list(range(-len(axes), 0)))
        size = math.prod(grid.shape[-len(axes):])
        return [list(map(int, row)) for row in grid.reshape(-1, size)]

    def local_slice(self, full: torch.Tensor, splits, rank: int | None = None
                    ) -> torch.Tensor:
        """``rank``'s (default: this process's) block of a whole tensor
        split along each ``(dim, axis)`` of ``splits``: a view."""
        at = self.coords(process_index() if rank is None else rank)
        for dim, name in splits:
            n = full.shape[dim] // int(self.shape[name])
            full = full.narrow(dim, at[name] * n, n)
        return full


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``-1`` on at most one axis means "all remaining".

    The six axes of the JAX package; ``seq`` or ``expert`` above 1 may not
    stand beside ``pipe`` or ``model`` above 1 in the port."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1

    def sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Concrete axis sizes for ``n_devices``, filling one ``-1`` axis."""
        sizes = self.sizes()
        bad = {n: s for n, s in sizes.items() if s != -1 and s < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be -1 or >= 1, got {bad}")
        wildcard = [name for name, size in sizes.items() if size == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices but {n_devices} are visible")
        return sizes

    def build(self, n_devices: int) -> Mesh:
        """The :class:`Mesh` over ``n_devices`` processes (one device each);
        ``n_devices`` may be a sequence (its length counts).  Raises
        ``NotImplementedError`` for ``seq`` or ``expert`` above 1 beside
        ``pipe`` or ``model`` above 1."""
        if not isinstance(n_devices, int):
            n_devices = len(n_devices)
        sizes = self.resolve(n_devices)
        sp_ep = {n: s for n, s in sizes.items() if n in (SEQUENCE_AXIS, EXPERT_AXIS) and s > 1}
        tp_pp = {n: s for n, s in sizes.items() if n in (PIPELINE_AXIS, MODEL_AXIS) and s > 1}
        if sp_ep and tp_pp:
            raise NotImplementedError(
                f"mesh axes {sp_ep} beside {tp_pp}: sequence and expert parallelism beside "
                "tensor and pipeline parallelism are not ported; they come with the rest of "
                "ROADMAP.md, Queue 1 item 7")
        return Mesh(sizes)

    @classmethod
    def from_config(cls, cfg: Mapping[str, int]) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: {sorted(known)}")
        return cls(**{k: int(v) for k, v in cfg.items()})

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> "MeshSpec":
        """The concrete spec of a built mesh (every axis fixed): the start
        of a spec over another world size (:meth:`shrink_to`)."""
        return cls.from_config({name: int(size) for name, size in mesh.shape.items()})

    def shrink_to(self, n_devices: int, *, elastic_axis: str = DATA_AXIS) -> "MeshSpec":
        """The spec for a smaller or larger world: ``elastic_axis`` (default
        ``data``) absorbs the change and every other axis keeps its size.
        Raises ``ValueError`` when the fixed axes no longer fit (a lost rank
        out of a TP or PP group cannot be absorbed by data parallelism)."""
        sizes = dict(self.sizes())
        wildcard = [n for n, s in sizes.items() if s == -1 and n != elastic_axis]
        if wildcard:
            raise ValueError(
                f"shrink_to needs a fully-resolved spec (use MeshSpec.from_mesh on the built "
                f"mesh); axis {wildcard} is still a wildcard")
        sizes[elastic_axis] = -1
        fixed = math.prod(s for n, s in sizes.items() if n != elastic_axis)
        if n_devices < 1 or n_devices % fixed:
            raise ValueError(
                f"cannot rebuild mesh for {n_devices} device(s): the fixed axes "
                f"{({n: s for n, s in sizes.items() if n != elastic_axis and s > 1})} need a "
                f"multiple of {fixed} — shrink in units of whole {elastic_axis}-groups or "
                "lower min_world_size no further")
        return MeshSpec.from_config(sizes)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """The device a process runs on, its platform (``gpu`` or ``cpu``), the
    mesh, this process's place in the world, and its process group along
    each mesh axis above 1 (None where the axis spans every rank: the
    default group)."""

    device: torch.device
    platform: str
    mesh: Mesh
    process_index: int = 0
    process_count: int = 1
    groups: Mapping[str, object] = dataclasses.field(default_factory=dict)

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    @property
    def data_index(self) -> int:
        """This process's data shard: its index over the ``data`` and
        ``fsdp`` axes (the batch's split); the ranks along ``pipe``,
        ``seq``, ``expert`` and ``model`` share it."""
        c = self.mesh.coords(self.process_index)
        return c[DATA_AXIS] * int(self.mesh.shape.get(FSDP_AXIS, 1)) + c[FSDP_AXIS]

    @property
    def data_count(self) -> int:
        """The data shards: the ``data`` axis times the ``fsdp`` axis."""
        return int(self.mesh.shape.get(DATA_AXIS, 1)) * int(self.mesh.shape.get(FSDP_AXIS, 1))


_CURRENT: Runtime | None = None
#: whether :func:`initialize` built the default process group (and so
#: :func:`reset_runtime` may destroy it)
_OWNS_GROUP = False


def _env_int(*names: str) -> int | None:
    for name in names:
        value = os.environ.get(name)
        if value is not None and value.strip():
            return int(value)
    return None


def _env_coordinator() -> str | None:
    addr = os.environ.get("TPUFRAME_COORDINATOR")
    if addr:
        return addr
    host = os.environ.get("MASTER_ADDR")
    if host:
        return f"{host}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def initialize(mesh: MeshSpec | Mapping[str, int] | None = None, *,
               device: str | torch.device | None = None,
               backend: str | None = None) -> Runtime:
    """Resolve the device, join the process group, and build the mesh.

    ``device`` defaults to ``cuda`` (``cuda:LOCAL_RANK`` when that is set),
    or the CPU when the launcher asked for simulated devices.  When a
    host's local ranks (``LOCAL_WORLD_SIZE``) outnumber its cards, rank
    ``LOCAL_RANK`` takes card ``LOCAL_RANK % cards`` and the group is
    ``gloo`` (NCCL refuses two ranks on one device).
    A process group that already exists is joined as it is; otherwise one
    is built when the env names a rendezvous (module docstring), with
    ``nccl`` on a CUDA device and ``gloo`` on the CPU.  ``backend``
    overrides that choice (two ranks on one card need ``gloo``: NCCL
    refuses them).  A world above 1 without a rendezvous, rank or size
    raises, as in the JAX package."""
    global _CURRENT, _OWNS_GROUP
    # the persistent compile cache before any other work (off with
    # TPUFRAME_COMPILE_CACHE=0): every process that initializes a runtime
    # compiles against the same host-shared cache
    from tpuframe_torch.compile import cache as _compile_cache

    _compile_cache.enable_from_env()
    local = _env_int("LOCAL_RANK")
    if device is None and local is not None and not simulated_devices():
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards and (_env_int("LOCAL_WORLD_SIZE") or 1) > cards:
            local %= cards
            backend = backend or "gloo"
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        coordinator = _env_coordinator()
        world = _env_int("TPUFRAME_NUM_PROCESSES", "WORLD_SIZE")
        rank = _env_int("TPUFRAME_PROCESS_ID", "RANK")
        if (world or 1) > 1 or (coordinator and world is not None):
            if not coordinator or world is None or rank is None:
                raise ValueError(
                    "a multi-process init needs a rendezvous, a world size and a rank "
                    f"(got coordinator={coordinator!r}, world={world!r}, rank={rank!r}); "
                    "set MASTER_ADDR/MASTER_PORT (or TPUFRAME_COORDINATOR), WORLD_SIZE and RANK")
            backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
            kw = {"device_id": dev} if backend == "nccl" else {}
            method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
            # nccl with device_id connects its communicator here, so a
            # failed init raises from this call
            dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                                    **kw)
            _OWNS_GROUP = True
    if dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    if isinstance(mesh, Mapping):
        mesh = MeshSpec.from_config(mesh)
    spec = mesh or MeshSpec()
    built = spec.build(count)
    _CURRENT = Runtime(device=dev, platform="gpu" if dev.type == "cuda" else "cpu",
                       mesh=built, process_index=index, process_count=count,
                       groups=_axis_groups(built, index, count))
    return _CURRENT


#: the planes with a group of their own beside the axes: key -> axes
PLANES = {"dp": (DATA_AXIS, FSDP_AXIS), "tok": (DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS)}


def _axis_groups(mesh: Mesh, rank: int, world: int) -> dict[str, object]:
    """This rank's process group along each axis above 1, along the data
    plane (``data`` x ``fsdp``, key ``"dp"``) and along the token group
    (``data`` x ``fsdp`` x ``seq``, key ``"tok"``: the ranks that hold
    different tokens, which a gradient is averaged over) where a plane is
    not one axis or another plane already; every line's group built by
    every rank in one order (``dist.new_group`` is collective); a line over
    the whole world takes the default group."""
    groups: dict[str, object] = {}
    if not dist.is_initialized():
        return groups
    by_axes: dict[tuple, str] = {}
    for axis in AXIS_ORDER + tuple(PLANES):
        axes = PLANES.get(axis, (axis,))
        size = math.prod(int(mesh.shape.get(a, 1)) for a in axes)
        if size <= 1:
            continue
        above = tuple(a for a in axes if int(mesh.shape.get(a, 1)) > 1)
        if above in by_axes:  # the same ranks as a group built already
            groups[axis] = groups[by_axes[above]]
            continue
        by_axes[above] = axis
        if size == world:
            groups[axis] = None
            continue
        for line in mesh.lines(axes):
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return groups


#: process groups of meshes other than the runtime's: (world group, axes) -> groups
_GROUPS: dict = {}


def groups_for(mesh: Mesh) -> Mapping[str, object]:
    """The process groups of ``mesh``'s axes for this rank
    (:func:`_axis_groups`): the runtime's own where ``mesh`` has its
    shape, else built once per shape (collective: every rank calls this
    with the same mesh the first time, as ``create_train_state`` does)."""
    if _CURRENT is not None and dict(_CURRENT.mesh.shape) == dict(mesh.shape):
        return _CURRENT.groups
    key = (id(dist.group.WORLD) if dist.is_initialized() else None,
           tuple(sorted(mesh.shape.items())))
    if key not in _GROUPS:
        _GROUPS[key] = _axis_groups(mesh, process_index(), process_count())
    return _GROUPS[key]


def current_runtime(auto_init: bool = True, *,
                    device: str | torch.device | None = None) -> Runtime:
    """The active Runtime; without one, :func:`initialize` on ``device``
    (default ``cuda``) when ``auto_init``, else RuntimeError."""
    if _CURRENT is None:
        if not auto_init:
            raise RuntimeError("tpuframe_torch runtime not initialized; call core.initialize()")
        initialize(device=device)
    return _CURRENT


def shutdown() -> None:
    """Destroy the default process group (when there is one) and forget
    the runtime."""
    global _CURRENT, _OWNS_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT, _OWNS_GROUP = None, False
    _GROUPS.clear()


def reset_runtime() -> None:
    """Drop the cached Runtime (tests, or a re-init with another mesh), as
    the JAX package's does.  The process group goes too, but only when
    :func:`initialize` built it: a group the caller made stays."""
    global _CURRENT, _OWNS_GROUP
    if _OWNS_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT, _OWNS_GROUP = None, False
    _GROUPS.clear()


def is_main_process() -> bool:
    """Rank-0 gate for logging and checkpoints: ``process_index() == 0``."""
    return process_index() == 0


def simulate_cpu_devices(n: int = 8) -> None:
    """The JAX package forces ``n`` virtual CPU devices here through an XLA
    flag; torch has no such flag, so this raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"simulate_cpu_devices({n}): torch has no virtual CPU devices. The port simulates "
        f"{n} devices as {n} gloo processes on the CPU: "
        f"launch.Distributor(num_processes={n}, simulate_devices=1)")


def process_index() -> int:
    """This process's rank: the runtime's, else the process group's, else 0."""
    if _CURRENT is not None:
        return _CURRENT.process_index
    return dist.get_rank() if dist.is_initialized() else 0


def data_shard() -> tuple[int, int]:
    """``(index, count)`` of this process's share of the batch: the
    runtime's data shard (ranks along ``pipe``, ``seq``, ``expert`` and
    ``model`` share one),
    else the process group's rank and size, else ``(0, 1)``."""
    if _CURRENT is not None:
        return _CURRENT.data_index, _CURRENT.data_count
    return process_index(), process_count()


def process_count() -> int:
    """The world size: the runtime's, else the process group's, else 1."""
    if _CURRENT is not None:
        return _CURRENT.process_count
    return dist.get_world_size() if dist.is_initialized() else 1
