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

The mesh names the data-parallel layout over the processes.  Only the
``data`` axis is ported: any other axis above 1 raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import torch
import torch.distributed as dist

__all__ = [
    "AXIS_ORDER",
    "DATA_AXIS",
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
]

PIPELINE_AXIS = "pipe"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"

AXIS_ORDER = (PIPELINE_AXIS, DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS, EXPERT_AXIS, MODEL_AXIS)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device raises when CUDA is absent.

    Only ``cuda`` and ``cpu`` devices are accepted."""
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


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``-1`` on at most one axis means "all remaining".

    The six axes of the JAX package; only ``data`` may exceed 1 in the
    port (the others come with their own slices)."""

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
        """The :class:`Mesh` over ``n_devices`` processes (one device each).
        Raises ``NotImplementedError`` for an axis other than ``data`` above
        1."""
        sizes = self.resolve(n_devices)
        beyond = {n: s for n, s in sizes.items() if n != DATA_AXIS and s > 1}
        if beyond:
            raise NotImplementedError(
                f"mesh axes {beyond}: the port has data parallelism only; ZeRO (fsdp), "
                "tensor, sequence, expert and pipeline axes come with later items of the "
                "data-parallel slice (ROADMAP.md, Queue 1)")
        return Mesh(sizes)

    @classmethod
    def from_config(cls, cfg: Mapping[str, int]) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: {sorted(known)}")
        return cls(**{k: int(v) for k, v in cfg.items()})


@dataclasses.dataclass(frozen=True)
class Runtime:
    """The device a process runs on, its platform (``gpu`` or ``cpu``), the
    mesh, and this process's place in the world."""

    device: torch.device
    platform: str
    mesh: Mesh
    process_index: int = 0
    process_count: int = 1

    @property
    def is_main(self) -> bool:
        return self.process_index == 0


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

    ``device`` defaults to ``cuda`` (``cuda:LOCAL_RANK`` when that is set).
    A process group that already exists is joined as it is; otherwise one
    is built when the env names a rendezvous (module docstring), with
    ``nccl`` on a CUDA device and ``gloo`` on the CPU.  ``backend``
    overrides that choice (two ranks on one card need ``gloo``: NCCL
    refuses them).  A world above 1 without a rendezvous, rank or size
    raises, as in the JAX package."""
    global _CURRENT, _OWNS_GROUP
    local = _env_int("LOCAL_RANK")
    if device is None and local is not None:
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
    _CURRENT = Runtime(device=dev, platform="gpu" if dev.type == "cuda" else "cpu",
                       mesh=spec.build(count), process_index=index,
                       process_count=count)
    return _CURRENT


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


def reset_runtime() -> None:
    """Drop the cached Runtime (tests, or a re-init with another mesh), as
    the JAX package's does.  The process group goes too, but only when
    :func:`initialize` built it: a group the caller made stays."""
    global _CURRENT, _OWNS_GROUP
    if _OWNS_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT, _OWNS_GROUP = None, False


def is_main_process() -> bool:
    """Rank-0 gate for logging and checkpoints: ``process_index() == 0``."""
    return process_index() == 0


def simulate_cpu_devices(n: int = 8) -> None:
    """The JAX package forces ``n`` virtual CPU devices here through an XLA
    flag; torch has no such flag, so this raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"simulate_cpu_devices({n}): torch has no virtual CPU devices. The port simulates "
        f"{n} devices as {n} gloo processes on the CPU (RANK/WORLD_SIZE with "
        "initialize(device='cpu')); the launcher that spawns them comes with the launch "
        "slice (ROADMAP.md, Queue 1 item 3)")


def process_index() -> int:
    """This process's rank: the runtime's, else the process group's, else 0."""
    if _CURRENT is not None:
        return _CURRENT.process_index
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size: the runtime's, else the process group's, else 1."""
    if _CURRENT is not None:
        return _CURRENT.process_count
    return dist.get_world_size() if dist.is_initialized() else 1
