"""The parallel plan: how the port lays a train step over its processes.

Port of ``tpuframe/parallel/sharding.py``'s ``ParallelPlan`` for stage-0
data parallelism: every process holds the whole model and optimizer state,
trains on its own share of the global batch, and the gradients are
averaged across the processes, either exactly (one all-reduce a bucket,
with BatchNorm statistics over the global batch, as JAX's GSPMD step) or
through the compressed wire (``parallel.compression``).  The data axis is
the default process group: a plan's ``dp_size`` must equal its world size
(:meth:`ParallelPlan.check_world`).  ZeRO stages 1-3, tensor parallel rules
and optimizer offload raise ``NotImplementedError``: they are later items
of the data-parallel slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from tpuframe_torch.core.runtime import DATA_AXIS, FSDP_AXIS, Mesh, current_runtime

__all__ = ["ParallelPlan"]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported; it comes with a later item of the data-parallel slice "
        "(ROADMAP.md, Queue 1)")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Data-parallel policy over a :class:`~tpuframe_torch.core.runtime.Mesh`.

    ``zero_stage`` 0 only (pure DP: the model and optimizer state
    replicated on every process, gradients averaged).  ``comms_groups`` and
    ``comms_fused`` pin the compressed sync's bucket groups and transport
    over the ``TPUFRAME_COMMS_*`` env knobs, as in the JAX package."""

    mesh: Mesh
    zero_stage: int = 0
    rules: Sequence[Any] = ()
    data_axes: Sequence[str] = (DATA_AXIS, FSDP_AXIS)
    comms_groups: int | None = None
    comms_fused: bool | None = None
    offload_optimizer: bool = False

    def __post_init__(self):
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {self.zero_stage}")
        if self.zero_stage:
            raise _later(f"ZeRO stage {self.zero_stage} (sharded optimizer state and "
                         "ZeRO-sliced gradient leaves)")
        if self.rules:
            raise _later("tensor-parallel rules")
        if self.offload_optimizer:
            raise _later("optimizer offload")
        if self.comms_groups is not None and self.comms_groups < 1:
            raise ValueError(f"comms_groups must be >= 1 (or None), got {self.comms_groups}")
        if self.comms_fused not in (None, True, False):
            raise ValueError(f"comms_fused must be a bool or None, got {self.comms_fused!r}")

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    @property
    def dp_size(self) -> int:
        """Data-parallel ranks: the product of the data axes' sizes."""
        return math.prod(self.axis_size(a) for a in self.data_axes)

    def check_world(self) -> int:
        """The world size of the default process group (1 without one);
        ``ValueError`` when it is not this plan's ``dp_size``."""
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if world != self.dp_size:
            raise ValueError(
                f"the plan's dp_size is {self.dp_size} but the process group's world size is "
                f"{world}: build the plan over the runtime's mesh (ParallelPlan(mesh="
                "initialize().mesh)) in every process of the group")
        return world

    def comms_schedule(self, config: Any = None) -> dict:
        """The compressed sync's schedule: bucket groups, fired in reverse
        bucket order (the reverse-backward leaf order); ``config`` (a
        ``CommsConfig``) supplies the env default where the plan pins
        nothing.  The pipeline keys of the JAX dict are kept at their
        defaults (no pipeline here)."""
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
            "pp_schedule": "interleaved",
            "pp_pinned": False,
        }

    def shard_batch(self, batch: Mapping[str, Any], device: str | torch.device | None = None):
        """This process's local batch (numpy arrays or tensors) on its
        device: ``device``, else the runtime's.  Each process passes its own
        rows (the ``DataLoader`` shards them by process)."""
        dev = torch.device(device) if device is not None else current_runtime().device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
