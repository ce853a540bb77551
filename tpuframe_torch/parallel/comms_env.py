"""The compressed gradient wire's configuration and its env knobs.

Port of ``tpuframe/parallel/comms_env.py`` (its ``CommsConfig`` and the
``TPUFRAME_COMMS_*`` knobs that config reads); the port keeps its own copy
rather than import the JAX package.

- ``TPUFRAME_COMMS_COMPRESSION``: ``int8`` / ``fp8`` (e4m3) / empty = off.
  ``Trainer(grad_compression=...)`` overrides it.
- ``TPUFRAME_COMMS_BUCKET_MB``: bucket size in MiB of float32 payload
  (default 4.0); each bucket has its own scale.
- ``TPUFRAME_COMMS_STOCHASTIC``: ``1`` rounds stochastically on the int8
  grid (fp8 always rounds to nearest even).
- ``TPUFRAME_COMMS_EF``: error feedback on/off (default on): each rank's
  quantization residual is carried in ``TrainState.comms`` and added to the
  next step's gradient.
- ``TPUFRAME_COMMS_GROUPS``: bucket groups of the sync (default 1), fired
  in reverse bucket order; ``ParallelPlan.comms_groups`` wins.
- ``TPUFRAME_COMMS_FUSED``: ``1`` asks for the in-collective transport;
  ``ParallelPlan.comms_fused`` wins.  Not ported: a transport that would
  be active (world >= 2) raises.

The JAX package's ``TPUFRAME_COMMS_FUSED_BLOCK`` (the Pallas kernels'
column block) has no meaning here and is not read: the CUDA kernels work
on the exact (buckets, elems) shape.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["COMMS_ENV_VARS", "COMPRESSION_MODES", "CommsConfig"]

#: the knobs this module reads
COMMS_ENV_VARS = (
    "TPUFRAME_COMMS_COMPRESSION",
    "TPUFRAME_COMMS_BUCKET_MB",
    "TPUFRAME_COMMS_STOCHASTIC",
    "TPUFRAME_COMMS_EF",
    "TPUFRAME_COMMS_GROUPS",
    "TPUFRAME_COMMS_FUSED",
)

#: wire formats the compressed collectives understand
COMPRESSION_MODES = ("int8", "fp8")

_FALSY = {"0", "false", "off", "no", ""}


def _env(name: str, default, parse):
    """A knob parsed by ``parse``; unset or malformed reads as ``default``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return parse(raw)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSY


@dataclasses.dataclass(frozen=True)
class CommsConfig:
    """Resolved wire-compression policy for the gradient collectives.

    ``mode`` is one of :data:`COMPRESSION_MODES`; construction validates it
    so a typo fails when the step is built, not mid-step."""

    mode: str = "int8"
    bucket_mb: float = 4.0
    stochastic_rounding: bool = False
    error_feedback: bool = True
    #: bucket-group count of the sync (1 = single shot); more groups than
    #: buckets clamps down at layout build
    groups: int = 1
    #: the in-collective transport (not ported: raises where it would engage)
    fused: bool = False

    def __post_init__(self):
        if self.mode not in COMPRESSION_MODES:
            raise ValueError(f"unknown grad_compression {self.mode!r}; known: "
                             + "/".join(COMPRESSION_MODES))
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")

    @property
    def bucket_elems(self) -> int:
        """Max float32 elements per transport bucket."""
        return max(64, int(self.bucket_mb * (1 << 20) / 4))

    @property
    def wire_bytes_per_elem(self) -> int:
        """Payload bytes per element in payload semantics (int8 and
        fp8-e4m3 are both one byte; the staged transport carries them in
        int32 or float32, see ``parallel.compression``)."""
        return 1

    @classmethod
    def from_env(cls, mode=None) -> "CommsConfig | None":
        """The env-resolved config; ``mode`` (a Trainer or step argument)
        overrides ``TPUFRAME_COMMS_COMPRESSION``, and a ``CommsConfig``
        passes through.  None = compression off.  Malformed numeric or
        boolean knobs read as their defaults; an unknown mode raises."""
        if mode is None:
            mode = os.environ.get("TPUFRAME_COMMS_COMPRESSION", "").strip()
        if isinstance(mode, CommsConfig):
            return mode
        if not mode:
            return None
        return cls(
            mode=str(mode).lower(),
            bucket_mb=_env("TPUFRAME_COMMS_BUCKET_MB", 4.0, float),
            stochastic_rounding=_env_bool("TPUFRAME_COMMS_STOCHASTIC", False),
            error_feedback=_env_bool("TPUFRAME_COMMS_EF", True),
            groups=max(1, _env("TPUFRAME_COMMS_GROUPS", 1, int)),
            fused=_env_bool("TPUFRAME_COMMS_FUSED", False),
        )

