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
  in reverse bucket order, each from the backward's gradient hooks once
  its gradients are final; ``ParallelPlan.comms_groups`` wins.
- ``TPUFRAME_COMMS_FUSED``: ``1`` asks for the in-collective transport
  (the narrow containers on the wire, in the form the process group's
  backend takes); ``ParallelPlan.comms_fused`` wins.
- ``TPUFRAME_PP_MICROBATCHES``: the pipeline's microbatch count where
  neither the plan nor the model pins one (:func:`pp_microbatches`, 0 =
  unset); ``ParallelPlan.pp_microbatches`` wins.
- ``TPUFRAME_PP_SCHEDULE``: the pipeline's schedule, one of
  :data:`PP_SCHEDULE_CHOICES` (:func:`pp_schedule`, default
  ``interleaved``); ``ParallelPlan.pp_schedule`` wins.
- ``TPUFRAME_TP_SIZE``: the ``model`` axis ``parallel.compose.compose``
  builds where the caller passes no ``tp=`` (:func:`tp_size`, default 1).
- ``TPUFRAME_ZERO_STAGE``: the ZeRO stage [0, 3] a plan takes where the
  caller passes none (:func:`zero_stage_default`, default 0).
- ``TPUFRAME_OFFLOAD_OPTIMIZER``: ``1`` defaults optimizer offload on
  (:func:`offload_optimizer_default`).

The JAX package's ``TPUFRAME_COMMS_FUSED_BLOCK`` (the Pallas kernels'
column block) has no meaning here and is not read: the CUDA kernels work
on the exact (buckets, elems) shape.  Nor is ``TPUFRAME_COMMS_ASYNC``
(XLA's async collective flags): the port's groups are issued
asynchronously from the gradient hooks.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["COMMS_ENV_DOMAINS", "COMMS_ENV_VARS", "COMPRESSION_MODES", "CommsConfig",
           "PP_SCHEDULE_CHOICES", "offload_optimizer_default", "pp_microbatches", "pp_schedule",
           "tp_size", "zero_stage_default"]

#: the knobs this module reads
COMMS_ENV_VARS = (
    "TPUFRAME_COMMS_COMPRESSION",
    "TPUFRAME_COMMS_BUCKET_MB",
    "TPUFRAME_COMMS_STOCHASTIC",
    "TPUFRAME_COMMS_EF",
    "TPUFRAME_COMMS_GROUPS",
    "TPUFRAME_COMMS_FUSED",
    "TPUFRAME_PP_MICROBATCHES",
    "TPUFRAME_PP_SCHEDULE",
    "TPUFRAME_TP_SIZE",
    "TPUFRAME_ZERO_STAGE",
    "TPUFRAME_OFFLOAD_OPTIMIZER",
)

#: value domains of the knobs above, the JAX table's rows for them
COMMS_ENV_DOMAINS = {
    "TPUFRAME_COMMS_COMPRESSION": {
        "type": "enum", "choices": ("", "int8", "fp8"), "apply": "restart"},
    "TPUFRAME_COMMS_BUCKET_MB": {"type": "float", "range": (0.25, 1024.0), "apply": "restart"},
    "TPUFRAME_COMMS_STOCHASTIC": {"type": "bool", "apply": "restart"},
    "TPUFRAME_COMMS_EF": {"type": "bool", "apply": "restart"},
    "TPUFRAME_COMMS_GROUPS": {"type": "int", "range": (1, 64), "apply": "restart"},
    "TPUFRAME_COMMS_FUSED": {"type": "bool", "apply": "restart"},
    "TPUFRAME_PP_MICROBATCHES": {"type": "int", "range": (0, 4096), "apply": "restart"},
    "TPUFRAME_PP_SCHEDULE": {
        "type": "enum", "choices": ("", "interleaved", "barriered", "1f1b"), "apply": "restart"},
    "TPUFRAME_TP_SIZE": {"type": "int", "range": (1, 64), "apply": "restart"},
    "TPUFRAME_ZERO_STAGE": {"type": "int", "range": (0, 3), "apply": "restart"},
    "TPUFRAME_OFFLOAD_OPTIMIZER": {"type": "bool", "apply": "restart"},
}

#: wire formats the compressed collectives understand
COMPRESSION_MODES = ("int8", "fp8")

#: the pipeline schedules (``parallel.pipeline.PP_SCHEDULES`` is this tuple)
PP_SCHEDULE_CHOICES = ("interleaved", "barriered", "1f1b")

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
    #: the in-collective transport (engages at world >= 2, fp8 up to world 73)
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



def zero_stage_default(environ: dict | None = None) -> int:
    """``TPUFRAME_ZERO_STAGE`` clamped to [0, 3] (default 0 = pure DP; a
    malformed value reads as 0)."""
    env = os.environ if environ is None else environ
    raw = str(env.get("TPUFRAME_ZERO_STAGE", "") or "").strip()
    try:
        val = int(raw) if raw else 0
    except ValueError:
        val = 0
    return max(0, min(3, val))


def offload_optimizer_default(environ: dict | None = None) -> bool:
    """``TPUFRAME_OFFLOAD_OPTIMIZER`` as a bool (default off); a plan still
    downgrades loudly where there is no host memory space."""
    env = os.environ if environ is None else environ
    raw = str(env.get("TPUFRAME_OFFLOAD_OPTIMIZER", "") or "").strip().lower()
    return raw not in _FALSY


def _env_int_clamped(env, name: str, default: int, lo: int, hi: int) -> int:
    raw = str(env.get(name, "") or "").strip()
    try:
        val = int(raw) if raw else default
    except ValueError:
        val = default
    return max(lo, min(hi, val))


def pp_microbatches(environ: dict | None = None) -> int:
    """``TPUFRAME_PP_MICROBATCHES`` clamped to [0, 4096]; 0 = unset (the
    model's ``n_microbatches`` default applies; a malformed value reads 0)."""
    return _env_int_clamped(os.environ if environ is None else environ,
                            "TPUFRAME_PP_MICROBATCHES", 0, 0, 4096)


def pp_schedule(environ: dict | None = None) -> str:
    """``TPUFRAME_PP_SCHEDULE`` if it names one of :data:`PP_SCHEDULE_CHOICES`,
    else ``interleaved`` (the pipeline itself validates a schedule passed in
    code)."""
    env = os.environ if environ is None else environ
    raw = str(env.get("TPUFRAME_PP_SCHEDULE", "") or "").strip().lower()
    return raw if raw in PP_SCHEDULE_CHOICES else "interleaved"


def tp_size(environ: dict | None = None) -> int:
    """``TPUFRAME_TP_SIZE`` clamped to [1, 64] (default 1: no tensor
    parallelism); ``compose`` reads it where no ``tp=`` is passed."""
    return _env_int_clamped(os.environ if environ is None else environ,
                            "TPUFRAME_TP_SIZE", 1, 1, 64)
