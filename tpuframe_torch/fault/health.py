"""Training-health sentinel: non-finite and loss-spike detection, skip-step.

The port's copy of the parts of ``tpuframe/fault/health.py`` the training
path uses, with the same knobs, field order and semantics:

1. **Detect, on the device.**  :func:`health_verdict` takes one fused sum
   of squares over the gradients (``torch._foreach_norm``), the loss
   finiteness and the EWMA spike test against the device-carried
   :func:`init_health_state`, and returns the verdict as a device bool —
   no host sync per step.
2. **Skip-step.**  The train step applies no update on a bad step
   (``tpuframe_torch.train.step``); the verdict rides the step's metrics
   as the packed ``health_stats`` vector the Trainer reads once per
   window.
3. **Divergence.**  ``max_bad`` bad steps inside a ``window`` raise
   :class:`Divergence`.

4. **Stamp.**  :func:`health_stamp` is the JSON health record a
   checkpoint carries beside its topology manifest, which rollback
   (``ckpt.meta.rollback_to_last_healthy``) selects on.

5. **Recover.**  :func:`escalate_recovery` (the supervisor, once a
   divergence) compounds the LR backoff and arms the data-order skip in
   the process-wide :class:`RecoveryDirective`; the next Trainer reads
   :func:`recovery_directive` and :func:`consume_skip_batches`.

The module imports torch only inside the device-side helpers.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Any, Mapping, Sequence

__all__ = [
    "Divergence",
    "HEALTH_ENV_VARS",
    "HEALTH_STATS_FIELDS",
    "HealthPolicy",
    "RecoveryDirective",
    "consume_skip_batches",
    "enabled_by_env",
    "escalate_recovery",
    "health_stamp",
    "health_verdict",
    "init_health_state",
    "recovery_directive",
    "reset_recovery",
    "resolve_policy",
    "unpack_health_stats",
]

_FALSY = ("0", "false", "no", "off", "disabled")

#: every env knob the health sentinel and its satellites read (the data
#: loader's bad-sample cap, the checkpoint's save retries), as the JAX
#: package lists them
HEALTH_ENV_VARS = (
    "TPUFRAME_HEALTH",
    "TPUFRAME_HEALTH_SPIKE_FACTOR",
    "TPUFRAME_HEALTH_SPIKE_MARGIN",
    "TPUFRAME_HEALTH_EWMA_DECAY",
    "TPUFRAME_HEALTH_WARMUP_STEPS",
    "TPUFRAME_HEALTH_WINDOW",
    "TPUFRAME_HEALTH_MAX_BAD",
    "TPUFRAME_HEALTH_LR_BACKOFF",
    "TPUFRAME_HEALTH_SKIP_BATCHES",
    "TPUFRAME_MAX_BAD_SAMPLES",
    "TPUFRAME_CKPT_SAVE_RETRIES",
)


def _env_float(name: str, default: float) -> float:
    """Float env knob; unset, empty or malformed reads as ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


class Divergence(RuntimeError):
    """Training diverged: ``bad_in_window`` skipped steps inside the health
    window, so skip-step alone is no longer converging."""

    def __init__(self, msg: str, *, step: int | None = None,
                 bad_in_window: int | None = None, window: int | None = None,
                 loss_ewma: float | None = None,
                 policy: "HealthPolicy | None" = None):
        super().__init__(msg)
        self.step = step
        self.bad_in_window = bad_in_window
        self.window = window
        self.loss_ewma = loss_ewma
        self.policy = policy


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Sentinel thresholds, as in the JAX package.

    A finite loss is a spike when ``loss > ewma * spike_factor +
    spike_margin`` once ``warmup_steps`` good steps have passed; the EWMA
    moves by ``ewma_decay`` on good steps only.  ``max_bad`` bad steps in a
    ``window``-step window raise :class:`Divergence`; the window is also
    the host's read cadence of the verdict.  ``lr_backoff`` and
    ``skip_batches`` shape the supervisor's recovery (fault plane).
    """

    spike_factor: float = 4.0
    spike_margin: float = 0.05
    ewma_decay: float = 0.98
    warmup_steps: int = 20
    window: int = 16
    max_bad: int = 4
    lr_backoff: float = 0.5
    skip_batches: int = 0

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.max_bad < 1:
            raise ValueError(f"max_bad must be >= 1, got {self.max_bad}")
        if not 0.0 < self.ewma_decay < 1.0:
            raise ValueError(f"ewma_decay must be in (0, 1), got {self.ewma_decay}")

    @classmethod
    def from_env(cls) -> "HealthPolicy":
        """Defaults overridden by the ``TPUFRAME_HEALTH_*`` knobs."""
        return cls(
            spike_factor=_env_float("TPUFRAME_HEALTH_SPIKE_FACTOR", 4.0),
            spike_margin=_env_float("TPUFRAME_HEALTH_SPIKE_MARGIN", 0.05),
            ewma_decay=_env_float("TPUFRAME_HEALTH_EWMA_DECAY", 0.98),
            warmup_steps=_env_int("TPUFRAME_HEALTH_WARMUP_STEPS", 20),
            window=_env_int("TPUFRAME_HEALTH_WINDOW", 16),
            max_bad=_env_int("TPUFRAME_HEALTH_MAX_BAD", 4),
            lr_backoff=_env_float("TPUFRAME_HEALTH_LR_BACKOFF", 0.5),
            skip_batches=_env_int("TPUFRAME_HEALTH_SKIP_BATCHES", 0),
        )


def enabled_by_env() -> bool:
    """The sentinel default: on unless ``TPUFRAME_HEALTH`` is falsy."""
    v = os.environ.get("TPUFRAME_HEALTH", "").strip().lower()
    return not v or v not in _FALSY


def resolve_policy(health: Any) -> HealthPolicy | None:
    """``None`` follows ``TPUFRAME_HEALTH`` (default on), ``True`` forces
    env defaults, ``False`` disables, a :class:`HealthPolicy` is used
    as-is."""
    if health is False:
        return None
    if isinstance(health, HealthPolicy):
        return health
    if health is True:
        return HealthPolicy.from_env()
    if health is None:
        return HealthPolicy.from_env() if enabled_by_env() else None
    raise ValueError(
        "health must be None (follow TPUFRAME_HEALTH), True, False, or a "
        f"HealthPolicy; got {type(health).__name__}"
    )


#: field order of the packed ``health_stats`` metrics vector
HEALTH_STATS_FIELDS = (
    "health_bad",
    "health_nonfinite",
    "health_spike",
    "grad_norm_sum",
    "health_steps",
)


def unpack_health_stats(vec) -> dict:
    """Split a (summed) ``health_stats`` vector into named floats."""
    vals = [float(v) for v in vec]
    return dict(zip(HEALTH_STATS_FIELDS, vals))


def init_health_state(device=None) -> dict:
    """The device-carried sentinel state: float32 scalars ``loss_ewma``,
    ``good_steps``, ``bad_steps``, ``last_bad_step`` (-1 = never) and
    ``grad_norm``."""
    import torch

    def scalar(v: float):
        return torch.full((), v, dtype=torch.float32, device=device)

    return {
        "loss_ewma": scalar(0.0),
        "good_steps": scalar(0.0),
        "bad_steps": scalar(0.0),
        "last_bad_step": scalar(-1.0),
        "grad_norm": scalar(0.0),
    }


def health_verdict(loss, grads: Sequence, hstate: Mapping[str, Any], step: int,
                   policy: HealthPolicy, grad_sq=None):
    """The per-step check, on the device.

    ``loss`` is the scalar step loss, ``grads`` the gradient tensors;
    ``grad_sq`` (their summed squares, the plan-global value under ZeRO)
    stands in for them when given.  ``step`` is an int, or a device scalar
    while a CUDA graph captures the step.
    Returns ``(bad, new_hstate, metrics)``: ``bad`` a 0-d bool tensor,
    ``new_hstate`` the advanced sentinel state (EWMA moved on good steps
    only), and ``metrics`` ``{"health_stats": vector}`` in
    :data:`HEALTH_STATS_FIELDS` order."""
    import torch

    loss = loss.detach().to(torch.float32)
    grads = [g.detach() for g in grads if g is not None]
    if grad_sq is not None:
        grad_sq = grad_sq.to(torch.float32)
    elif grads:
        norms = torch._foreach_norm(grads)  # one fused pass over the gradients
        grad_sq = torch.stack([n.float() for n in norms]).square().sum()
    else:
        grad_sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    grad_norm = grad_sq.sqrt()
    finite = torch.isfinite(loss) & torch.isfinite(grad_sq)
    warmed = hstate["good_steps"] >= policy.warmup_steps
    spike = finite & warmed & (
        loss > hstate["loss_ewma"] * policy.spike_factor + policy.spike_margin)
    bad = ~finite | spike
    good = ~bad
    d = policy.ewma_decay
    seeded = torch.where(hstate["good_steps"] > 0, hstate["loss_ewma"], loss)
    new_ewma = torch.where(good, d * seeded + (1.0 - d) * loss, hstate["loss_ewma"])
    f32 = torch.float32
    new_hstate = {
        "loss_ewma": new_ewma,
        "good_steps": hstate["good_steps"] + good.to(f32),
        "bad_steps": hstate["bad_steps"] + bad.to(f32),
        "last_bad_step": torch.where(
            bad, (step.to(f32) if torch.is_tensor(step)
                  else torch.full_like(hstate["last_bad_step"], float(step))),
            hstate["last_bad_step"]),
        "grad_norm": grad_norm,
    }
    stats = torch.stack([
        bad.to(f32),
        (~finite).to(f32),
        spike.to(f32),
        torch.where(finite, grad_norm, torch.zeros_like(grad_norm)),
        torch.ones_like(grad_norm),
    ])
    return bad, new_hstate, {"health_stats": stats}


def health_stamp(hstate: Mapping[str, Any], step: int, policy: HealthPolicy) -> dict:
    """The JSON health record :meth:`~tpuframe_torch.ckpt.Checkpointer.save`
    embeds next to the topology manifest, read back by
    ``ckpt.meta.read_health`` (the counterpart of the JAX package's
    ``fault.health.health_stamp``).  ``hstate`` holds host numbers (or
    0-d tensors).  ``healthy`` means the newest bad step is at least one
    full check window behind this save, or there never was one."""
    def _f(v) -> float | None:
        v = float(v)
        return v if math.isfinite(v) else None

    last_bad = float(hstate["last_bad_step"])
    healthy = last_bad < 0 or (step - last_bad) > policy.window
    return {
        "healthy": bool(healthy),
        "step": int(step),
        "loss_ewma": _f(hstate["loss_ewma"]),
        "grad_norm": _f(hstate["grad_norm"]),
        "bad_steps": int(float(hstate["bad_steps"])),
        "last_bad_step": int(last_bad),
        "window": policy.window,
    }


# -- divergence recovery directive (process-wide) -----------------------------


@dataclasses.dataclass
class RecoveryDirective:
    """What the next supervised attempt applies after a divergence rollback:
    ``lr_scale`` multiplies the LR schedule (``lr_backoff ** n``),
    ``skip_batches`` advances the restored loader position past the poison
    window, ``divergences`` counts escalations since :func:`reset_recovery`."""

    lr_scale: float = 1.0
    skip_batches: int = 0
    divergences: int = 0


_DIRECTIVE = RecoveryDirective()
_DIRECTIVE_LOCK = threading.Lock()


def recovery_directive() -> RecoveryDirective:
    """The current directive (a copy)."""
    with _DIRECTIVE_LOCK:
        return dataclasses.replace(_DIRECTIVE)


def reset_recovery() -> None:
    """Clear the directive (the supervisor does this when a run starts)."""
    global _DIRECTIVE
    with _DIRECTIVE_LOCK:
        _DIRECTIVE = RecoveryDirective()


def consume_skip_batches() -> int:
    """One-shot read of the data-order skip, cleared on a non-zero read:
    only the first fit after a rollback skips the poison window.
    ``lr_scale`` stays for the rest of the run."""
    global _DIRECTIVE
    with _DIRECTIVE_LOCK:
        n = _DIRECTIVE.skip_batches
        if n:
            _DIRECTIVE = dataclasses.replace(_DIRECTIVE, skip_batches=0)
        return n


def escalate_recovery(policy: HealthPolicy | None = None) -> RecoveryDirective:
    """One divergence happened: compound the LR backoff and (re)arm the skip
    per ``policy`` (default: the env knobs); one
    ``health/recovery_directive`` event."""
    policy = policy or HealthPolicy.from_env()
    global _DIRECTIVE
    with _DIRECTIVE_LOCK:
        _DIRECTIVE = RecoveryDirective(
            lr_scale=_DIRECTIVE.lr_scale * policy.lr_backoff,
            skip_batches=policy.skip_batches,
            divergences=_DIRECTIVE.divergences + 1,
        )
        out = dataclasses.replace(_DIRECTIVE)
    from tpuframe_torch.track.telemetry import get_telemetry

    get_telemetry().event("health/recovery_directive", lr_scale=round(out.lr_scale, 6),
                          skip_batches=out.skip_batches, divergences=out.divergences)
    return out
