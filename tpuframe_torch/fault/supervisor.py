"""Restart orchestration: failure-classified budgets, jittered backoff,
pre-resume checkpoint validation, divergence rollback, elastic capacity.

Port of ``tpuframe/fault/supervisor.py``, name for name:

1. **Failure classes.**  A preemption restarts at once from its own
   budget; a divergence rolls back to the last healthy checkpoint and
   restarts perturbed (``fault.health.escalate_recovery``); infrastructure
   trouble (I/O, a lost worker, a ``RuntimeError`` such as torch's
   ``DistBackendError`` or ``torch.cuda.OutOfMemoryError``) retries with
   backoff; a code bug (``TypeError``, ``ValueError``...) never retries.
2. **Full-jitter backoff**: ``uniform(0, min(cap, base * 2^(n-1)))``.
3. **Pre-resume validation**: before every attempt, torn steps under the
   checkpoint directory and its ``_intra`` sibling are quarantined, so
   auto-resume lands on the newest committed step.
4. **Elastic**: with a ``capacity_probe`` the surviving world is probed
   before every attempt, a resize emits ``fault/world_resized`` and the
   attempt gets the new world size; below ``min_world_size`` the run gives
   up (:class:`WorldTooSmall`).

Events and counters are the JAX package's: ``fault/restart`` (failure
class, attempt, budget, delay, and ``compile_cache``: the persistent
compile cache's directory, enabled before the first attempt, so a restart
reads its compiles from disk), ``fault/giveup``, ``fault/world_resized``;
``fault/restarts``, ``fault/preemptions``, ``fault/divergences``.

Stdlib only.
"""

from __future__ import annotations

import enum
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from tpuframe_torch.fault import health as _health
from tpuframe_torch.fault.health import Divergence
from tpuframe_torch.fault.preempt import Preempted
from tpuframe_torch.track.telemetry import get_telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "FailureClass",
    "RestartPolicy",
    "Supervisor",
    "WorldTooSmall",
    "backoff_delay",
    "classify_failure",
    "run_supervised",
]


class WorldTooSmall(RuntimeError):
    """Surviving capacity fell below ``min_world_size``: the elastic giveup,
    apart from an exhausted budget."""


class FailureClass(enum.Enum):
    #: the platform reclaimed the machine: restart at once
    PREEMPTION = "preemption"
    #: the run went bad: roll back to the last healthy checkpoint, perturb
    DIVERGENCE = "divergence"
    #: transient infrastructure: back off and retry
    RETRYABLE = "retryable"
    #: a code bug: surface it
    FATAL = "fatal"


#: Exception types never worth retrying (bugs, not infrastructure).
FATAL_TYPES = (
    KeyboardInterrupt,
    SystemExit,
    TypeError,
    ValueError,
    AttributeError,
    NameError,
    ImportError,
)


def classify_failure(exc: BaseException) -> FailureClass:
    """:class:`Preempted` -> PREEMPTION, ``Divergence`` -> DIVERGENCE, the
    :data:`FATAL_TYPES` -> FATAL, everything else -> RETRYABLE."""
    if isinstance(exc, Preempted):
        return FailureClass.PREEMPTION
    if isinstance(exc, Divergence):
        return FailureClass.DIVERGENCE
    if isinstance(exc, FATAL_TYPES):
        return FailureClass.FATAL
    return FailureClass.RETRYABLE


def backoff_delay(attempt: int, *, base_s: float = 1.0, max_s: float = 60.0,
                  jitter: bool = True, rng: random.Random | None = None) -> float:
    """Full-jitter exponential backoff (attempt counts from 1):
    ``uniform(0, min(max_s, base_s * 2^(attempt-1)))``; ``jitter=False``
    returns the cap itself."""
    if attempt < 1:
        raise ValueError(f"attempt counts from 1, got {attempt}")
    cap = min(float(max_s), float(base_s) * (2.0 ** (attempt - 1)))
    if not jitter:
        return cap
    return (rng or random).uniform(0.0, cap)


@dataclass
class RestartPolicy:
    """Budgets and the backoff's shape.  ``max_restarts`` bounds RETRYABLE
    failures, ``max_preemptions`` PREEMPTION and ``max_divergences``
    DIVERGENCE; FATAL never retries.  ``seed`` seeds the jitter (None: not
    seeded, so that hosts' restarts stay decorrelated)."""

    max_restarts: int = 2
    max_preemptions: int = 16
    max_divergences: int = 2
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    jitter: bool = True
    seed: int | None = None
    _rng: random.Random = field(init=False, repr=False, default=None)

    def __post_init__(self):
        self._rng = random.Random(self.seed) if self.seed is not None else None

    def delay_s(self, retry_attempt: int) -> float:
        return backoff_delay(retry_attempt, base_s=self.backoff_base_s,
                             max_s=self.backoff_max_s, jitter=self.jitter, rng=self._rng)


class Supervisor:
    """Run a resumable fn under the restart policy.

    ``fn`` restores from its checkpointer on entry (the Trainer's
    auto-resume does), so a restart continues rather than recomputes.

    Args:
      policy: budgets and backoff (default :class:`RestartPolicy`).
      checkpoint_dir: validated before every attempt (torn steps
        quarantined, here and in its ``_intra`` sibling); a divergence
        rolls both back to their last healthy step.
      classifier: exception -> :class:`FailureClass`.
      on_restart: ``(attempt, error)`` hook, called before the backoff
        sleep, with one count across the classes.
      sleep: injectable for tests.
      capacity_probe: ``() -> int``, the world available now, probed before
        every attempt; ``fn`` is then called as ``fn(world_size)``.
      min_world_size: the elastic floor (:class:`WorldTooSmall` below it).
    """

    def __init__(self, policy: RestartPolicy | None = None, *,
                 checkpoint_dir: str | None = None,
                 classifier: Callable[[BaseException], FailureClass] | None = None,
                 on_restart: Callable[[int, BaseException], None] | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 capacity_probe: Callable[[], int] | None = None,
                 min_world_size: int = 1):
        self.policy = policy or RestartPolicy()
        self.checkpoint_dir = checkpoint_dir
        self.classifier = classifier or classify_failure
        self.on_restart = on_restart
        self.sleep = sleep
        self.retries = 0
        self.preemptions = 0
        self.divergences = 0
        if min_world_size < 1:
            raise ValueError(f"min_world_size must be >= 1, got {min_world_size}")
        self.capacity_probe = capacity_probe
        self.min_world_size = min_world_size
        #: the probed world size (None until the first probe, or without one)
        self.world_size: int | None = None

    # -- pre-resume validation ----------------------------------------------
    def validate_checkpoints(self) -> list[str]:
        """Quarantine torn steps under ``checkpoint_dir`` and its ``_intra``
        sibling; returns the quarantined paths."""
        if self.checkpoint_dir is None:
            return []
        from tpuframe_torch.ckpt.meta import quarantine_torn_steps

        moved: list[str] = []
        for d in (self.checkpoint_dir, str(self.checkpoint_dir) + "_intra"):
            moved += quarantine_torn_steps(d)
        return moved

    # -- compile warm-start --------------------------------------------------
    def _ensure_compile_cache(self) -> str | None:
        """Enable the persistent compile cache before the first attempt, so
        a restart reads from disk what it would recompile; its directory,
        or None (disabled, or torch not loaded: the supervisor itself
        imports no torch, and ``core.runtime.initialize`` enables the cache
        when the attempt loads it)."""
        import sys

        if "torch" not in sys.modules:
            return None
        try:
            from tpuframe_torch.compile import cache as compile_cache

            return compile_cache.enable_from_env()
        except Exception:
            return None  # a broken cache must not block recovery

    # -- elastic capacity ----------------------------------------------------
    def _probe_world(self) -> None:
        """Probe the surviving world before an attempt: one
        ``fault/world_resized`` event a resize, :class:`WorldTooSmall` below
        the floor (raised outside the retry block, so never retried)."""
        if self.capacity_probe is None:
            return
        n = int(self.capacity_probe())
        tele = get_telemetry()
        old = self.world_size
        if old is not None and n != old:
            tele.registry.counter("fault/world_resizes").inc()
            tele.event("fault/world_resized", from_world=old, to_world=n,
                       min_world_size=self.min_world_size,
                       attempt=self.retries + self.preemptions)
            logger.warning("world resized %d -> %d survivor(s); restarting at the smaller "
                           "world (floor: %d)", old, n, self.min_world_size)
        self.world_size = n
        if n < self.min_world_size:
            tele.event("fault/giveup", reason="min-world-size", world_size=n,
                       min_world_size=self.min_world_size)
            raise WorldTooSmall(
                f"surviving capacity {n} fell below min_world_size={self.min_world_size}; "
                "giving up rather than training on a world too small to be worth the "
                "schedule")

    # -- divergence rollback -------------------------------------------------
    def _divergence_recovery(self, error: BaseException | None = None) -> dict:
        """Escalate the recovery directive (with the raising Trainer's
        policy, carried by its ``Divergence``) and roll both checkpoint
        directories back to their last healthy committed step."""
        directive = _health.escalate_recovery(getattr(error, "policy", None))
        out: dict = {"lr_scale": round(directive.lr_scale, 6),
                     "skip_batches": directive.skip_batches}
        if self.checkpoint_dir is not None:
            from tpuframe_torch.ckpt.meta import rollback_to_last_healthy

            targets: list[int | None] = []
            for d in (self.checkpoint_dir, str(self.checkpoint_dir) + "_intra"):
                rb = rollback_to_last_healthy(d)
                targets.append(rb["to_step"])
                if rb["quarantined"]:
                    logger.warning("divergence rollback: quarantined step(s) %s under %s; "
                                   "resuming at %s", rb["quarantined"], d, rb["to_step"])
            landed = [t for t in targets if t is not None]
            out["rolled_back_to"] = max(landed) if landed else None
        return out

    # -- the loop ------------------------------------------------------------
    def run(self, fn: Callable[..., Any]) -> Any:
        tele = get_telemetry()
        compile_cache_dir = self._ensure_compile_cache()
        # an earlier run's escalations must not leak into this one
        _health.reset_recovery()
        while True:
            quarantined = self.validate_checkpoints()
            if quarantined:
                logger.warning("quarantined %d torn checkpoint step(s): %s",
                               len(quarantined), quarantined)
            self._probe_world()
            try:
                return fn(self.world_size) if self.capacity_probe else fn()
            except BaseException as e:
                cls = self.classifier(e)
                if cls is FailureClass.FATAL:
                    tele.event("fault/giveup", reason="fatal", error=repr(e)[:300])
                    raise
                rollback: dict | None = None
                if cls is FailureClass.DIVERGENCE:
                    self.divergences += 1
                    attempt, budget = self.divergences, self.policy.max_divergences
                    counter, delay = "fault/divergences", 0.0
                    if attempt <= budget:
                        rollback = self._divergence_recovery(e)
                elif cls is FailureClass.PREEMPTION:
                    self.preemptions += 1
                    attempt, budget = self.preemptions, self.policy.max_preemptions
                    counter, delay = "fault/preemptions", 0.0
                    # an in-process restart shares the watcher: consume the
                    # notice, or the next attempt re-preempts at its first step
                    from tpuframe_torch.fault.preempt import active_watcher

                    w = active_watcher()
                    if w is not None:
                        w.clear()
                else:
                    self.retries += 1
                    attempt, budget = self.retries, self.policy.max_restarts
                    counter = "fault/restarts"
                    delay = self.policy.delay_s(self.retries)
                if attempt > budget:
                    tele.event("fault/giveup", reason=f"{cls.value}-budget",
                               attempts=attempt - 1, budget=budget, error=repr(e)[:300])
                    raise
                tele.registry.counter(counter).inc()
                tele.event("fault/restart", failure_class=cls.value, attempt=attempt,
                           budget=budget, delay_s=round(delay, 3), error=repr(e)[:300],
                           compile_cache=compile_cache_dir,
                           **({"rollback": rollback} if rollback else {}))
                logger.warning("train fn failed (%s, class=%s); restart %d/%d after %.2fs",
                               repr(e), cls.value, attempt, budget, delay)
                if self.on_restart is not None:
                    self.on_restart(self.retries + self.preemptions + self.divergences, e)
                if delay > 0:
                    self.sleep(delay)


def run_supervised(fn: Callable[[], Any], *, policy: RestartPolicy | None = None,
                   checkpoint_dir: str | None = None, **kwargs: Any) -> Any:
    """``Supervisor(policy, checkpoint_dir=..., **kwargs).run(fn)``."""
    return Supervisor(policy, checkpoint_dir=checkpoint_dir, **kwargs).run(fn)
