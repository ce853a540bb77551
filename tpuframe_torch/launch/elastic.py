"""Elastic recovery: checkpoint-resume restart loops that may shrink the world.

Port of ``tpuframe/launch/elastic.py``, name for name:

- :func:`run_with_restarts`: the equal-capacity restart loop, a front for
  :class:`~tpuframe_torch.fault.Supervisor` (classified budgets, jittered
  backoff, pre-resume quarantine of torn steps).
- :func:`run_elastic`: shrink-to-survivors supervision.  Before every
  attempt the supervisor probes the surviving world; after a shrink the
  mesh is rebuilt for it (``MeshSpec.shrink_to``), the plan rebound
  (``ParallelPlan.rebind``), and the train fn gets an
  :class:`ElasticContext` whose plan restores checkpoints with reshard.
  :func:`rederive_batch_split` keeps the global batch across the resize.

The port's ranks are processes, where the JAX package's simulated ranks
are devices of one process.  So ``run_elastic`` runs in the launching
process, and each attempt's ``train_fn(ctx)`` starts a launcher over
``ctx.world_size`` workers and ``ctx.plan`` (the port's ``Mesh`` is a
logical grid and pickles).  A :class:`~tpuframe_torch.fault.LoseRank`
fired in a worker registers its ranks in that worker only; the launcher
surfaces the worker's :class:`~tpuframe_torch.fault.RankLostError` (it
carries ``ranks``) or a :class:`~tpuframe_torch.launch.WorkerLostError`
(``rank``), and ``run_elastic`` registers those ranks in this process's
lost set before the next probe, and takes them out again when it returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from tpuframe_torch.fault import chaos
from tpuframe_torch.fault.supervisor import (
    FailureClass,
    RestartPolicy,
    Supervisor,
    classify_failure,
)
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "ElasticContext",
    "rederive_batch_split",
    "run_elastic",
    "run_with_restarts",
    "simulated_survivor_probe",
]


def run_with_restarts(
    fn: Callable[[], Any],
    *,
    max_restarts: int = 2,
    backoff_s: float = 1.0,
    retryable: Callable[[BaseException], bool] | None = None,
    on_restart: Callable[[int, BaseException], None] | None = None,
    max_preemptions: int | None = None,
    backoff_max_s: float = 60.0,
    checkpoint_dir: str | None = None,
) -> Any:
    """Run ``fn`` until it succeeds or a budget runs out.

    ``fn`` must resume from its checkpointer on entry.  Failures are
    classified (``fault.supervisor.classify_failure``); ``retryable``
    overrides the infrastructure-or-bug split of the non-preemption ones.
    Retries back off with full jitter from ``backoff_s`` up to
    ``backoff_max_s``; preemptions restart at once from their own
    ``max_preemptions`` budget.  ``on_restart(attempt, error)`` observes;
    ``checkpoint_dir`` turns on the pre-resume quarantine of torn steps.
    """
    classifier = None
    if retryable is not None:
        def classifier(e: BaseException) -> FailureClass:
            cls = classify_failure(e)
            if cls is FailureClass.PREEMPTION:
                return cls
            return FailureClass.RETRYABLE if retryable(e) else FailureClass.FATAL

    policy = RestartPolicy(max_restarts=max_restarts, backoff_base_s=backoff_s,
                           backoff_max_s=backoff_max_s)
    if max_preemptions is not None:
        policy.max_preemptions = max_preemptions
    return Supervisor(policy, checkpoint_dir=checkpoint_dir, classifier=classifier,
                      on_restart=on_restart).run(fn)


# -- topology-shifting supervision (shrink to survivors) ----------------------


@dataclasses.dataclass(frozen=True)
class ElasticContext:
    """One supervised attempt's world.  ``plan`` is the plan to train under
    in this attempt: the original at full capacity, the rebound one over
    the survivors' mesh after a shrink."""

    attempt: int
    world_size: int
    initial_world_size: int
    plan: Any
    #: True when this attempt runs on another world than the original
    resized: bool

    @property
    def mesh(self):
        return self.plan.mesh


def simulated_survivor_probe(initial_world: int) -> Callable[[], int]:
    """Capacity probe for chaos runs: the original world minus the ranks in
    the lost set (:func:`~tpuframe_torch.fault.lost_ranks`)."""
    def probe() -> int:
        lost = sum(1 for r in chaos.lost_ranks() if 0 <= r < initial_world)
        return initial_world - lost

    return probe


def rederive_batch_split(global_batch: int, *, dp_size: int, grad_accum: int = 1,
                         process_count: int = 1) -> dict:
    """The per-process batch and grad-accum split for a new ``dp_size`` at
    the same **global** batch (the unit of the checkpointed loader position
    and of the LR schedule).  Keeps ``grad_accum`` when the microbatch
    still divides over the new shards, else takes the nearest divisor of
    ``global_batch`` that does (one ``fault/batch_resplit`` event).  Raises
    ``ValueError`` when there is none."""
    if global_batch < 1 or dp_size < 1 or grad_accum < 1 or process_count < 1:
        raise ValueError("all batch-split inputs must be >= 1")
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} not divisible by {process_count} "
                         "surviving process(es)")
    candidates = sorted((a for a in range(1, global_batch + 1) if global_batch % a == 0),
                        key=lambda a: (abs(a - grad_accum), a))
    for ga in candidates:
        if (global_batch // ga) % dp_size == 0:
            if ga != grad_accum:
                get_telemetry().event("fault/batch_resplit", global_batch=global_batch,
                                      dp_size=dp_size, from_grad_accum=grad_accum,
                                      to_grad_accum=ga)
            return {
                "global_batch": global_batch,
                "local_batch": global_batch // process_count,
                "grad_accum": ga,
                "micro_batch": global_batch // ga // dp_size,
            }
    raise ValueError(
        f"no grad-accum split preserves global batch {global_batch} over {dp_size} "
        "data-parallel shards — the global batch must be a multiple of the surviving dp "
        "size (shrink further or change the schedule deliberately)")


def _survivor_context(base_plan: Any, world: int, attempt: int, *,
                      elastic_axis: str) -> ElasticContext:
    """The mesh and plan for ``world`` survivors of ``base_plan``'s world:
    the same axes, ``elastic_axis`` absorbing the change (the survivors are
    renumbered 0..world-1 by the relaunch)."""
    from tpuframe_torch.core.runtime import MeshSpec

    world0 = int(base_plan.mesh.devices.size)
    if world == world0:
        return ElasticContext(attempt=attempt, world_size=world, initial_world_size=world0,
                              plan=base_plan, resized=False)
    if world > world0:
        raise ValueError(
            f"capacity probe reports {world} device(s) but the base plan only spans "
            f"{world0}: growing beyond the original mesh needs a new base ParallelPlan over "
            "the larger world (restart run_elastic with it; the checkpoint manifest reshards "
            "up at restore just the same)")
    mesh = MeshSpec.from_mesh(base_plan.mesh).shrink_to(world, elastic_axis=elastic_axis) \
        .build(world)
    return ElasticContext(attempt=attempt, world_size=world, initial_world_size=world0,
                          plan=base_plan.rebind(mesh), resized=True)


def _reported_lost_ranks(error: BaseException) -> set[int]:
    """The ranks an error says were lost: a worker's ``RankLostError``
    (``ranks``) or the launcher's ``WorkerLostError`` (``rank``), anywhere
    on its cause chain."""
    from tpuframe_torch.launch.distributor import WorkerLostError

    lost: set[int] = set()
    seen: set[int] = set()
    e: BaseException | None = error
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, chaos.RankLostError):
            lost.update(e.ranks)
        elif isinstance(e, WorkerLostError):
            lost.add(int(e.rank))
        e = e.__cause__ or e.__context__
    return lost


def run_elastic(
    train_fn: Callable[[ElasticContext], Any],
    *,
    plan: Any,
    policy: RestartPolicy | None = None,
    checkpoint_dir: str | None = None,
    capacity_probe: Callable[[], int] | None = None,
    min_world_size: int = 1,
    elastic_axis: str | None = None,
    **kwargs: Any,
) -> Any:
    """Supervise ``train_fn`` with shrink-to-survivors recovery.

    Each attempt: the supervisor probes the surviving world
    (``capacity_probe``; default: ``plan``'s world minus the lost set and
    the ranks earlier attempts reported lost),
    the mesh is rebuilt for it when it changed (``elastic_axis``, default
    ``data``, absorbs the change; the other axes keep their sizes or the
    rebuild refuses), ``plan`` is rebound, and ``train_fn(ctx)`` runs.  It
    builds its launcher, Trainer and state from ``ctx.plan``; auto-resume
    restores the last committed step with reshard (one ``fault/reshard``
    event in each worker).  Ranks a failed attempt reports lost (module
    docstring) join the lost set before the next probe.  Below
    ``min_world_size`` the supervisor gives up
    (:class:`~tpuframe_torch.fault.WorldTooSmall`).  ``policy``,
    ``checkpoint_dir`` and ``kwargs`` (``classifier``, ``on_restart``,
    ``sleep``) go to the :class:`~tpuframe_torch.fault.Supervisor`.
    """
    from tpuframe_torch.core.runtime import DATA_AXIS

    axis = elastic_axis or DATA_AXIS
    attempts = {"n": 0}
    registered: set[int] = set()
    if capacity_probe is None:
        world0 = int(plan.mesh.devices.size)

        def capacity_probe() -> int:
            # the ranks reported here count even after some plan's end
            # cleared the process-wide set
            lost = chaos.lost_ranks() | registered
            return world0 - sum(1 for r in lost if 0 <= r < world0)

    def attempt(world: int) -> Any:
        attempts["n"] += 1
        # a (re)started attempt runs on a (re)built world: re-arm the
        # fleet-gather ladder a dead peer may have degraded to local-only
        from tpuframe_torch.track.analyze import reset_fleet_degraded

        reset_fleet_degraded()
        ctx = _survivor_context(plan, int(world), attempts["n"], elastic_axis=axis)
        try:
            return train_fn(ctx)
        except BaseException as e:
            new = _reported_lost_ranks(e) - chaos.lost_ranks()
            chaos.register_lost_ranks(new)
            registered.update(new)
            raise

    try:
        return Supervisor(policy, checkpoint_dir=checkpoint_dir, capacity_probe=capacity_probe,
                          min_world_size=min_world_size, **kwargs).run(attempt)
    finally:
        chaos.forget_lost_ranks(registered)
