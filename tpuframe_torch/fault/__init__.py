"""Fault tolerance: the health sentinel, chaos injection, preemption and
supervised restarts.

Port of ``tpuframe/fault``, with its public names:

- ``fault.health``: the on-device non-finite and spike detection, the
  skip-step, :class:`Divergence`, and the recovery directive the
  supervisor escalates;
- ``fault.chaos``: seeded fault injection at named call sites;
- ``fault.preempt``: the SIGTERM and maintenance watcher, the
  step-boundary last-chance checkpoint, :class:`Preempted`;
- ``fault.supervisor``: classified budgets, jittered backoff, pre-resume
  quarantine of torn steps, divergence rollback, elastic capacity.
"""

from tpuframe_torch.fault.chaos import (
    ChaosError,
    ChaosPlan,
    Injector,
    KillWorker,
    LoseRank,
    NaNAt,
    OomAt,
    OomError,
    PoisonRequest,
    PreemptNotice,
    QueueFlood,
    RaiseAt,
    RankLostError,
    ReplicaKill,
    SlowConsumer,
    SpikeAt,
    StallAt,
    TornCheckpoint,
    UnhealthyPromotion,
    lost_ranks,
    reset_lost_ranks,
)
from tpuframe_torch.fault.health import (
    HEALTH_ENV_VARS,
    Divergence,
    HealthPolicy,
    health_verdict,
    init_health_state,
    recovery_directive,
    reset_recovery,
    resolve_policy,
)
from tpuframe_torch.fault.preempt import (
    PREEMPTED_EXIT,
    Preempted,
    PreemptionWatcher,
    gce_maintenance_poller,
    preemption_requested,
)
from tpuframe_torch.fault.supervisor import (
    FailureClass,
    RestartPolicy,
    Supervisor,
    WorldTooSmall,
    backoff_delay,
    classify_failure,
    run_supervised,
)

__all__ = [
    "ChaosError",
    "ChaosPlan",
    "Divergence",
    "FailureClass",
    "HEALTH_ENV_VARS",
    "HealthPolicy",
    "Injector",
    "KillWorker",
    "LoseRank",
    "NaNAt",
    "OomAt",
    "OomError",
    "PREEMPTED_EXIT",
    "PoisonRequest",
    "Preempted",
    "PreemptNotice",
    "PreemptionWatcher",
    "QueueFlood",
    "RaiseAt",
    "RankLostError",
    "ReplicaKill",
    "RestartPolicy",
    "SlowConsumer",
    "SpikeAt",
    "StallAt",
    "Supervisor",
    "TornCheckpoint",
    "UnhealthyPromotion",
    "WorldTooSmall",
    "backoff_delay",
    "classify_failure",
    "gce_maintenance_poller",
    "health_verdict",
    "init_health_state",
    "lost_ranks",
    "preemption_requested",
    "recovery_directive",
    "reset_lost_ranks",
    "reset_recovery",
    "resolve_policy",
    "run_supervised",
]
