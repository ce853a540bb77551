"""Fault plane: the training-health sentinel and the env helpers the serve
knobs read."""

from tpuframe_torch.fault.health import (
    HEALTH_ENV_VARS,
    Divergence,
    HealthPolicy,
    health_verdict,
    init_health_state,
    resolve_policy,
)

__all__ = [
    "HEALTH_ENV_VARS",
    "Divergence",
    "HealthPolicy",
    "health_verdict",
    "init_health_state",
    "resolve_policy",
]
