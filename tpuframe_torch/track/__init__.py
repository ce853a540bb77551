"""Telemetry spine, stall watchdog, the MLflow file store and the model
registry."""

from tpuframe_torch.track import mlflow_store, registry, telemetry, watchdog
from tpuframe_torch.track.mlflow_store import (
    ExperimentTracker,
    MLflowLogger,
    Run,
    broadcast_run_id,
    set_experiment,
    start_run,
)
from tpuframe_torch.track.registry import ModelRegistry, ModelVersion, load_model
from tpuframe_torch.track.telemetry import (
    MetricsRegistry,
    Telemetry,
    configure,
    get_telemetry,
    reset,
)
from tpuframe_torch.track.watchdog import Watchdog

#: the JAX package's name for :func:`configure`
configure_telemetry = configure

__all__ = [
    "ExperimentTracker",
    "MLflowLogger",
    "MetricsRegistry",
    "ModelRegistry",
    "ModelVersion",
    "Run",
    "Telemetry",
    "Watchdog",
    "broadcast_run_id",
    "configure",
    "configure_telemetry",
    "get_telemetry",
    "load_model",
    "mlflow_store",
    "registry",
    "reset",
    "set_experiment",
    "start_run",
    "telemetry",
    "watchdog",
]
