"""Telemetry spine, stall watchdog, the MLflow file store, the model
registry, the TensorBoard event writer and the system-metrics monitor."""

from tpuframe_torch.track import (
    mlflow_store,
    registry,
    system_metrics,
    telemetry,
    tensorboard,
    watchdog,
)
from tpuframe_torch.track.mlflow_store import (
    ExperimentTracker,
    MLflowLogger,
    Run,
    broadcast_run_id,
    set_experiment,
    start_run,
)
from tpuframe_torch.track.registry import ModelRegistry, ModelVersion, load_model
from tpuframe_torch.track.system_metrics import SystemMetricsMonitor
from tpuframe_torch.track.telemetry import (
    MetricsExportCallback,
    MetricsRegistry,
    Telemetry,
    configure,
    get_telemetry,
    publish_to_loggers,
    reset,
)
from tpuframe_torch.track.tensorboard import TensorBoardLogger
from tpuframe_torch.track.watchdog import Watchdog

#: the JAX package's name for :func:`configure`
configure_telemetry = configure

__all__ = [
    "ExperimentTracker",
    "MLflowLogger",
    "MetricsExportCallback",
    "MetricsRegistry",
    "ModelRegistry",
    "ModelVersion",
    "Run",
    "SystemMetricsMonitor",
    "Telemetry",
    "TensorBoardLogger",
    "Watchdog",
    "broadcast_run_id",
    "configure",
    "configure_telemetry",
    "get_telemetry",
    "load_model",
    "mlflow_store",
    "publish_to_loggers",
    "registry",
    "reset",
    "set_experiment",
    "start_run",
    "system_metrics",
    "telemetry",
    "tensorboard",
    "watchdog",
]
