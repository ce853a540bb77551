"""Telemetry spine, stall watchdog, the MLflow file and HTTP stores, the
model registry, the TensorBoard event writer, the system-metrics monitor,
the profiler capture and its device-time parser, the memory plane and the
fleet analyzer with its straggler monitor.

Exports every name of the JAX package's ``tpuframe.track._EXPORTS``, and
resolves them lazily (PEP 562) as it does: the telemetry spine and the
analyzer (``python -m tpuframe_torch.track analyze``) import no torch,
so a wedged card's logs read without it.
"""

import importlib

# name -> submodule it lives in (all under tpuframe_torch.track)
_EXPORTS = {
    "RankLog": "analyze",
    "StragglerMonitor": "analyze",
    "baseline_diff": "analyze",
    "build_trace": "analyze",
    "load_trace_dir": "analyze",
    "skew_report": "analyze",
    "PROFILE_ENV_VARS": "device_time",
    "PROFILE_ENV_DOMAINS": "device_time",
    "classify_op": "device_time",
    "device_time_report": "device_time",
    "device_trace_events": "device_time",
    "profile_env": "device_time",
    "MEMORY_ENV_VARS": "memory",
    "MEMORY_ENV_DOMAINS": "memory",
    "memory_env": "memory",
    "record_executable_memory": "memory",
    "executable_records": "memory",
    "update_watermarks": "memory",
    "maybe_oom_event": "memory",
    "is_oom": "memory",
    "ExperimentTracker": "mlflow_store",
    "MLflowLogger": "mlflow_store",
    "Run": "mlflow_store",
    "broadcast_run_id": "mlflow_store",
    "set_experiment": "mlflow_store",
    "start_run": "mlflow_store",
    "HttpExperimentTracker": "http_store",
    "HttpRun": "http_store",
    "MetricsServer": "http_store",
    "make_tracker": "http_store",
    "ProfilerCallback": "profiler",
    "StepTimer": "profiler",
    "trace": "profiler",
    "trace_step_window": "profiler",
    "HttpModelRegistry": "registry",
    "ModelRegistry": "registry",
    "ModelVersion": "registry",
    "load_model": "registry",
    "TensorBoardLogger": "tensorboard",
    "SystemMetricsMonitor": "system_metrics",
    "MetricsExportCallback": "telemetry",
    "MetricsRegistry": "telemetry",
    "Telemetry": "telemetry",
    "configure": "telemetry",
    "configure_telemetry": "telemetry",
    "get_telemetry": "telemetry",
    "publish_to_loggers": "telemetry",
    "reset": "telemetry",
    "start_metrics_server": "telemetry",
    "Watchdog": "watchdog",
}

# a few exports carry a different name in their home module
_ALIASES = {"configure_telemetry": "configure", "load_trace_dir": "load_dir"}

_SUBMODULES = (
    "analyze",
    "device_time",
    "http_store",
    "memory",
    "mlflow_store",
    "profiler",
    "registry",
    "system_metrics",
    "telemetry",
    "tensorboard",
    "watchdog",
)

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"tpuframe_torch.track.{_EXPORTS[name]}")
        value = getattr(mod, _ALIASES.get(name, name))
        globals()[name] = value  # cache: resolve once
        return value
    if name in _SUBMODULES:
        return importlib.import_module(f"tpuframe_torch.track.{name}")
    raise AttributeError(f"module 'tpuframe_torch.track' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + __all__))
