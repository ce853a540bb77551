"""System-metrics monitor: host and device utilization sampled in the
background.

Port of ``tpuframe/track/system_metrics.py``.  It replaces the reference's
``MLFLOW_ENABLE_SYSTEM_METRICS_LOGGING=true`` and its ``nvidia-smi``
notebook cells: a daemon thread samples ``/proc`` (CPU, RSS) and the CUDA
caching allocator's bytes on each local card, and appends them to the
run's metrics with a monotonically increasing step, with no external
agent.

Every sample is also mirrored into the telemetry registry as gauges
(``system/cpu_util``, ``system/rss_mb``, ``system/device<i>_mem_used_mb``,
``system/device<i>_mem_util``), and folded into the memory plane's
process-wide watermarks (``track/memory.py``: the gauges
``memory/hbm_peak_mb`` and ``memory/host_peak_mb``, and the ratcheted
``memory/watermark`` event).  ``run=None`` runs the monitor
registry-only.  The default interval is the memory plane's
``TPUFRAME_MEMORY_SAMPLE_S`` (10 s), and ``TPUFRAME_MEMORY_LIVE`` (on)
switches the watermarks.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["SystemMetricsMonitor", "device_memory_stats"]


def _cpu_times() -> tuple[float, float]:
    """(process_cpu_seconds, wall_seconds)."""
    t = os.times()
    return (t.user + t.system), time.monotonic()


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_memory_stats() -> dict[str, float]:
    """Per-card memory in MB: the caching allocator's allocated bytes
    (``torch.cuda.memory_allocated``, JAX's ``bytes_in_use``) and their
    share of the card's total.  Empty without CUDA, or before this process
    has touched a card (the JAX function is empty on the CPU)."""
    import torch

    out: dict[str, float] = {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_allocated(i) / 2**20
        limit = torch.cuda.get_device_properties(i).total_memory / 2**20
        out[f"device{i}_mem_used_mb"] = used
        if limit:
            out[f"device{i}_mem_util"] = used / limit
    return out


class SystemMetricsMonitor:
    """Daemon thread logging system metrics every ``interval_s``.

    Args:
      run: a tracker Run with ``log_metrics(dict, step=)``; None samples
        into the telemetry registry only.
      interval_s: seconds between samples; None reads
        ``TPUFRAME_MEMORY_SAMPLE_S`` (default 10).
      registry: MetricsRegistry to mirror gauges into (default: the
        process-wide telemetry's).
    """

    def __init__(self, run=None, interval_s: float | None = None,
                 prefix: str = "system/", registry=None):
        self.run = run
        if interval_s is None:
            from tpuframe_torch.track.memory import memory_env

            interval_s = memory_env()["TPUFRAME_MEMORY_SAMPLE_S"]
        self.interval_s = interval_s
        self.prefix = prefix
        self.registry = registry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = 0
        self._lock = threading.Lock()  # serializes the thread against stop()'s final sample

    def _registry(self):
        if self.registry is not None:
            return self.registry
        from tpuframe_torch.track.telemetry import get_telemetry

        return get_telemetry().registry

    def sample(self) -> dict[str, float]:
        cpu, wall = _cpu_times()
        if not hasattr(self, "_last"):
            self._last = (cpu, wall)
        dcpu = cpu - self._last[0]
        dwall = max(wall - self._last[1], 1e-9)
        self._last = (cpu, wall)
        cpu_util = min(dcpu / dwall, float(os.cpu_count() or 1))
        rss = _rss_mb()
        metrics = {
            f"{self.prefix}cpu_utilization": cpu_util,
            f"{self.prefix}memory_rss_mb": rss,
        }
        devices = device_memory_stats()
        for k, v in devices.items():
            metrics[f"{self.prefix}{k}"] = v
        # registry mirror: fixed gauge names, independent of the run-path
        # prefix, so a scrape sees the same series whatever the run is called
        reg = self._registry()
        reg.gauge("system/cpu_util").set(cpu_util)
        reg.gauge("system/rss_mb").set(rss)
        for k, v in devices.items():
            reg.gauge(f"system/{k}").set(v)
        # the memory plane: this sample into the process-wide watermarks
        from tpuframe_torch.track.memory import memory_env, update_watermarks

        if memory_env()["TPUFRAME_MEMORY_LIVE"]:
            update_watermarks(devices, rss, registry=reg)
        return metrics

    def _publish(self) -> None:
        with self._lock:
            metrics = self.sample()
            if self.run is not None:
                self.run.log_metrics(metrics, step=self._step)
            self._step += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._publish()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # final sample so short runs record at least one point
        self._publish()
