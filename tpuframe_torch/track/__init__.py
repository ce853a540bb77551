"""Telemetry spine and stall watchdog."""

from tpuframe_torch.track import telemetry, watchdog
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
    "MetricsRegistry",
    "Telemetry",
    "Watchdog",
    "configure",
    "configure_telemetry",
    "get_telemetry",
    "reset",
    "telemetry",
    "watchdog",
]
