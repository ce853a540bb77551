"""Telemetry spine and stall watchdog."""

from tpuframe_torch.track.telemetry import configure, get_telemetry, reset
from tpuframe_torch.track.watchdog import Watchdog

__all__ = ["Watchdog", "configure", "get_telemetry", "reset"]
