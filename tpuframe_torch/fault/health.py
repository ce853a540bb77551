"""Tolerant env readers, the port's copy of the two helpers in
``tpuframe/fault/health.py`` that the serve knobs use.  The training-health
sentinel comes with the training slice."""

from __future__ import annotations

import os

__all__ = ["_env_float", "_env_int"]


def _env_float(name: str, default: float) -> float:
    """Float env knob; unset, empty or malformed reads as ``default``."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))
