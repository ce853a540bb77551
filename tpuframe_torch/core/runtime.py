"""Where the port runs: the device every entry point resolves.

Port of ``tpuframe/core/runtime.py`` for one process on one device.  Entry
points run on ``cuda`` unless the caller asks for ``device="cpu"`` (the
tests do); without CUDA they raise rather than carry on on the CPU.  The
mesh and the distributed setup come with the data-parallel part of the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Runtime", "initialize", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device raises when CUDA is absent.

    Only ``cuda`` and ``cpu`` devices are accepted."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected cuda or cpu")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """The device a process runs on, and its platform name (``gpu`` or
    ``cpu``)."""

    device: torch.device
    platform: str


def initialize(device: str | torch.device | None = None) -> Runtime:
    """Resolve the device (default ``cuda``; raises without it)."""
    dev = resolve_device(device)
    return Runtime(device=dev, platform="gpu" if dev.type == "cuda" else "cpu")
