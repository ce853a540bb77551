"""Kernel dispatch: a CUDA tensor launches the kernel, a CPU tensor takes
the plain PyTorch version; and the count of launches, across CUDA graphs.

The JAX package decides between its Pallas kernel and the jnp reference
with env switches and a measured ledger (``TPUFRAME_DISABLE_PALLAS``,
``TPUFRAME_KERNELS``).  The port has no such switch: the device of the
tensor decides alone, so nothing can turn a kernel off on the card, and a
CUDA tensor never reaches the plain version.

Every wrapper counts its kernel's launches in its ``.launches`` through
:func:`count_launch`.  A launch made while the current stream captures a
CUDA graph runs nothing: it goes into the tally of that capture, opened
with :func:`capture_tally` on the capturing stream (keyed by the stream,
so a backward that autograd's device thread records into the same capture
counts there too), and the graph's owner adds the tally to the wrappers'
counts at every replay (:func:`add_tally`), so after N replays the counts
read what N eager calls read.  A capture with no tally open counts
nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

__all__ = ["add_tally", "capture_tally", "count_launch", "custom_op", "launch_site", "use_kernel"]

#: the open tallies, by the capturing stream's handle
_TALLIES: dict[int, dict] = {}
_LOCK = threading.Lock()


def _stream_key() -> int:
    return torch.cuda.current_stream().cuda_stream


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version).  Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(
        f"tensor on {x.device}: the port's ops run on cuda (kernel) or cpu "
        "(plain version) only"
    )


def launch_site(op, cuda_impl, cpu_impl, x: torch.Tensor):
    """What runs a kernel's launch site for the tensor ``x``: the registered
    custom op ``op`` while TorchDynamo traces (one opaque node of the
    graph), else its implementation for ``x``'s device directly: an eager
    call through the dispatcher's Python round trip costs tens of µs on the
    card's host."""
    if torch.compiler.is_compiling():
        return op
    return cuda_impl if use_kernel(x) else cpu_impl


def custom_op(name: str, cuda_impl, cpu_impl, fake):
    """Register ``tpuframe::name``: ``cuda_impl`` (the kernel's launch site)
    on CUDA, ``cpu_impl`` (its plain version) on the CPU, ``fake`` for
    tracing; no composite kernel, no autograd formula (each kernel's
    ``autograd.Function`` calls its ops)."""
    op = torch.library.custom_op(f"tpuframe::{name}", cuda_impl, mutates_args=(),
                                 device_types="cuda")
    op.register_kernel("cpu")(cpu_impl)
    op.register_fake(fake)
    return op


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches += 1``, or,
    while the current stream captures, one more in that capture's tally.
    Called where a kernel launched, so on a CUDA build."""
    if torch.cuda.is_current_stream_capturing():
        tally = _TALLIES.get(_stream_key())
        if tally is not None:
            with _LOCK:
                tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    wrapper.launches += 1


@contextlib.contextmanager
def capture_tally() -> Iterator[dict]:
    """The launches captured on the current stream, by wrapper: open it
    inside ``torch.cuda.graph(...)``, where the capturing stream is
    current."""
    key = _stream_key()
    prev = _TALLIES.get(key)
    tally: dict = {}
    _TALLIES[key] = tally
    try:
        yield tally
    finally:
        if prev is None:
            _TALLIES.pop(key, None)
        else:
            _TALLIES[key] = prev


def add_tally(tally: dict, times: int = 1) -> None:
    """Add a capture's launches to the wrappers' counts, ``times`` over:
    what one replay of the graph launched."""
    for wrapper, n in tally.items():
        wrapper.launches += n * times
