"""Kernel dispatch: a CUDA tensor launches the kernel, a CPU tensor takes
the plain PyTorch version.

The JAX package decides between its Pallas kernel and the jnp reference
with env switches and a measured ledger (``TPUFRAME_DISABLE_PALLAS``,
``TPUFRAME_KERNELS``).  The port has no such switch: the device of the
tensor decides alone, so nothing can turn a kernel off on the card, and a
CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["use_kernel"]


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
