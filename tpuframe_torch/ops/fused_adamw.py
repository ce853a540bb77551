"""Fused AdamW: one kernel per tensor for the whole moment and parameter
update (K4).

Port of ``tpuframe/ops/fused_adamw.py``.  Exposed three ways:

- :func:`fused_adamw_update` — leaf-level ``(p, g, m, v, step) -> (p', m',
  v')``, as in JAX (new tensors).
- :func:`fused_adamw_update_` — the same update in place, what the
  optimizer runs: a CUDA tensor launches K4 (``csrc/fused_adamw.cu``), a
  CPU tensor takes the plain :func:`fused_adamw_update_reference`.
- :func:`fused_adamw` — the drop-in for the JAX ``optax`` transform: an
  ``OptimizerSpec`` (what the port's ``Trainer`` takes as ``tx``) whose
  optimizer, :class:`FusedAdamW`, keeps ``count``, ``mu`` and ``nu`` as
  tensors in ``optimizer.state``, so the health sentinel restores them on a
  skipped step as JAX restores ``FusedAdamWState``.

Parameters keep their dtype; the moments are float32.  ``count`` is one
int32 device scalar per parameter, raised with one fused launch per step
and read by the kernel from device memory, so a step never waits for the
host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.train.optim import OptimizerSpec

__all__ = [
    "FusedAdamW",
    "fused_adamw",
    "fused_adamw_update",
    "fused_adamw_update_",
    "fused_adamw_update_reference",
]

_P_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = build.load("fused_adamw")
    lib.tf_fused_adamw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int,
        *([ctypes.c_float] * 9),
        ctypes.c_void_p,
    ]
    lib.tf_fused_adamw.restype = ctypes.c_int
    return lib


def _update_math(p, g, m, v, t, *, lr, b1, b2, eps, weight_decay):
    """The shared math (float32): AdamW with bias correction and decoupled
    decay; ``b**t`` is ``exp(t * log(b))``, 0 where ``b == 0``."""

    def pow_t(b):
        return torch.exp(t * math.log(b)) if b > 0.0 else torch.zeros_like(t)

    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / (1.0 - pow_t(b1))
    vhat = v / (1.0 - pow_t(b2))
    p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
    return p, m, v


def fused_adamw_update_reference(p, g, m, v, step, *, lr: float, b1: float = 0.9,
                                 b2: float = 0.999, eps: float = 1e-8,
                                 weight_decay: float = 0.0):
    """Plain version: ``(p', m', v')`` as new tensors, ``p'`` in the ``p``
    dtype and the moments float32; ``step`` is the 1-based count."""
    pn, mn, vn = _update_math(p.float(), g.float(), m.float(), v.float(), step.float(),
                              lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return pn.to(p.dtype), mn, vn


def _check(p, g, m, v, count) -> None:
    if p.dtype not in _P_CODES or g.dtype != p.dtype:
        raise TypeError(
            f"fused AdamW kernel takes float32 or bfloat16 p and g of one dtype, got "
            f"{p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused AdamW kernel takes float32 moments, got {m.dtype} and {v.dtype}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError(f"the step count is one int32 value, got {count.dtype} "
                        f"{tuple(count.shape)}")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError(
            f"p, g, m, v shapes differ: {tuple(p.shape)} {tuple(g.shape)} "
            f"{tuple(m.shape)} {tuple(v.shape)}")
    if any(t.device != p.device for t in (g, m, v, count)):
        raise ValueError("p, g, m, v and the count must lie on one device")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused AdamW kernel needs contiguous p, g, m and v")


@torch.no_grad()
def fused_adamw_update_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        count: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step of one tensor, in place on ``p``, ``m`` and ``v``;
    ``count`` is the 1-based step (an int32 scalar on the device).

    A CUDA tensor launches K4 on the current stream; a CPU tensor takes
    :func:`fused_adamw_update_reference`.  ``fused_adamw_update_.launches``
    counts kernel launches."""
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not use_kernel(p):
        pn, mn, vn = fused_adamw_update_reference(p, g, m, v, count, **hp)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return
    _check(p, g, m, v, count)
    with torch.cuda.device(p.device):
        rc = _library().tf_fused_adamw(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), count.data_ptr(),
            p.numel(), _P_CODES[p.dtype],
            lr, b1, b2, 1.0 - b1, 1.0 - b2,
            math.log(b1) if b1 > 0.0 else 0.0, math.log(b2) if b2 > 0.0 else 0.0,
            eps, weight_decay,
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused AdamW kernel launch failed: CUDA error {rc}")
    fused_adamw_update_.launches += 1


fused_adamw_update_.launches = 0


def fused_adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       step: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, weight_decay: float = 0.0):
    """One AdamW step of one tensor as new tensors ``(p', m', v')`` (the JAX
    function's form); ``step`` is the 1-based count (an integer scalar)."""
    p, m, v = p.detach().clone(), m.detach().float().clone(), v.detach().float().clone()
    fused_adamw_update_(p, g.detach().contiguous(), m, v, step.to(p.device, torch.int32),
                        lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return p, m, v


class FusedAdamW(torch.optim.Optimizer):
    """AdamW whose per-tensor update is :func:`fused_adamw_update_` (K4 on
    the card).

    State per parameter: ``count`` (int32 scalar on the parameter's
    device), ``mu`` and ``nu`` (float32 zeros like the parameter), created
    with the optimizer as optax's ``init`` creates them.  ``step()`` raises
    every count with one fused launch, then updates each parameter that has
    a gradient."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "count": torch.zeros((), dtype=torch.int32, device=p.device),
                    "mu": torch.zeros_like(p, dtype=torch.float32),
                    "nu": torch.zeros_like(p, dtype=torch.float32),
                }

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr = group["lr"]
            if torch.is_tensor(lr):
                raise TypeError("FusedAdamW takes a float lr (the kernel's argument)")
            torch._foreach_add_([self.state[p]["count"] for p in params], 1)
            for p in params:
                st = self.state[p]
                fused_adamw_update_(p, p.grad.contiguous(), st["mu"], st["nu"], st["count"],
                                    lr=float(lr), b1=group["b1"], b2=group["b2"],
                                    eps=group["eps"], weight_decay=group["weight_decay"])
        return None


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """The JAX ``fused_adamw`` transform for the port's ``Trainer(tx=...)``:
    an ``OptimizerSpec`` that builds a :class:`FusedAdamW`."""
    lr = float(learning_rate)
    return OptimizerSpec(
        lambda params: FusedAdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
        lr)
