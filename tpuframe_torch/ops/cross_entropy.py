"""Softmax cross entropy with a recompute backward (K2a, K2b).

Port of ``tpuframe/ops/cross_entropy.py``.  :func:`fused_cross_entropy`
is a :class:`torch.autograd.Function`: its forward launches K2a, which
writes only the per-example float32 losses (no softmax in memory), and its
backward launches K2b, which recomputes the softmax from the saved logits
and writes ``(softmax - onehot) * g`` in the logits dtype.  Only logits and
labels are saved.  The kernels are ``csrc/cross_entropy.cu``.

Integer labels only; ``tpuframe_torch.train.step.cross_entropy`` sends soft
labels to a plain soft cross entropy instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel

__all__ = [
    "cross_entropy_bwd",
    "cross_entropy_bwd_reference",
    "cross_entropy_fwd",
    "cross_entropy_reference",
    "fused_cross_entropy",
]

_LOGIT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("cross_entropy")
    lib.tf_cross_entropy_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tf_cross_entropy_fwd.restype = ctypes.c_int
    lib.tf_cross_entropy_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.tf_cross_entropy_bwd.restype = ctypes.c_int
    return lib


def cross_entropy_reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain forward: per-example ``logsumexp(x) - x[label]`` in float32."""
    shifted = logits.float() - logits.amax(-1, keepdim=True).float()
    lse = torch.log(torch.exp(shifted).sum(-1))
    picked = torch.gather(shifted, -1, labels[:, None].long())[:, 0]
    return lse - picked


def cross_entropy_bwd_reference(logits: torch.Tensor, labels: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """Plain backward: ``(softmax(x) - onehot) * g[:, None]`` in the logits
    dtype."""
    p = torch.softmax(logits.float(), -1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


def _check(logits: torch.Tensor, labels: torch.Tensor) -> tuple[int, int]:
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(
            f"cross entropy takes (B, K) logits and (B,) labels, got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.dtype not in _LOGIT_CODES:
        raise TypeError(f"cross entropy kernel takes float32 or bfloat16 logits, got {logits.dtype}")
    if labels.dtype not in _LABEL_CODES:
        raise TypeError(f"cross entropy kernel takes int32 or int64 labels, got {labels.dtype}")
    b, k = logits.shape
    if k < 1 or (b > 1 and logits.stride(0) != k) or (k > 1 and logits.stride(1) != 1):
        raise ValueError("cross entropy kernel needs logits contiguous in rows")
    if not labels.is_contiguous():
        raise ValueError("cross entropy kernel needs contiguous labels")
    if labels.device != logits.device:
        raise ValueError(f"labels on {labels.device}, logits on {logits.device}")
    return b, k


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example float32 losses of (B, K) logits against (B,) labels.

    A CUDA tensor launches K2a on the current stream; a CPU tensor takes
    :func:`cross_entropy_reference`.  ``cross_entropy_fwd.launches`` counts
    kernel launches."""
    if not use_kernel(logits):
        return cross_entropy_reference(logits, labels)
    b, k = _check(logits, labels)
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        rc = lib.tf_cross_entropy_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), b, k,
            _LOGIT_CODES[logits.dtype], _LABEL_CODES[labels.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross entropy forward kernel launch failed: CUDA error {rc}")
    cross_entropy_fwd.launches += 1
    return loss


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Gradient of the per-example losses: ``(softmax - onehot) * g[:, None]``
    in the logits dtype.

    ``g`` is the (B,) float32 upstream gradient, of any stride (the backward
    of ``losses.mean()`` gives an expanded one, stride 0).  A CUDA tensor
    launches K2b; a CPU tensor takes :func:`cross_entropy_bwd_reference`.
    ``cross_entropy_bwd.launches`` counts kernel launches."""
    if not use_kernel(logits):
        return cross_entropy_bwd_reference(logits, labels, g)
    b, k = _check(logits, labels)
    if g.dtype != torch.float32 or g.shape != (b,) or g.device != logits.device:
        raise ValueError(
            f"cross entropy backward takes a ({b},) float32 g on {logits.device}, got "
            f"{tuple(g.shape)} {g.dtype} on {g.device}")
    grad = torch.empty((b, k), dtype=logits.dtype, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        rc = lib.tf_cross_entropy_bwd(
            logits.data_ptr(), labels.data_ptr(), g.data_ptr(), g.stride(0),
            grad.data_ptr(), b, k,
            _LOGIT_CODES[logits.dtype], _LABEL_CODES[labels.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross entropy backward kernel launch failed: CUDA error {rc}")
    cross_entropy_bwd.launches += 1
    return grad


cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0


class _FusedCrossEntropy(torch.autograd.Function):
    """K2a forward, K2b recompute backward; saves logits and labels only."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return cross_entropy_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, g), None


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross entropy, (B, K) logits + (B,) int labels ->
    (B,) float32 losses; differentiable in ``logits`` through the
    recompute backward."""
    if labels.ndim != 1:
        raise ValueError("fused_cross_entropy takes integer labels of shape (B,)")
    return _FusedCrossEntropy.apply(logits, labels)
