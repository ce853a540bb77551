"""Softmax cross entropy with a recompute backward (K2a, K2b).

Port of ``tpuframe/ops/cross_entropy.py``.  :func:`fused_cross_entropy`
is a :class:`torch.autograd.Function`: its forward launches K2a, which
writes the per-example float32 losses (no softmax in memory) and, when a
gradient is needed, each row's statistics (max and inverse sum of
exponentials, a (B, 2) float32 tensor, 8 bytes a row); its backward
launches K2b, which recomputes the softmax from the saved logits and those
statistics and writes ``(softmax - onehot) * g`` in the logits dtype.  The
kernels are ``csrc/cross_entropy.cu``.  Without statistics K2b takes each
row's max and sum itself, to the same bits.

The launch sites are the custom ops ``tpuframe::cross_entropy_fwd`` and
``tpuframe::cross_entropy_bwd`` (CUDA: the kernel; CPU: the plain
version).  :class:`_FusedCrossEntropy` calls them while TorchDynamo
traces, so ``torch.compile`` keeps each as an opaque node of its forward
and backward graphs, and their implementations directly in an eager call
(``dispatch.launch_site``).

Integer labels only; ``tpuframe_torch.train.step.cross_entropy`` sends soft
labels to a plain soft cross entropy instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import count_launch, custom_op, launch_site

__all__ = [
    "cross_entropy_bwd",
    "cross_entropy_bwd_reference",
    "cross_entropy_fwd",
    "cross_entropy_reference",
    "cross_entropy_stats_reference",
    "fused_cross_entropy",
]

_LOGIT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("cross_entropy")
    lib.tf_cross_entropy_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tf_cross_entropy_fwd.restype = ctypes.c_int
    lib.tf_cross_entropy_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
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


def cross_entropy_stats_reference(logits: torch.Tensor) -> torch.Tensor:
    """Plain row statistics: (B, 2) float32 of each row's max ``m`` and
    ``1 / sum(exp(x - m))``, the sum taken in float64 as the kernels take it
    (where the label holds the row's maximum, its softmax is 1 less a small
    sum, and float32 sums lose 1e-6 of it)."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    s = torch.exp(x - m).double().sum(-1, keepdim=True)
    return torch.cat([m, (1.0 / s).float()], -1)


def cross_entropy_bwd_reference(logits: torch.Tensor, labels: torch.Tensor,
                                g: torch.Tensor, stats: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain backward: ``(softmax(x) - onehot) * g[:, None]`` in the logits
    dtype, the softmax ``exp(x - m) * inv`` from the row statistics
    ``stats`` (default: :func:`cross_entropy_stats_reference` of ``logits``).
    A label outside ``[0, K)`` takes no one-hot, as in the kernel (the
    vocab-parallel loss passes -1 for a label another rank's columns hold)."""
    if stats is None:
        stats = cross_entropy_stats_reference(logits)
    p = torch.exp(logits.float() - stats[:, :1]) * stats[:, 1:]
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
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


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor, *,
                      with_stats: bool = False):
    """Per-example float32 losses of (B, K) logits against (B,) labels;
    with ``with_stats``, ``(losses, stats)``, ``stats`` the (B, 2) float32
    row statistics the backward takes (:func:`cross_entropy_stats_reference`).

    A CUDA tensor launches K2a on the current stream; a CPU tensor takes
    :func:`cross_entropy_reference` (and :func:`cross_entropy_stats_reference`).
    ``cross_entropy_fwd.launches`` counts kernel launches."""
    run = launch_site(torch.ops.tpuframe.cross_entropy_fwd, _fwd_cuda, _fwd_cpu, logits)
    loss, stats = run(logits, labels, with_stats)
    return (loss, stats) if with_stats else loss


def cross_entropy_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the per-example losses: ``(softmax - onehot) * g[:, None]``
    in the logits dtype.

    ``g`` is the (B,) float32 upstream gradient, of any stride (the backward
    of ``losses.mean()`` gives an expanded one, stride 0).  ``stats`` is the
    forward's (B, 2) row statistics of these logits, or None: the kernel
    then takes each row's max and sum itself, to the same bits.  A CUDA
    tensor launches K2b; a CPU tensor takes
    :func:`cross_entropy_bwd_reference`.  ``cross_entropy_bwd.launches``
    counts kernel launches."""
    run = launch_site(torch.ops.tpuframe.cross_entropy_bwd, _bwd_cuda, _bwd_cpu, logits)
    return run(logits, labels, g, stats)


cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0


def _fwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
              with_stats: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a's launch site: ``(losses, stats)``, ``stats`` (0, 2) without
    ``with_stats``."""
    b, k = _check(logits, labels)
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    stats = torch.empty((b if with_stats else 0, 2), dtype=torch.float32, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        rc = lib.tf_cross_entropy_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            stats.data_ptr() if with_stats else None, b, k,
            _LOGIT_CODES[logits.dtype], _LABEL_CODES[labels.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross entropy forward kernel launch failed: CUDA error {rc}")
    count_launch(cross_entropy_fwd)
    return loss, stats


def _fwd_cpu(logits, labels, with_stats):
    loss = cross_entropy_reference(logits, labels)
    stats = (cross_entropy_stats_reference(logits) if with_stats
             else logits.new_empty((0, 2), dtype=torch.float32))
    return loss, stats


def _fwd_fake(logits, labels, with_stats):
    b = logits.shape[0]
    return (logits.new_empty((b,), dtype=torch.float32),
            logits.new_empty((b if with_stats else 0, 2), dtype=torch.float32))


def _bwd_cuda(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
              stats: torch.Tensor | None) -> torch.Tensor:
    """K2b's launch site."""
    b, k = _check(logits, labels)
    if g.dtype != torch.float32 or g.shape != (b,) or g.device != logits.device:
        raise ValueError(
            f"cross entropy backward takes a ({b},) float32 g on {logits.device}, got "
            f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if stats is not None and (stats.dtype != torch.float32 or stats.shape != (b, 2)
                              or stats.device != logits.device or not stats.is_contiguous()
                              or stats.data_ptr() % 8):
        raise ValueError(
            f"cross entropy backward takes contiguous ({b}, 2) float32 stats on "
            f"{logits.device}, got {tuple(stats.shape)} {stats.dtype} on {stats.device}")
    grad = torch.empty((b, k), dtype=logits.dtype, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        rc = lib.tf_cross_entropy_bwd(
            logits.data_ptr(), labels.data_ptr(), None if stats is None else stats.data_ptr(),
            g.data_ptr(), g.stride(0), grad.data_ptr(), b, k,
            _LOGIT_CODES[logits.dtype], _LABEL_CODES[labels.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cross entropy backward kernel launch failed: CUDA error {rc}")
    count_launch(cross_entropy_bwd)
    return grad


def _bwd_cpu(logits, labels, g, stats):
    return cross_entropy_bwd_reference(logits, labels, g, stats)


def _bwd_fake(logits, labels, g, stats):
    return logits.new_empty(logits.shape)


custom_op("cross_entropy_fwd", _fwd_cuda, _fwd_cpu, _fwd_fake)
custom_op("cross_entropy_bwd", _bwd_cuda, _bwd_cpu, _bwd_fake)


class _FusedCrossEntropy(torch.autograd.Function):
    """The eager pair: K2a forward (its row statistics saved when the
    logits need a gradient), K2b recompute backward."""

    @staticmethod
    def forward(ctx, logits, labels):
        if not ctx.needs_input_grad[0]:
            return cross_entropy_fwd(logits, labels)
        loss, stats = cross_entropy_fwd(logits, labels, with_stats=True)
        ctx.save_for_backward(logits, labels, stats)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, stats = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, g, stats), None


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross entropy, (B, K) logits + (B,) int labels ->
    (B,) float32 losses; differentiable in ``logits`` through the
    recompute backward (K2a saves its row statistics for K2b when the
    logits need a gradient)."""
    if labels.ndim != 1:
        raise ValueError("fused_cross_entropy takes integer labels of shape (B,)")
    return _FusedCrossEntropy.apply(logits, labels)
