"""LayerNorm with a recompute backward (K3a, K3b).

Port of ``tpuframe/ops/layer_norm.py``.  :func:`fused_layer_norm` is a
:class:`torch.autograd.Function` over the last axis: its forward launches
K3a, its backward launches K3b, which recomputes the statistics from the
saved ``x`` and ``scale`` (nothing else is saved) and writes ``dx`` in the
``x`` dtype plus ``dscale`` and ``dbias`` summed in float32 and cast to the
scale dtype.  The kernels are ``csrc/layer_norm.cu``.

Semantics are flax ``LayerNorm``'s: float32 statistics, the fast variance
``E[x^2] - E[x]^2`` clamped at 0, ``eps`` (1e-6, where torch's default is
1e-5) inside the rsqrt.  Under ``bf16_compute`` the step casts ``scale`` and
``bias`` to bf16 with every other parameter; both kernels take either dtype
for them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel

__all__ = [
    "FusedLayerNorm",
    "fused_layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "layer_norm_fwd",
    "layer_norm_reference",
]

_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("layer_norm")
    lib.tf_layer_norm_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.tf_layer_norm_fwd.restype = ctypes.c_int
    lib.tf_layer_norm_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.tf_layer_norm_bwd.restype = ctypes.c_int
    return lib


@functools.cache
def _row_groups(device: torch.device) -> int:
    """Row groups of the backward, each one partial sum: two per SM."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain forward: float32 statistics over the last axis, affine, cast
    back to the ``x`` dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                             eps: float = 1e-6):
    """Plain backward of (rows, D) ``x``: ``(dx, dscale, dbias)``, the
    statistics recomputed from ``x``; ``dx`` in the ``x`` dtype, ``dscale``
    and ``dbias`` summed in float32 and cast to the scale dtype."""
    xf, gf = x.float(), g.float()
    d = x.shape[-1]
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    gs = gf * scale.float()
    m1 = gs.sum(-1, keepdim=True) / d
    m2 = (gs * xhat).sum(-1, keepdim=True) / d
    dx = rstd * (gs - m1 - xhat * m2)
    return (dx.to(x.dtype), (gf * xhat).sum(0).to(scale.dtype), gf.sum(0).to(scale.dtype))


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None) -> None:
    if x.ndim != 2 or scale.shape != x.shape[1:] or (bias is not None and bias.shape != scale.shape):
        raise ValueError(
            f"layer norm kernels take (rows, D) x and (D,) scale and bias, got "
            f"{tuple(x.shape)}, {tuple(scale.shape)}"
            + ("" if bias is None else f", {tuple(bias.shape)}"))
    if x.dtype not in _CODES:
        raise TypeError(f"layer norm kernels take float32 or bfloat16 x, got {x.dtype}")
    if scale.dtype not in _CODES or (bias is not None and bias.dtype != scale.dtype):
        raise TypeError(
            "layer norm kernels take float32 or bfloat16 scale and bias of one dtype, got "
            f"{scale.dtype}" + ("" if bias is None else f" and {bias.dtype}"))
    if x.shape[1] < 1:
        raise ValueError("layer norm over an empty axis")
    for t in (scale, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"scale or bias on {t.device}, x on {x.device}")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of (rows, D) ``x`` in the ``x`` dtype.

    A CUDA tensor launches K3a on the current stream; a CPU tensor takes
    :func:`layer_norm_reference`.  ``layer_norm_fwd.launches`` counts
    kernel launches."""
    if not use_kernel(x):
        return layer_norm_reference(x, scale, bias, eps)
    _check(x, scale, bias)
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    rows, d = x.shape
    with torch.cuda.device(x.device):
        rc = _library().tf_layer_norm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d, eps,
            _CODES[x.dtype], _CODES[scale.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer norm forward kernel launch failed: CUDA error {rc}")
    layer_norm_fwd.launches += 1
    return y


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    """Gradients of :func:`layer_norm_fwd` for the upstream ``g``: ``(dx,
    dscale, dbias)``.

    ``g`` may have any strides (the backward of a sum hands over an
    expanded, stride-0 one): it is made contiguous first.  A CUDA tensor
    launches K3b; a CPU tensor takes :func:`layer_norm_bwd_reference`.
    ``layer_norm_bwd.launches`` counts kernel launches."""
    if not use_kernel(x):
        return layer_norm_bwd_reference(x, scale, g, eps)
    _check(x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"layer norm backward takes g like x ({tuple(x.shape)} {x.dtype} on {x.device}), "
            f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    x, scale, g = x.contiguous(), scale.contiguous(), g.contiguous()
    rows, d = x.shape
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale), torch.zeros_like(scale)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    parts = min(_row_groups(x.device), -(-rows // 4))
    work = torch.empty(parts * 2 * d + 2 * rows, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().tf_layer_norm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), work.data_ptr(), parts, rows, d, eps,
            _CODES[x.dtype], _CODES[scale.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer norm backward kernel launch failed: CUDA error {rc}")
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """K3a forward, K3b recompute backward; saves x and scale only."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``(..., D)`` ``x`` with (D,) affine,
    in the ``x`` dtype; differentiable in ``x``, ``scale`` and ``bias``
    through the recompute backward."""
    if scale.shape != x.shape[-1:] or bias.shape != x.shape[-1:]:
        raise ValueError(
            f"scale/bias shapes {tuple(scale.shape)}/{tuple(bias.shape)} != (.., {x.shape[-1]})")
    flat = x.reshape(-1, x.shape[-1])
    return _FusedLayerNorm.apply(flat, scale, bias, eps).reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """flax ``LayerNorm`` drop-in over :func:`fused_layer_norm`.

    Parameters ``scale`` (ones) and ``bias`` (zeros), float32, of shape
    ``(features,)``; the output is cast to ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-6, dtype: torch.dtype = torch.float32,
                 *, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.scale, self.bias, self.epsilon).to(self.dtype)
