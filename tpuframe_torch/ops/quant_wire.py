"""The compressed gradient wire's kernels (K5a, K5b, K5c): per-bucket
abs-max, encode onto the int8 or fp8-e4m3 grid, and decode of the summed
payload to the mean gradient.

Port of ``tpuframe/ops/quant_wire.py``.  The arrays are ``(buckets,
elems)`` float32 (``parallel.compression`` lays the gradient out so), the
scale column ``(buckets, 1)``.  A CUDA tensor launches the kernel of
``csrc/quant_wire.cu``; a CPU tensor takes the plain version.  The plain
versions repeat the JAX references expression for expression, and the
kernels match them bit for bit in amax and encode (decode within 1e-6),
so the wire's bits never depend on where it ran.

Two places where torch and XLA differ are spelled out in the plain
versions: a NaN on the int8 grid converts to 0 (XLA's convert; torch's
cast leaves it undefined), and an e4m3 value past the 464 rounding edge is
NaN (ml_dtypes; torch's cast saturates to 448).  Divisors are tensors:
torch on CUDA multiplies by the reciprocal of a Python-number divisor,
where the JAX expressions divide.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import count_launch, use_kernel

__all__ = [
    "bucket_abs_max",
    "bucket_abs_max_reference",
    "quant_decode",
    "quant_decode_reference",
    "quant_encode",
    "quant_encode_reference",
]

_QMAX = 127.0    # symmetric int8 grid (== compression._QMAX)
_FP8_MAX = 448.0  # e4m3 finite max (== compression._FP8_MAX)
_FP8_EDGE = 464.0  # halfway from 448 to the next e4m3 step: rounds to NaN above
_TINY = torch.finfo(torch.float32).tiny
_MODES = {"int8": 0, "int8_stochastic": 1, "fp8": 2}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("quant_wire")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, args in ((lib.tf_bucket_abs_max, [vp, vp, ll, ll, vp]),
                     (lib.tf_quant_encode, [vp, vp, vp, vp, ll, ll, i, vp]),
                     (lib.tf_quant_decode, [vp, vp, vp, ll, ll, i, i, vp])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    # a fill on the device: torch.tensor(value, device=...) would copy from
    # pageable host memory, which synchronizes the stream
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _denom(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, tiny)``, NaN kept (``jnp.maximum``)."""
    return torch.maximum(amax, _const(amax, _TINY))


# -- plain versions (the arithmetic contract) ---------------------------------


def bucket_abs_max_reference(v: torch.Tensor) -> torch.Tensor:
    """Per-bucket abs-max of a (buckets, elems) array, keepdims."""
    return torch.amax(torch.abs(v), dim=1, keepdim=True)


def quant_encode_reference(v: torch.Tensor, amax: torch.Tensor, mode: str,
                           noise: torch.Tensor | None = None):
    """Quantize ``v`` against per-bucket ``amax``: ``(payload, deq)`` —
    int8: symmetric grid, ``floor(x + noise)`` when ``noise`` is given
    (unbiased stochastic rounding) else round half to even, int32-held;
    fp8-e4m3: amax mapped onto the 448 grid, round to nearest even in the
    cast, float32-held."""
    denom = _denom(amax)
    if mode == "fp8":
        x = (v / denom) * _FP8_MAX
        x = torch.where(x.abs() <= _FP8_EDGE, x, torch.nan)
        return x.to(torch.float8_e4m3fn).to(torch.float32), denom / _const(denom, _FP8_MAX)
    scale = denom / _const(denom, _QMAX)
    x = v / scale
    x = torch.floor(x + noise) if noise is not None else torch.round(x)
    q = torch.clip(x, -_QMAX, _QMAX)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int32), scale


def quant_decode_reference(total: torch.Tensor, amax: torch.Tensor, mode: str,
                           world: int) -> torch.Tensor:
    """Summed payloads back to mean gradient units; a bucket whose agreed
    amax is inf or NaN decodes to NaN (divergence must look like
    divergence)."""
    deq = _denom(amax) / _const(amax, _FP8_MAX if mode == "fp8" else _QMAX)
    mean = total.to(torch.float32) * deq / _const(amax, float(world))
    return torch.where(torch.isfinite(amax), mean, torch.nan)


# -- the kernels --------------------------------------------------------------


def _check(v: torch.Tensor, amax: torch.Tensor | None = None, *,
           dtypes=(torch.float32,), what: str = "v") -> None:
    if v.dtype not in dtypes:
        raise TypeError(f"quant_wire kernel takes {what} of dtype {dtypes}, got {v.dtype}")
    if v.ndim != 2 or v.numel() == 0:
        raise ValueError(f"quant_wire kernel takes a non-empty (buckets, elems) {what}, "
                         f"got {tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"quant_wire kernel needs a contiguous {what}")
    if amax is not None:
        if amax.dtype != torch.float32 or tuple(amax.shape) != (v.shape[0], 1):
            raise ValueError(f"amax must be float32 ({v.shape[0]}, 1), got {amax.dtype} "
                             f"{tuple(amax.shape)}")
        if amax.device != v.device:
            raise ValueError("amax and the payload must lie on one device")


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def bucket_abs_max(v: torch.Tensor) -> torch.Tensor:
    """Per-bucket abs-max of a (buckets, elems) float32 array, keepdims —
    the scale-agreement input of the compressed wire.  A CUDA tensor
    launches K5a (``bucket_abs_max.launches`` counts them)."""
    if not use_kernel(v):
        return bucket_abs_max_reference(v)
    _check(v)
    out = torch.empty((v.shape[0], 1), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _library().tf_bucket_abs_max(v.data_ptr(), out.data_ptr(), v.shape[0], v.shape[1],
                                          torch.cuda.current_stream(v.device).cuda_stream)
    _launched(rc, "bucket_abs_max")
    count_launch(bucket_abs_max)
    return out


bucket_abs_max.launches = 0


def quant_encode(v: torch.Tensor, amax: torch.Tensor, mode: str,
                 noise: torch.Tensor | None = None):
    """Encode a (buckets, elems) float32 payload against agreed per-bucket
    scales: ``(payload, deq)``.  ``noise`` (like ``v``) selects stochastic
    rounding on the int8 grid; fp8 ignores it.  A CUDA tensor launches K5b
    (``quant_encode.launches``)."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"unknown wire mode {mode!r}; known: int8/fp8")
    if mode == "fp8":
        noise = None
    if not use_kernel(v):
        return quant_encode_reference(v, amax, mode, noise)
    _check(v, amax)
    if noise is not None:
        _check(noise, what="noise")
        if noise.shape != v.shape or noise.device != v.device:
            raise ValueError(f"noise must be like v {tuple(v.shape)}, got {tuple(noise.shape)}")
    code = _MODES["fp8" if mode == "fp8" else "int8_stochastic" if noise is not None else "int8"]
    q = torch.empty(v.shape, dtype=torch.float32 if mode == "fp8" else torch.int32,
                    device=v.device)
    with torch.cuda.device(v.device):
        rc = _library().tf_quant_encode(
            v.data_ptr(), amax.data_ptr(), None if noise is None else noise.data_ptr(),
            q.data_ptr(), v.shape[0], v.shape[1], code,
            torch.cuda.current_stream(v.device).cuda_stream)
    _launched(rc, "quant_encode")
    count_launch(quant_encode)
    return q, _denom(amax) / _const(amax, _FP8_MAX if mode == "fp8" else _QMAX)


quant_encode.launches = 0


def quant_decode(total: torch.Tensor, amax: torch.Tensor, mode: str, world: int) -> torch.Tensor:
    """Decode summed payloads (int32 on the int8 grid, float32 on the e4m3
    grid) to the mean gradient over ``world`` ranks, NaN where the bucket's
    amax is not finite.  A CUDA tensor launches K5c
    (``quant_decode.launches``)."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"unknown wire mode {mode!r}; known: int8/fp8")
    if not use_kernel(total):
        return quant_decode_reference(total, amax, mode, world)
    want = torch.float32 if mode == "fp8" else torch.int32
    _check(total, amax, dtypes=(want,), what="total")
    if int(world) < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    out = torch.empty(total.shape, dtype=torch.float32, device=total.device)
    with torch.cuda.device(total.device):
        rc = _library().tf_quant_decode(
            total.data_ptr(), amax.data_ptr(), out.data_ptr(), total.shape[0], total.shape[1],
            int(mode == "fp8"), int(world), torch.cuda.current_stream(total.device).cuda_stream)
    _launched(rc, "quant_decode")
    count_launch(quant_decode)
    return out


quant_decode.launches = 0
