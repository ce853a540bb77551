"""Fused image normalization (K1): uint8 NHWC -> ``(x * scale - mean) / std``.

Port of ``tpuframe/ops/normalize.py``.  The op is bound by memory
bandwidth: the kernel (``csrc/normalize.cu``) reads the uint8 bytes once
and writes the normalized compute-dtype image once, where the three-op
chain of the plain version makes a float32 pass per op.

For channel ``c`` the transform is ``x * w[c] + b[c]`` with
``w = scale / std`` and ``b = -mean / std`` folded on the host, exactly as
the Pallas kernel folds them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel

__all__ = ["MAX_CHANNELS", "normalize_images", "normalize_images_reference"]

#: largest channel count the kernel takes (``TF_NORM_MAX_C`` in the source)
MAX_CHANNELS = 16

_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("normalize")
    fn = lib.tf_normalize
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.tf_normalize_max_channels.argtypes = []
    lib.tf_normalize_max_channels.restype = ctypes.c_int
    if lib.tf_normalize_max_channels() != MAX_CHANNELS:
        raise RuntimeError("normalize library and wrapper disagree on MAX_CHANNELS")
    return lib


def normalize_images_reference(
    images: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    scale: float = 1.0 / 255.0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version: ``(images * scale - mean) / std`` over the last axis."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    x = images.to(torch.float32) * scale
    return ((x - mean_t) / std_t).to(out_dtype)


def normalize_images(
    images: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    scale: float = 1.0 / 255.0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused ``(images * scale - mean) / std``; channels on the last axis.

    A CUDA tensor launches the kernel on the current stream; it must be
    contiguous uint8 or float32 (0-255) with at most :data:`MAX_CHANNELS`
    channels, and ``out_dtype`` float32 or bfloat16.  A CPU tensor takes
    the plain version.  ``normalize_images.launches`` counts kernel
    launches.
    """
    n_channels = images.shape[-1]
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
    if len(mean) != n_channels or len(std) != n_channels:
        raise ValueError(
            f"mean/std length {len(mean)}/{len(std)} != channels {n_channels}"
        )
    if not use_kernel(images):
        return normalize_images_reference(images, mean, std, scale, out_dtype)
    if images.dtype not in _IN_CODES:
        raise TypeError(f"normalize kernel takes uint8 or float32 input, got {images.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"normalize kernel writes float32 or bfloat16, got {out_dtype}")
    if not images.is_contiguous():
        raise ValueError("normalize kernel needs a contiguous NHWC tensor")
    if not 1 <= n_channels <= MAX_CHANNELS:
        raise ValueError(
            f"normalize kernel takes 1..{MAX_CHANNELS} channels, got {n_channels}"
        )
    weights = (ctypes.c_float * n_channels)(*(scale / s for s in std))
    biases = (ctypes.c_float * n_channels)(*(-m / s for m, s in zip(mean, std)))
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    lib = _library()
    with torch.cuda.device(images.device):  # restores the caller's device on exit
        rc = lib.tf_normalize(
            images.data_ptr(), out.data_ptr(), images.numel(),
            _IN_CODES[images.dtype], _OUT_CODES[out_dtype],
            weights, biases, n_channels,
            torch.cuda.current_stream(images.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"normalize kernel launch failed: CUDA error {rc}")
    normalize_images.launches += 1
    return out


normalize_images.launches = 0
