"""ResNet family over NHWC inputs, with the JAX package's dtype flow.

Port of ``tpuframe/models/resnet.py``.  Module names follow torchvision
(``conv1``, ``layer{i}.{j}``, ``downsample.{0,1}``, ``fc``), so a
torchvision ``state_dict`` loads as it is and ``models.interop`` maps the
JAX tree onto it one to one.

What matches the JAX model exactly:

- Convs pad ``k // 2`` on both sides (``nn.Conv2d(padding=k // 2)``), not
  ``SAME``; the max pool is 3x3/s2 with one ``-inf`` row and column of
  padding on each side (``F.max_pool2d(x, 3, 2, 1)``).
- Inputs are NHWC.  The model works on ``x.permute(0, 3, 1, 2)``, which for
  a contiguous NHWC tensor is already ``channels_last``; the parameters are
  kept in ``channels_last`` too.
- Convs and ``fc`` run in ``compute_dtype`` (inputs and weights cast to
  it).  BatchNorm statistics and affine math run in float32, its outputs
  are float32 unless ``norm_dtype`` is set.  The residual add and ReLU run
  in the promoted dtype, and every block's output is cast back to
  ``compute_dtype``.  The head is a mean over H and W, ``fc``, then a cast
  to float32.

BatchNorm is ``models.norm.ReplicaGroupedBatchNorm``: batch statistics
in training mode, running statistics in eval mode, flax's conventions for
both.  A new model starts in eval mode; the port's steps set the mode for
each call, as the JAX steps pass ``train=``.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.models.norm import ReplicaGroupedBatchNorm

__all__ = [
    "BasicBlock",
    "BatchNorm2d",
    "Bottleneck",
    "Conv2d",
    "Linear",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
]


class Conv2d(nn.Conv2d):
    """Bias-free conv with symmetric ``k // 2`` padding, run in
    ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=False, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


#: the ResNet's BatchNorm (torchvision's name for it)
BatchNorm2d = ReplicaGroupedBatchNorm


class Linear(nn.Linear):
    """Dense layer run in ``compute_dtype`` (input, weight and bias), as
    flax ``Dense(dtype=...)`` casts them."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _projection(in_ch: int, out_ch: int, stride: int, conv, norm):
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(conv(in_ch, out_ch, 1, stride), norm(out_ch))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity or projection skip."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int, conv, norm):
        super().__init__()
        self.conv1 = conv(in_channels, filters, 3, stride)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3)
        self.bn2 = norm(filters)
        self.downsample = _projection(in_channels, filters, stride, conv, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck (torchvision ResNet50 layout)."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int, conv, norm):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = conv(in_channels, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, out, 1)
        self.bn3 = norm(out)
        self.downsample = _projection(in_channels, out, stride, conv, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Generic 4-stage ResNet over NHWC inputs.

    Args:
      stage_sizes: blocks per stage, e.g. (2, 2, 2, 2) for ResNet18.
      block_cls: BasicBlock or Bottleneck.
      num_classes: classifier width; 0 means no head (feature extractor).
      num_filters: width of the first stage.
      stem: "imagenet" = 7x7/s2 conv + 3x3/s2 max pool; "cifar" = 3x3/s1
        conv + the same max pool.
      dtype: compute dtype of convs and ``fc``; parameters and BN
        statistics stay float32.
      norm_dtype: BatchNorm output dtype (None = float32).
      bn_stats: "sync" (global batch statistics) or "local" (per-group
        statistics over ``bn_groups`` batch groups, torch-DDP's
        per-replica BN); on one card the two are the same computation.
      bn_groups: statistic groups of the global batch for
        ``bn_stats="local"`` (0 or 1 = sync); the Trainer fills 0 with the
        plan's ``dp_size`` (:meth:`set_bn_groups`).
      in_channels: image channels.
      device: where the parameters live; None means ``cuda``, which raises
        without CUDA.
      seed: seeds the parameter init (a ``torch.Generator`` on ``device``).
    """

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: Type[nn.Module],
        num_classes: int = 10,
        num_filters: int = 64,
        stem: str = "imagenet",
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = None,
        bn_stats: str = "sync",
        bn_groups: int = 0,
        *,
        in_channels: int = 3,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        if stem == "imagenet":
            stem_k, stem_s = 7, 2
        elif stem == "cifar":
            stem_k, stem_s = 3, 1
        else:
            raise ValueError(f"unknown stem {stem!r}")
        if bn_stats not in ("sync", "local"):
            raise ValueError(f"unknown bn_stats {bn_stats!r}; expected 'sync' or 'local'")
        self.compute_dtype = dtype
        self.bn_stats, self.bn_groups = bn_stats, bn_groups
        conv = functools.partial(Conv2d, compute_dtype=dtype, device=device)
        norm = functools.partial(ReplicaGroupedBatchNorm, groups=self._norm_groups(),
                                 momentum=0.9, eps=1e-5, out_dtype=norm_dtype, device=device)
        self.conv1 = conv(in_channels, num_filters, stem_k, stem_s)
        self.bn1 = norm(num_filters)
        width = num_filters
        for i, num_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(width, num_filters * 2**i, stride, conv, norm))
                width = num_filters * 2**i * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = (Linear(width, num_classes, compute_dtype=dtype, device=device)
                   if num_classes else None)
        self._init_parameters(torch.Generator(device=device).manual_seed(seed))
        self.to(memory_format=torch.channels_last)
        self.eval()

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        """He-normal convs, LeCun-normal ``fc`` with a zero bias, unit BN."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            elif isinstance(m, Linear):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.in_features), generator=gen)
                m.bias.zero_()

    def _norm_groups(self) -> int:
        return self.bn_groups if self.bn_stats == "local" and self.bn_groups > 1 else 1

    def set_bn_groups(self, bn_groups: int) -> None:
        """Take ``bn_groups`` statistic groups from now on (flax's
        ``model.clone(bn_groups=...)``): every BatchNorm's ``groups`` under
        ``bn_stats="local"``; sync BN stays one group."""
        self.bn_groups = bn_groups
        for m in self.modules():
            if isinstance(m, ReplicaGroupedBatchNorm):
                m.groups = self._norm_groups()

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run convs and ``fc`` in ``dtype`` from now on."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                m.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 logits (or pooled features without a head)."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x).to(self.compute_dtype)
        x = x.mean(dim=(2, 3))
        if self.fc is not None:
            x = self.fc(x)
        return x.to(torch.float32)


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck)
