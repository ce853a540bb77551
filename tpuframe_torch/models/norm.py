"""BatchNorm with flax's statistics convention and an explicit group count.

Port of ``tpuframe/models/norm.py`` (``ReplicaGroupedBatchNorm``), and the
one BatchNorm of the port's ResNet.  What it keeps from the JAX side:

- **Statistics in float32.**  The input is cast to float32, the batch
  moments and the affine math run in float32, and only the output is cast,
  to ``out_dtype`` (float32 when None) — ``norm_dtype`` sets the output
  dtype alone (``tpuframe/models/resnet.py:163-165``).
- **Biased variance in the running buffer.**  Flax folds the biased batch
  variance into ``var`` (``norm.py:93,104``); ``nn.BatchNorm2d`` folds the
  unbiased one.  The normalize runs through ``torch.native_batch_norm``
  without running buffers (it normalizes with the biased variance, as
  flax does), and the running buffers are updated here from its saved
  mean and inverse std: ``ra = 0.9 * ra + 0.1 * batch`` for flax momentum
  0.9, i.e. ``self.momentum`` (torch's convention) 0.1.
- **Groups.**  ``groups=N`` takes moments per batch group (torch-DDP
  per-replica statistics); the running buffers take the group mean.  On
  one card ``groups=1`` is sync BN, and "sync" and "local" are the same
  computation.

The train/eval choice is the module's ``training`` flag, which the port's
steps set for each call (``tpuframe_torch.train.step``), as the JAX steps
pass ``train=`` on every call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ReplicaGroupedBatchNorm"]


class ReplicaGroupedBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (channels_last) activations, flax conventions.

    Args:
      num_features: channels.
      groups: statistic groups in training; the batch must divide evenly.
      momentum: flax's momentum (decay of the running buffers).
      eps: added to the variance inside the rsqrt.
      out_dtype: output dtype (None = float32).
      device: where the parameters and buffers live.
    """

    def __init__(self, num_features: int, *, groups: int = 1, momentum: float = 0.9,
                 eps: float = 1e-5, out_dtype: torch.dtype | None = None, device=None):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum, device=device)
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        self.groups = groups
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(torch.float32)
        b = self.bias.to(torch.float32)
        x = x.to(torch.float32)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, w, b,
                             training=False, momentum=0.0, eps=self.eps)
            return y.to(self.out_dtype or torch.float32)
        g, n = self.groups, x.shape[0]
        if n % g:
            raise ValueError(f"batch size {n} must divide evenly into {g} BN groups")
        parts = [torch.native_batch_norm(xg, w, b, None, None, True, 0.0, self.eps)
                 for xg in (x.chunk(g) if g > 1 else (x,))]
        y = parts[0][0] if g == 1 else torch.cat([p[0] for p in parts])
        with torch.no_grad():
            # biased variance from the saved inverse std, clamped at 0 as
            # flax clamps E[x^2] - E[x]^2
            stats = [(mean, inv.pow(-2).sub_(self.eps).clamp_min_(0.0))
                     for _, mean, inv in parts]
            mean, var = stats[0] if g == 1 else (
                torch.stack([s[0] for s in stats]).mean(0),
                torch.stack([s[1] for s in stats]).mean(0))
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(self.out_dtype or torch.float32)
