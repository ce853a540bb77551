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
- **Across ranks** (inside :func:`cross_rank_statistics`, which the
  uncompressed data-parallel step enters around its train forward).  Under
  ``jit`` with a data-sharded batch, flax's reduction over the batch axis
  is global: XLA all-reduces the moments in the forward and the backward.
  Here ``groups`` then counts groups of the *global* batch, as in JAX:

  - ``groups=1`` is sync BN (:class:`_CrossRankBatchNorm`): one packed
    ``all_reduce`` of the per-channel ``sum x``, ``sum x^2`` and the count
    in the forward (flax's ``E[x^2] - E[x]^2``, clamped at 0), and one of
    ``sum dy`` and ``sum dy * xhat`` in the backward.  The running buffers
    take the global mean and biased variance, so they stay equal on every
    rank with no further collective.
  - ``groups`` a multiple of the world size: ``groups // world`` groups of
    each rank's rows and no collective (each global group lies on one
    rank).  The step averages the running buffers across the ranks after,
    which makes them the mean over all groups, as in JAX.
  - Groups that span ranks raise ``NotImplementedError``.

  Plain tensor ops, so the same code runs under gloo on the CPU and under
  NCCL on the card.  Outside the context (world 1, eval, and the
  compressed step, whose BatchNorm is shard-local as under JAX's
  ``shard_map``) no collective runs.

The train/eval choice is the module's ``training`` flag, which the port's
steps set for each call (``tpuframe_torch.train.step``), as the JAX steps
pass ``train=`` on every call.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["ReplicaGroupedBatchNorm", "cross_rank_statistics", "rank_local_buffers"]


def _per_channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) tensor shaped to broadcast over (N, C, ...) activations."""
    return t.view((1, -1) + (1,) * (ndim - 2))


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the batch of every rank of the default
    process group (sync BN).  Returns ``(y, mean, var)``: the output in
    ``out_dtype`` and the global float32 moments (biased variance) for the
    running buffers.

    The scale's and bias's gradients are the *local* sums: each rank's
    loss is its local mean and the step's gradient all-reduce averages
    them (an all-reduced sum here would come out ``world`` times too
    large).  ``dx`` takes the global sums and count, so the averaged
    gradients are those of the global mean loss."""

    @staticmethod
    def forward(ctx, x, w, b, eps: float, out_dtype: torch.dtype):
        nd, c = x.ndim, x.shape[1]
        dims = [0, *range(2, nd)]
        x32 = x.to(torch.float32)
        packed = torch.cat([x32.sum(dims), x32.square().sum(dims),
                            x32.new_full((1,), float(x32.numel() // c))])
        dist.all_reduce(packed)
        n = packed[2 * c:]
        mean = packed[:c] / n
        var = (packed[c:2 * c] / n - mean * mean).clamp_min_(0.0)
        y = F.batch_norm(x32, mean, var, w, b, training=False, eps=eps)
        ctx.save_for_backward(x, w, mean, torch.rsqrt(var + eps), n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, mean, inv, n = ctx.saved_tensors
        nd, c = x.ndim, x.shape[1]
        dims = [0, *range(2, nd)]
        xhat = (x.to(torch.float32) - _per_channel(mean, nd)) * _per_channel(inv, nd)
        dy32 = dy.to(torch.float32)
        sum_dy = dy32.sum(dims)
        sum_dy_xhat = (dy32 * xhat).sum(dims)
        packed = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(packed)
        dx = _per_channel(w * inv / n, nd) * (
            n * dy32 - _per_channel(packed[:c], nd) - xhat * _per_channel(packed[c:], nd))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None


def rank_local_buffers(model: nn.Module) -> bool:
    """Whether a train forward inside :func:`cross_rank_statistics` can
    leave floating buffers that differ by rank: any outside a sync
    (``groups=1``) :class:`ReplicaGroupedBatchNorm`, whose running buffers
    take the global moments."""
    return any(b.is_floating_point() for m in model.modules()
               if not (isinstance(m, ReplicaGroupedBatchNorm) and m.groups == 1)
               for b in m.buffers(recurse=False))


@contextlib.contextmanager
def cross_rank_statistics(model: nn.Module) -> Iterator[None]:
    """Training BatchNorm over every rank of the default process group for
    the forwards run inside: each :class:`ReplicaGroupedBatchNorm` of
    ``model`` reads its ``groups`` as groups of the global batch (module
    docstring).  Restored on exit."""
    world = dist.get_world_size()
    norms = [m for m in model.modules() if isinstance(m, ReplicaGroupedBatchNorm)]
    for m in norms:
        m.world = world
    try:
        yield
    finally:
        for m in norms:
            m.world = 1


class ReplicaGroupedBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (channels_last) activations, flax conventions.

    Args:
      num_features: channels.
      groups: statistic groups in training; the batch must divide evenly.
        Inside :func:`cross_rank_statistics`, groups of the global batch.
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
        # the ranks that share statistics, set by cross_rank_statistics
        self.world = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(torch.float32)
        b = self.bias.to(torch.float32)
        g = self.groups
        if self.training and self.world > 1:
            if g == 1:
                return self._sync_forward(x, w, b)
            if g % self.world:
                raise NotImplementedError(
                    f"{g} BatchNorm groups over {self.world} ranks: groups that span ranks are "
                    "not ported (ROADMAP.md, Queue 1); use groups=1 (sync) or a multiple of "
                    "the world size")
            g //= self.world
        x = x.to(torch.float32)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, w, b,
                             training=False, momentum=0.0, eps=self.eps)
            return y.to(self.out_dtype or torch.float32)
        n = x.shape[0]
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
            self._fold(mean, var)
        return y.to(self.out_dtype or torch.float32)

    def _sync_forward(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        y, mean, var = _CrossRankBatchNorm.apply(x, w, b, self.eps,
                                                 self.out_dtype or torch.float32)
        with torch.no_grad():
            self._fold(mean, var)
        return y

    def _fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``ra = 0.9 * ra + 0.1 * batch`` for both running buffers."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
