"""Ulysses attention over the ``seq`` axis (K8): the all-to-all form of
sequence parallelism.

Port of ``tpuframe/ops/ulysses.py``.  Where the ring (``ops/
ring_attention.py``) keeps Q local and rotates K and V, this re-shards
once: an all-to-all over the ``seq`` group swaps the sequence split for a
head split, (B, L / n, H, D) -> (B, L, H / n, D), every rank attends over
the whole sequence for its H / n heads, and a second all-to-all swaps back.
It needs ``num_heads % n == 0`` and raises JAX's ``ValueError`` otherwise.

- **The re-shard** is one ``dist.all_to_all_single`` a direction for q, k
  and v together (stacked): the split dim is moved to lead, cut in n equal
  chunks, exchanged as bytes (any dtype travels), and the chunks received
  are concatenated in ``seq`` rank order, so the sequence is in global order
  after it, as ``lax.all_to_all(tiled=True)`` leaves it.  Both all-to-alls
  sit in a :class:`torch.autograd.Function` whose backward is the opposite
  all-to-all.
- **The local attention is** :func:`~tpuframe_torch.ops.blockwise_attention.
  blockwise_attention`: K6a-K6c on the card, their plain schedule on the
  CPU.  JAX materializes the scores here (``attention_reference``); the two
  agree within K6's tolerances (ROADMAP.md, Queue 3).  With one rank on the
  axis it is ``attention_reference``, as in JAX.

The functions take the rank's own shards and find the ``seq`` group in the
runtime's mesh (or the ``mesh`` given): JAX's take global arrays under
``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuframe_torch.core.runtime import DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS
from tpuframe_torch.ops.blockwise_attention import blockwise_attention
from tpuframe_torch.ops.ring_attention import attention_reference, mesh_axis

__all__ = ["ulysses_attention", "ulysses_attention_local"]


def _all_to_all(x: torch.Tensor, ax, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``ax``'s group: ``x`` cut in ``ax.size`` chunks along
    ``split_dim``, chunk i sent to rank i, the chunks received concatenated
    along ``concat_dim`` in rank order."""
    n = ax.size
    moved = x.movedim(split_dim, 0)
    send = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got.view(-1).view(torch.uint8), send.view(-1).view(torch.uint8),
                           group=ax.group)
    # got[i] is rank i's chunk, laid out as x with split_dim cut to size / n
    parts = got.movedim(1, 1 + split_dim)
    out = parts.movedim(0, concat_dim)
    shape = list(parts.shape[1:])
    shape[concat_dim] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` forward; the opposite all-to-all backward."""

    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.dims = ax, (split_dim, concat_dim)
        return _all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g.contiguous(), ctx.ax, concat_dim, split_dim), None, None, None


def _ulysses(q, k, v, ax, causal: bool) -> torch.Tensor:
    n = ax.size
    if n == 1:
        return attention_reference(q, k, v, causal=causal)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(
            f"ulysses attention needs num_heads ({heads}) divisible by the "
            f"'{ax.name}' axis size ({n}); use ring attention otherwise")
    # seq-sharded -> head-sharded: (3, B, L/n, H, D) -> (3, B, L, H/n, D)
    qkv = _AllToAll.apply(torch.stack([q, k, v]), ax, 3, 2)
    out = blockwise_attention(*qkv.unbind(0), causal=causal)
    # head-sharded -> seq-sharded: (B, L, H/n, D) -> (B, L/n, H, D)
    return _AllToAll.apply(out, ax, 1, 2)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            axis_name: str = SEQUENCE_AXIS, causal: bool = False
                            ) -> torch.Tensor:
    """Ulysses attention over this rank's sequence shards (B, L_local, H, D)
    of the ``axis_name`` axis of the runtime's mesh; the same layout out.
    Exact: full attention over the global sequence.  Every rank of the axis
    calls it together."""
    return _ulysses(q, k, v, mesh_axis(axis_name), causal)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None, *,
                      causal: bool = False, seq_axis: str = SEQUENCE_AXIS,
                      batch_axes=(DATA_AXIS, FSDP_AXIS)) -> torch.Tensor:
    """:func:`ulysses_attention_local` over ``mesh`` (default: the
    runtime's).  JAX's takes global arrays and splits the batch over
    ``batch_axes`` and the sequence over ``seq_axis`` under ``shard_map``;
    the port's takes this rank's shard, so ``batch_axes`` only names the
    split."""
    del batch_axes
    return _ulysses(q, k, v, mesh_axis(seq_axis, mesh), causal)
