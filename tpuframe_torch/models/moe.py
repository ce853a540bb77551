"""Mixture-of-Experts MLP with expert parallelism over the ``expert`` axis.

Port of ``tpuframe/models/moe.py``.  :class:`MoEMLP` replaces a transformer
block's MLP: a float32 router without bias, softmax, the top-k experts of
each token with their gates renormalized to sum 1, the capacity-truncated
dispatch to the expert MLPs (tanh GELU) and the gated combine
(``ops.moe_gating``, kernels K9a-K9c on the card), and Switch's
load-balancing loss.  :func:`moe_rules` places the expert-stacked weights
on the ``expert`` axis.

**Where JAX sees global arrays, a rank here holds its tokens.**  JAX routes
over the global batch, so which token overflows an expert depends on every
rank's tokens.  Here each MoE layer all-gathers the (B, L, k) expert
choices of the token group (``data`` x ``fsdp`` x ``seq``, the ranks that
hold different tokens), rebuilds the global order (token ``b·L + l``,
choice-major) and routes it with JAX's ``_routing``; the rank keeps its own
slots' positions and keep flags and dispatches only its own kept tokens.
The expert MLP is row-wise, so every row equals JAX's.  The capacity is
JAX's integer formula over the global token count, ``max(1, int(ceil(k·N /
E) · capacity_factor))``.

**Expert parallelism.**  Tokens are replicated over ``expert``, as in JAX;
under a plan whose rules split ``w_in`` and ``w_out`` over it
(``parallel.tensor.shard_model`` hands the module the axis,
:meth:`MoEMLP.tp_take_split`) a rank computes its E / n experts and the
contributions are summed over the group (``ops.moe_gating``).

**Top-k ties** break as ``jax.lax.top_k`` breaks them, the lower index
first: a stable descending sort, its first k.

**The aux loss** (Switch eq. 4): ``E · weight · Σ_e frac_e · mean_prob_e``
with ``frac_e`` the share of tokens whose first choice is e.  Both means
are global: the sums are all-reduced over the token group and divided by
the global N.  Every rank adds the same aux while each rank's gradient
covers its own tokens, and the step averages gradients over the token
group, so the all-reduce's backward multiplies by the group's size: the
averaged gradient is ``jax.grad`` of the global aux.  The forward leaves
the value in the module's ``aux_loss``, where the train step collects it
(JAX's ``aux_loss`` collection) and clears it.

Parameters stay float32 and are cast to the module's compute dtype for the
products (JAX's ``MoEMLP`` keeps ``w_in`` and ``w_out`` in its ``dtype``
itself; ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from tpuframe_torch.core.runtime import EXPERT_AXIS, SEQUENCE_AXIS, resolve_device
from tpuframe_torch.models.resnet import Linear
from tpuframe_torch.ops.moe_gating import _routing, gelu_tanh, moe_dispatch_combine

__all__ = ["MoEMLP", "moe_rules"]


def moe_rules():
    """The plan's rules: the expert-stacked weights split over ``expert``
    on their expert dim."""
    return (
        (r"(^|/)(w_in|w_out)$", (EXPERT_AXIS, None, None)),
    )


class _GlobalSum(torch.autograd.Function):
    """Summed over the token group forward; the cotangent times the group's
    size backward (module docstring: the step's average then gives the
    global aux's gradient)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.size = ax.size
        out = x.clone()
        dist.all_reduce(out, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def token_group(mesh=None):
    """``(axis, seq)``: this rank's token group (``data`` x ``fsdp`` x ``seq``
    of the runtime's mesh, or ``mesh``) as a ``parallel.tensor.Axis`` and the
    ``seq`` axis's size; ``(None, 1)`` without a runtime or where the group
    is this rank alone.  That case is read from the mesh's axis sizes alone,
    host ints that a TorchDynamo trace guards on (the rank's coordinates
    would break the graph)."""
    from tpuframe_torch.core.runtime import PLANES, current_runtime
    from tpuframe_torch.parallel.tensor import plane

    if mesh is None:
        try:
            mesh = current_runtime(auto_init=False).mesh
        except RuntimeError:
            return None, 1
    size = 1
    for name in PLANES["tok"]:
        size *= int(mesh.shape.get(name, 1))
    if size <= 1:
        return None, 1
    return plane("tok", mesh), int(mesh.shape.get(SEQUENCE_AXIS, 1))


def _global_routing(gate_idx: torch.Tensor, e: int, capacity: int, ax, seq: int):
    """The rank's ``(choice_exp, pos, keep)`` slots, (k·N_local,), routed
    over the token group's global order: ``gate_idx`` (B, L_local, k)
    gathered, laid out as the global (B · seq, ...) batch whose rows are
    the data shards in order and whose positions are the ``seq`` runs in
    order, then JAX's ``_routing``."""
    from tpuframe_torch.parallel.tensor import _all_gather

    b, l, k = gate_idx.shape
    shards = ax.size // seq
    got = _all_gather(gate_idx.to(torch.int32).contiguous()[None], 0, ax)  # (T, B, L, k)
    whole = got.reshape(shards, seq, b, l, k).permute(0, 2, 1, 3, 4).reshape(-1, k)
    choice_exp, pos, keep, _ = _routing(whole, e, capacity)
    n = whole.shape[0]
    shard, run = divmod(ax.index, seq)
    rows = shard * b + torch.arange(b, device=gate_idx.device)
    cols = run * l + torch.arange(l, device=gate_idx.device)
    mine = (rows[:, None] * (seq * l) + cols[None, :]).reshape(-1)
    idx = (torch.arange(k, device=gate_idx.device)[:, None] * n + mine[None, :]).reshape(-1)
    return choice_exp[idx], pos[idx], keep[idx]


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, the lower index first on ties (a stable descending sort; a
    plain ``torch.topk`` promises no order among equal values)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


class MoEMLP(nn.Module):
    """Top-k gated mixture of expert MLPs (module docstring).

    Args (JAX's, plus ``features``, ``device``):
      features: d_model.
      num_experts: E.
      mlp_ratio: hidden = d_model · mlp_ratio per expert.
      top_k: experts per token (1 = Switch, 2 = GShard's default).
      capacity_factor: per-expert slots = ``ceil(top_k · N / E) · factor``
        (cast to int); overflow slots are dropped.
      aux_loss_weight: the load-balancing loss's weight.
      dtype: compute dtype of the expert products.
      device: where the parameters live; None means ``cuda``, which raises
        without CUDA.
    """

    #: the expert axis ``shard_model`` hands over with the split weights
    tp_experts = None

    def __init__(self, features: int, num_experts: int = 8, mlp_ratio: int = 4, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.aux_loss_weight = capacity_factor, aux_loss_weight
        self.compute_dtype = dtype
        hidden = features * mlp_ratio
        self.router = Linear(features, num_experts, bias=False, compute_dtype=torch.float32,
                             device=device)
        self.w_in = nn.Parameter(torch.empty(num_experts, features, hidden, device=device))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden, features, device=device))
        #: the last forward's load-balancing loss, for the train step
        self.aux_loss: torch.Tensor | None = None

    def tp_take_split(self, attr: str, splits) -> bool:
        """Take ``w_in``/``w_out`` split over ``expert`` on the expert dim
        (``splits``: ``[(dim, Axis)]``) and run this rank's experts; False
        for any other split (it is gathered on use)."""
        if attr not in ("w_in", "w_out") or len(splits) != 1:
            return False
        dim, ax = splits[0]
        if dim != 0 or ax.name != EXPERT_AXIS:
            return False
        self.tp_experts = ax
        return True

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator, trunc_std: float) -> None:
        """flax's ``lecun_normal`` on the expert-stacked weights: a normal
        cut at two deviations of variance 1 / fan_in, where fan_in is the
        input dim times the experts (flax's receptive field)."""
        for w in (self.w_in, self.w_out):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / trunc_std
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, d = x.shape
        tokens = x.reshape(-1, d)
        n = tokens.shape[0]
        e, k = self.num_experts, min(self.top_k, self.num_experts)
        tok, seq = token_group()
        n_global = n * (tok.size if tok is not None else 1)
        capacity = max(1, int(-(-(k * n_global) // e) * self.capacity_factor))

        logits = self.router(tokens.float())
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k(probs, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        routed = None
        if tok is not None:  # (B, L, k) in the global batch's layout
            length = lead[-1] if len(lead) > 1 else 1
            routed = _global_routing(gate_idx.reshape(n // length, length, k), e, capacity,
                                     tok, seq)
        out = moe_dispatch_combine(
            tokens, gate_vals, gate_idx, self.w_in.to(self.compute_dtype),
            self.w_out.to(self.compute_dtype), capacity=capacity, act=gelu_tanh,
            routed=routed, expert_axis=self.tp_experts)

        top1 = torch.nn.functional.one_hot(gate_idx[:, 0], e).to(torch.float32)
        sums = torch.cat([top1.sum(0), probs.sum(0)])
        if tok is not None:
            sums = _GlobalSum.apply(sums, tok)
        aux = (sums[:e] / n_global * (sums[e:] / n_global)).sum() * e * self.aux_loss_weight
        self.aux_loss = aux
        return out.reshape(*lead, d).to(x.dtype)
