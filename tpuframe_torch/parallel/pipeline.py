"""Pipeline parallelism: a GPipe schedule over the ``pipe`` mesh axis.

Port of ``tpuframe/parallel/pipeline.py``.  The JAX package runs every
stage as one SPMD program under ``shard_map`` and scans M + S - 1 ticks,
the activations hopping by ``ppermute``.  The port keeps one stage a rank
(its slice of the layer-stacked parameters, split over ``pipe`` by
``compose``'s pipeline rule) and runs the same GPipe schedule of M + S - 1
ticks eagerly: at tick t stage s runs microbatch t - s (where that is one
of the M) and hands its output to stage s + 1, which runs it at tick t + 1.
Stages that would only compute the JAX scan's discarded fill and drain
values skip them, so the values and gradients are the scan's.

**The hop** is :class:`_Hop`, a ``torch.autograd.Function`` whose forward
sends stage i's output to stage i + 1 and whose backward sends the
cotangent back, each as one ``all_to_all_single`` over the pipe group
whose splits are zero except for the neighbour (the bytes of the tensor,
so any dtype travels).  ``all_to_all_single`` is a collective gloo carries
on CUDA tensors; point-to-point sends it does not (ROADMAP.md, sandbox
facts), so ``dist.send`` and ``torch.distributed.pipelining``'s P2P
schedules cannot run between the ranks of one card.  Every rank of the
group calls the hop at every tick where some stage sends, in one order;
the hops of a rank are chained through a scalar token, so the backward
reaches each of them on every rank, in the reverse order.

**The ends.**  The input enters every stage through ``copy_to_group``
(stage 0 alone reads it; the cotangent summed over the stages is stage 0's
on every rank, as the transpose of JAX's replicated input), and the
outputs, which only the last stage has, are summed over the group
(``reduce_from_group``: zeros from the other stages, the cotangent passed
as it is, so nothing is scaled by S).  So the embedding and the head of
:class:`PipelinedTransformerLM` run on every stage, as in the JAX model,
and their gradients are JAX's on every rank.

**The schedules** (:data:`PP_SCHEDULES`) give bit-equal values and
gradients: ``interleaved`` issues each hop asynchronously and waits only
where a stage reads what it brings (stage 0 computes its next microbatch
while its output travels); ``barriered`` waits for every hop at the end of
its tick (JAX's ``_tick_barrier``); ``1f1b`` recomputes each stage in the
backward (``torch.utils.checkpoint``), so a stage keeps only its inputs.

Bubble fraction is (S - 1) / (M + S - 1).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpuframe_torch.core.runtime import (
    DATA_AXIS,
    FSDP_AXIS,
    PIPELINE_AXIS,
    current_runtime,
    resolve_device,
)
from tpuframe_torch.parallel.comms_env import PP_SCHEDULE_CHOICES, pp_microbatches, pp_schedule
from tpuframe_torch.parallel.tensor import Axis, copy_to_group, reduce_from_group
from tpuframe_torch.parallel.tensor import axis as mesh_axis

__all__ = [
    "PP_SCHEDULES",
    "PipelinedTransformerLM",
    "gpipe_spmd",
    "pipeline_param_spec",
    "stack_stage_params",
]

#: the hop/compute policies :func:`gpipe_spmd` runs (module docstring)
PP_SCHEDULES = PP_SCHEDULE_CHOICES


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    if isinstance(tree, Mapping):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def stack_stage_params(per_stage: list) -> Any:
    """``[stage0_params, stage1_params, ...]`` -> one tree whose leaves are
    stacked on a leading stage dim (what :func:`gpipe_spmd` takes)."""
    first = per_stage[0]
    if isinstance(first, Mapping):
        return {k: stack_stage_params([p[k] for p in per_stage]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in per_stage])
                           for i in range(len(first)))
    return torch.stack(per_stage)


def pipeline_param_spec(stage_params: Any, axis: str = PIPELINE_AXIS) -> Any:
    """The spec tree placing each leaf's stage dim on ``axis``."""
    return _tree_map(lambda a: (axis,) + (None,) * (a.ndim - 1), stage_params)


# -- the hop ---------------------------------------------------------------------


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


class _Hop(torch.autograd.Function):
    """One tick's hop (module docstring).  ``y`` is this stage's output
    when it sends one (else an empty placeholder); ``like`` the shape and
    dtype a received activation has.  Returns ``(received, token)``; the
    all-to-all is left in flight when ``pending`` is a list (its work is
    appended), else waited for."""

    @staticmethod
    def forward(ctx, y, token, ax: Axis, sends: bool, receives: bool, like: torch.Tensor,
                pending):
        s, n = ax.index, like.numel() * like.element_size()
        # the received tensor is the output itself, not a view: an async
        # collective writes into it after this returns
        got = torch.empty(like.shape if receives else (0,), dtype=like.dtype,
                          device=like.device)
        out = got.view(-1).view(torch.uint8)
        inp = _bytes(y) if sends else torch.empty(0, dtype=torch.uint8, device=like.device)
        in_splits, out_splits = [0] * ax.size, [0] * ax.size
        if sends:
            in_splits[s + 1] = n
        if receives:
            out_splits[s - 1] = n
        work = dist.all_to_all_single(out, inp, out_splits, in_splits, group=ax.group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        ctx.ax, ctx.sends, ctx.receives, ctx.n = ax, sends, receives, n
        ctx.shape, ctx.dtype = like.shape, like.dtype
        return got, token.clone()

    @staticmethod
    def backward(ctx, g_got, g_token):
        ax, s, n = ctx.ax, ctx.ax.index, ctx.n
        device = g_token.device
        inp = torch.empty(0, dtype=torch.uint8, device=device)
        if ctx.receives:
            g = g_got if g_got is not None else torch.zeros(ctx.shape, dtype=ctx.dtype,
                                                            device=device)
            inp = _bytes(g.to(ctx.dtype))
        g_y = torch.empty(ctx.shape if ctx.sends else (0,), dtype=ctx.dtype, device=device)
        in_splits, out_splits = [0] * ax.size, [0] * ax.size
        if ctx.receives:
            in_splits[s - 1] = n
        if ctx.sends:
            out_splits[s + 1] = n
        dist.all_to_all_single(g_y.view(-1).view(torch.uint8), inp, out_splits, in_splits,
                               group=ax.group)
        return g_y if ctx.sends else None, g_token, None, None, None, None, None


class _Token(torch.autograd.Function):
    """A zero scalar tied to ``x``: the chain of hops starts at the input,
    so the input's ``copy_to_group`` backward runs on every stage."""

    @staticmethod
    def forward(ctx, x):
        ctx.meta = (x.shape, x.dtype)
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.meta
        return torch.zeros(shape, dtype=dtype, device=g.device)


class _Join(torch.autograd.Function):
    """``out`` as it is, with the last token as a second input, so the
    backward of the output reaches the chain of hops on every stage."""

    @staticmethod
    def forward(ctx, out, token):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


def _sends_at(t: int, stage: int, n_micro: int) -> bool:
    """Whether ``stage`` runs a microbatch at tick ``t``."""
    return 0 <= t - stage < n_micro


def _schedule(stage_fn: Callable, params: Any, x: torch.Tensor, ax: Axis, schedule: str
              ) -> torch.Tensor:
    """GPipe over ``ax``: this rank's stage of M + S - 1 ticks."""
    n_stages, s, n_micro = ax.size, ax.index, x.shape[0]
    last = n_stages - 1
    x = copy_to_group(x, ax)
    # the chain needs a gradient on every stage, whether or not x has one
    token = (_Token.apply(x) if x.requires_grad
             else torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled()))
    like = x[0].detach()
    state, pending, outs = None, [] if schedule == "interleaved" else None, []
    for t in range(n_micro + n_stages - 1):
        y_out = None
        if _sends_at(t, s, n_micro):
            if s == 0:
                y_in = x[t]
            else:
                for work in pending or ():
                    work.wait()
                if pending:
                    pending.clear()
                y_in = state
            y_out = stage_fn(params, y_in)
            if s == last:
                outs.append(y_out)
        if not any(_sends_at(t, i, n_micro) for i in range(last)):
            continue  # no stage hands anything on at this tick
        for work in pending or ():  # gloo runs one group's collectives in order
            work.wait()
        if pending:
            pending.clear()
        sends = s < last and y_out is not None
        receives = s > 0 and _sends_at(t, s - 1, n_micro)
        state, token = _Hop.apply(y_out if sends else like.new_empty(0), token, ax, sends,
                                  receives, like, pending)
    for work in pending or ():
        work.wait()
    out = torch.stack(outs) if s == last else torch.zeros_like(x.detach())
    return _Join.apply(reduce_from_group(out, ax), token)


def gpipe_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
               x: torch.Tensor, *, mesh=None, axis: str = PIPELINE_AXIS,
               batch_axes: tuple = (DATA_AXIS, FSDP_AXIS), remat_stages: bool = False,
               schedule: str = "interleaved") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage GPipe pipeline over the mesh's pipe
    axis (S = its size; ``axis`` names another).

    Args:
      stage_fn: ``(params_s, y) -> y``, one stage; it keeps the
        activation's shape and dtype.
      stage_params: a tree whose leaves carry a leading stage dim: this
        rank's stage (dim 1) under a pipe axis of S > 1, every stage
        (dim S) without one.
      x: this rank's microbatched input ``(M, micro, ...)``, the same on
        every stage; ``M >= S``.
      batch_axes: the axes that split ``micro`` (the JAX signature's; each
        rank passes its own rows).
      remat_stages: recompute each stage in the backward.
      schedule: one of :data:`PP_SCHEDULES` (module docstring).

    Returns the ``(M, micro, ...)`` outputs on every stage, equal to
    applying the stages in order to each microbatch."""
    del batch_axes
    name = axis
    if schedule not in PP_SCHEDULES:
        raise ValueError(f"schedule must be one of {PP_SCHEDULES}, got {schedule!r}")
    fn = stage_fn
    if remat_stages or schedule == "1f1b":
        def fn(params, y):
            return checkpoint(stage_fn, params, y, use_reentrant=False)
    mesh = mesh if mesh is not None else current_runtime(auto_init=False).mesh
    n_stages = int(mesh.shape.get(name, 1))
    if n_stages == 1:
        n_local = _first_leaf(stage_params).shape[0]

        def seq(y):
            for i in range(n_local):
                y = fn(_tree_map(lambda a: a[i], stage_params), y)
            return y

        return torch.stack([seq(mb) for mb in x.unbind(0)])
    if x.shape[0] < n_stages:
        raise ValueError(f"n_microbatches ({x.shape[0]}) must be >= pipeline stages "
                         f"({n_stages}); the pipeline can't even fill")
    if _first_leaf(stage_params).shape[0] != 1:
        raise ValueError("under a pipe axis each rank passes its own stage: stage_params' "
                         f"leading dim must be 1, got {_first_leaf(stage_params).shape[0]}")
    return _schedule(fn, _tree_map(lambda a: a[0], stage_params), x, mesh_axis(name, mesh),
                     schedule)


# -- the pipelined LM ------------------------------------------------------------


class EmbedHead(nn.Module):
    """The pipelined LM's ends: token and position embeddings, the final
    LayerNorm and the untied head (the JAX ``EmbedHead``'s names)."""

    def __init__(self, vocab: int, max_len: int, d: int, dtype: torch.dtype, device):
        super().__init__()
        from tpuframe_torch.models.resnet import Linear
        from tpuframe_torch.models.transformer import Embed
        from tpuframe_torch.ops.layer_norm import FusedLayerNorm

        self.embed = Embed(vocab, d, compute_dtype=dtype, device=device)
        self.pos_embed = Embed(max_len, d, compute_dtype=dtype, device=device)
        self.ln_f = FusedLayerNorm(d, dtype=dtype, device=device)
        self.lm_head = Linear(d, vocab, bias=False, compute_dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self.embed(tokens) + self.pos_embed(positions)[None]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(x)).to(torch.float32)


class PipelinedTransformerLM(nn.Module):
    """Decoder LM whose blocks run as a GPipe pipeline: the
    ``TransformerLM``'s math (pre-norm blocks, learned positions, untied
    head) with the layers grouped into the pipe axis's stages.

    ``embed_head`` holds the ends (:class:`EmbedHead`); ``blocks`` is one
    ``Block`` whose parameters are layer-stacked, ``(num_layers, ...)`` at
    full shape, this rank's ``(num_layers / S, ...)`` once
    ``create_train_state`` applies a plan with the pipeline rule.  A batch
    ``(B, L)`` is split into ``n_microbatches`` along B: the value given,
    else ``TPUFRAME_PP_MICROBATCHES``, else 4 (at most B); ``schedule`` the
    value given, else ``TPUFRAME_PP_SCHEDULE``.  ``remat`` recomputes each
    stage in the backward.  Attention is the full path, as in the JAX
    model.  ``device`` and ``seed`` as ``TransformerLM``'s."""

    stacked_prefix = "blocks."
    tp_head = "embed_head.lm_head"

    def __init__(self, vocab_size: int, num_layers: int = 4, num_heads: int = 8,
                 head_dim: int = 32, max_len: int = 2048, mlp_ratio: int = 4,
                 n_microbatches: int | None = None, dtype: torch.dtype = torch.float32,
                 remat: bool = False, schedule: str | None = None, *, device=None,
                 seed: int = 0):
        super().__init__()
        from tpuframe_torch.models.transformer import TransformerLM

        if schedule is not None and schedule not in PP_SCHEDULES:
            raise ValueError(f"schedule must be one of {PP_SCHEDULES}, got {schedule!r}")
        device = resolve_device(device)
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.n_microbatches, self.schedule = n_microbatches, schedule
        self.compute_dtype, self.remat = dtype, bool(remat)
        self.dropout, self.dropout_generator = 0.0, None
        # a one-layer-per-block TransformerLM gives flax's initializers; its
        # modules are taken apart into the ends and the stacked blocks
        ref = TransformerLM(vocab_size, num_layers, num_heads, head_dim, max_len, mlp_ratio,
                            attn_impl="full", dtype=dtype, device=device, seed=seed)
        d = num_heads * head_dim
        self.embed_head = EmbedHead(vocab_size, max_len, d, dtype, device)
        for name in ("embed", "pos_embed", "ln_f", "lm_head"):
            setattr(self.embed_head, name, getattr(ref, name))
        self.blocks = ref.block0
        with torch.no_grad():
            for name, p in list(self.blocks.named_parameters()):
                *mods, attr = name.split(".")
                owner = self.blocks.get_submodule(".".join(mods)) if mods else self.blocks
                layers = [ref.get_parameter(f"block{i}.{name}") for i in range(num_layers)]
                owner._parameters[attr] = nn.Parameter(torch.stack(layers))
        self.eval()

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run every product, gather and LayerNorm output in ``dtype``."""
        from tpuframe_torch.models.resnet import Linear
        from tpuframe_torch.models.transformer import Embed
        from tpuframe_torch.ops.layer_norm import FusedLayerNorm

        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, (Linear, Embed)):
                m.compute_dtype = dtype
            elif isinstance(m, FusedLayerNorm):
                m.dtype = dtype

    def _stage_fn(self, stage_p: Mapping[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        for i in range(_first_leaf(stage_p).shape[0]):
            y = functional_call(self.blocks, {n: a[i] for n, a in stage_p.items()}, (y,))
        return y

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_head(tokens)
        stacked = dict(self.blocks.named_parameters())
        layout = getattr(self, "tp_layout", None) or {}
        split = any(a == PIPELINE_AXIS for name, s in layout.items()
                    if name.startswith(self.stacked_prefix) for _, a in s)
        pipe = mesh_axis(PIPELINE_AXIS, self.tp_mesh) if split else None
        n_stages = pipe.size if split else 1
        n_local = _first_leaf(stacked).shape[0]
        if n_local * n_stages != self.num_layers:
            raise ValueError(f"num_layers={self.num_layers} must divide into {n_stages} "
                             "pipeline stages")
        b = x.shape[0]
        n_micro = self.n_microbatches if self.n_microbatches is not None else (
            pp_microbatches() or 4)
        m = min(n_micro, b)
        if b % m:
            raise ValueError(f"batch size {b} must be divisible by n_microbatches={m}")
        schedule = self.schedule or pp_schedule()
        if n_stages == 1:
            # every layer here: the stages in order, the whole batch at once
            fn = self._stage_fn
            if self.remat or schedule == "1f1b":
                x = checkpoint(fn, stacked, x, use_reentrant=False)
            else:
                x = fn(stacked, x)
        else:
            micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
            stage = {k: v[None] for k, v in stacked.items()}  # this rank's stage
            out = gpipe_spmd(self._stage_fn, stage, micro, mesh=self.tp_mesh,
                             remat_stages=self.remat, schedule=schedule)
            x = out.reshape((b,) + tuple(out.shape[2:]))
        return self.embed_head.head(x)
