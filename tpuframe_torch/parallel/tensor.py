"""Tensor parallelism and stage slices on plain local tensors.

The JAX package lays a parameter over the mesh with a ``PartitionSpec`` and
lets GSPMD insert the collectives.  The port keeps one model per rank:
:func:`shard_model` replaces each parameter that a plan's rules split by
this rank's shard of it (the slice at the rank's coordinate along each
named axis) and gives the modules that hold one their split form, whose
collectives run over the axis's process group (``Runtime.groups``) on
plain tensors, so the kernels (K2-K6, through ``ctypes``) see local
tensors and K4's launch table keeps the shards' addresses.

The models declare what they can split, and this module reads it (it
imports no model): a module's ``tp_forms`` maps the torch dim a rule
splits its weight on to its form's kind (``tp_alone``: the form applies
by itself); a module's ``tp_pairs`` names the column-parallel products and
the row-parallel one that pair inside it (its ``tp_pair(axis)``, where it
has one, takes the pair over or refuses it); the model's ``tp_head`` names
its output head.  The forms (Megatron's), by the torch dim a rule splits
over ``model``:

- ``Linear`` split on its output dim (the flax kernel's ``P(None,
  model)``): column-parallel.  The replicated input enters through
  :func:`copy_to_group` (identity forward, all-reduce of the cotangent);
  the output keeps its local features.  A bias the rules leave whole is
  used as its slice of the same features (:func:`copy_to_group`, then
  narrowed: the gradient of the whole bias, summed over the ranks).
- ``Linear`` split on its input dim (``P(model, None)``): row-parallel,
  its partial products summed by :func:`reduce_from_group` (all-reduce
  forward, identity backward), then the whole bias added.
- ``SelfAttention``'s ``query``/``key``/``value`` column-parallel with
  ``attn_out`` row-parallel give each rank its local heads (the input
  copied once for the three); ``Block``'s ``mlp_in`` and ``mlp_out`` pair
  the same way.  A column or row form without its partner, or a split a
  module has no form for, is **gathered on use** instead: the whole
  parameter is rebuilt in the forward by :func:`gather_from_group`
  (all-gather forward, this rank's slice of the cotangent backward).
- An embedding table split on its rows (``P(model, None)``,
  vocab-parallel): each rank looks up the tokens it owns, zeros the rest,
  and the rows are summed by :func:`reduce_from_group`.  Split on its
  features (``P(None, model)``): the local features are gathered.
- The ViT's patch convolution split on its output channels: the local
  channels are gathered.
- The model's output head (``tp_head``) column-parallel: the logits stay
  split over the vocabulary
  (``model.tp_logits``); the train and eval steps take the loss through
  :func:`vocab_parallel_cross_entropy` and the prediction through
  :func:`split_argmax`.

Every activation between the forms is replicated over ``model``, and so
is its cotangent, so a parameter replicated in a split region (LayerNorm
scales, row-parallel biases) gets the same gradient on every rank with no
collective.

A split over ``pipe`` on the leading dim of a layer-stacked parameter is a
pipeline stage's slice (``parallel.pipeline``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Axis",
    "copy_to_group",
    "gather_from_group",
    "gathered_params",
    "plane",
    "reduce_from_group",
    "shard_model",
    "split_argmax",
    "vocab_parallel_cross_entropy",
]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None: the
    default group), its size and this rank's index along it."""

    name: str
    group: Any
    size: int
    index: int

    def copy_to_group(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`copy_to_group` over this axis (what a model calls without
        importing this module)."""
        return _Copy.apply(x, self)


def axis(name: str, mesh: Any = None) -> Axis:
    """``mesh``'s ``name`` axis for this rank (default: the runtime's mesh),
    its group from ``core.runtime.groups_for``."""
    from tpuframe_torch.core.runtime import current_runtime, groups_for, process_index

    if mesh is None:
        mesh = current_runtime(auto_init=False).mesh
    size = int(mesh.shape.get(name, 1))
    index = mesh.coords(process_index())[name]
    return Axis(name, groups_for(mesh).get(name), size, index)


def plane(key: str, mesh: Any = None) -> Axis:
    """``mesh``'s (default: the runtime's) plane ``key`` of
    ``core.runtime.PLANES`` for this rank (``"dp"``: ``data`` x ``fsdp``;
    ``"tok"``: ``data`` x ``fsdp`` x ``seq``, the token group) as one
    :class:`Axis`: its group, its size and this rank's index over the
    plane's axes in grid order."""
    from tpuframe_torch.core.runtime import PLANES, current_runtime, groups_for, process_index

    if mesh is None:
        mesh = current_runtime(auto_init=False).mesh
    at = mesh.coords(process_index())
    size, index = 1, 0
    for name in PLANES[key]:
        n = int(mesh.shape.get(name, 1))
        index, size = index * n + at[name], size * n
    return Axis(key, groups_for(mesh).get(key) if size > 1 else None, size, index)


# -- the conjugate functions -----------------------------------------------------


def _sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` summed over the group, a new tensor; a 16-bit float is summed
    in float32 and rounded once (gloo sums no bfloat16)."""
    wide = x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    wide = wide.contiguous()
    dist.all_reduce(wide, group=ax.group)
    return wide.to(x.dtype)


class _Copy(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced (summed) over the group."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, ax):
        return _sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in rank order
    (gathered as bytes, so any dtype travels)."""
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((ax.size * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out.view(-1).view(torch.uint8),
                                moved.view(-1).view(torch.uint8), group=ax.group)
    return out.movedim(0, dim)


def _narrow(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the
    (replicated) cotangent backward."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.dim, ctx.ax).contiguous(), None, None


def copy_to_group(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``ax``'s group."""
    return _Copy.apply(x, ax)


def reduce_from_group(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` summed over ``ax``'s group; the gradient passed as it is."""
    return _Reduce.apply(x, ax)


def gather_from_group(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` gathered over ``ax``'s group; the
    gradient is this rank's slice of the whole one."""
    return _Gather.apply(x, dim, ax)


# -- the split forms -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Form:
    """A module's split form: ``kind`` ``"col"``, ``"row"``, ``"vocab"``
    (an embedding's rows) or ``"features"`` (an embedding's columns), over
    ``ax``; ``bias_split`` when the bias is a shard too; ``input_copied``
    when the module's owner passes the input through :func:`copy_to_group`
    (once for several columns)."""

    kind: str
    ax: Axis
    bias_split: bool = False
    input_copied: bool = False

    def _bias(self, b: torch.Tensor | None) -> torch.Tensor | None:
        if b is None or self.bias_split:
            return b
        return _narrow(copy_to_group(b, self.ax), 0, self.ax)

    def linear(self, w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor
               ) -> torch.Tensor:
        """A ``Linear``'s forward: column- or row-parallel."""
        if self.kind == "col":
            if not self.input_copied:
                x = copy_to_group(x, self.ax)
            return F.linear(x, w, self._bias(b))
        y = reduce_from_group(F.linear(x, w), self.ax)
        return y if b is None else y + b

    def embed(self, w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """An embedding's lookup: vocab-parallel or split on the features."""
        if self.kind == "features":
            return gather_from_group(F.embedding(tokens, w), -1, self.ax)
        rows = w.shape[0]
        local = tokens - self.ax.index * rows
        mine = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(mine, local, torch.zeros_like(local)), w)
        out = out * mine.unsqueeze(-1).to(out.dtype)
        return reduce_from_group(out, self.ax)

    def conv(self, w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor, stride
             ) -> torch.Tensor:
        """A convolution split on its output channels (NCHW): the local
        channels, gathered."""
        y = F.conv2d(copy_to_group(x, self.ax) if x.requires_grad else x, w, self._bias(b),
                     stride)
        return gather_from_group(y, 1, self.ax)


# -- applying a plan -------------------------------------------------------------


def flax_path(model: nn.Module, name: str) -> str:
    """The flax path of ``model``'s parameter ``name`` (``models.interop``'s
    naming): ``block0.attn.query.weight`` -> ``block0/attn/query/kernel``,
    an embedding's ``weight`` -> ``embedding``, a BatchNorm's ``weight`` ->
    ``scale``."""
    *mods, attr = name.split(".")
    owner = model.get_submodule(".".join(mods)) if mods else model
    if attr == "weight":
        if isinstance(owner, nn.Embedding):
            attr = "embedding"
        elif isinstance(owner, (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)):
            attr = "scale"
        else:
            attr = "kernel"
    return "/".join(mods + [attr])


def _orders(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """``sharding.flax_orders`` with the layer-stacked parameters of a
    pipelined model (a leading layer dim before the module's own)."""
    from tpuframe_torch.parallel.sharding import flax_orders

    orders = flax_orders(model)
    for name, p in model.named_parameters():
        if name not in orders and getattr(model, "stacked_prefix", None) and \
                name.startswith(model.stacked_prefix):
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(mod, nn.Linear) and p.ndim == 3:
                orders[name] = (0, 2, 1)
    return orders


def _splits(spec: tuple, mesh: Any) -> list[tuple[int, str]]:
    """``(dim, axis)`` for each dim a torch spec names an axis above 1 on."""
    shape = mesh.shape
    out = []
    for dim, entry in enumerate(spec):
        for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if int(shape.get(name, 1)) > 1:
                out.append((dim, name))
    return out


def shard_model(model: nn.Module, plan: Any) -> dict[str, list[tuple[int, str]]]:
    """Replace each of ``model``'s parameters that ``plan``'s rules split
    (over ``pipe``, ``expert`` or ``model``, above 1) by this rank's shard, give the
    modules their split forms (module docstring), and return the layout
    ``{parameter name: [(torch dim, axis), ...]}``, kept as
    ``model.tp_layout`` (and the plan's mesh as ``model.tp_mesh``).  Every
    rank of the mesh calls this; a model that has a layout already is
    returned as it is."""
    if getattr(model, "tp_layout", None) is not None:
        return model.tp_layout
    mesh = plan.mesh
    orders = _orders(model)
    layout: dict[str, list[tuple[int, str]]] = {}
    stacked = getattr(model, "stacked_prefix", None)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            spec = plan.param_spec(flax_path(model, name), tuple(p.shape), orders.get(name))
            splits = _splits(spec, mesh)
            if not splits:
                continue
            if stacked and name.startswith(stacked) and splits != [(0, "pipe")]:
                raise NotImplementedError(
                    f"{name}: a layer-stacked parameter splits over the pipe axis on its layer "
                    f"dim only, got {splits}; tensor-parallel rules inside the pipeline's "
                    "stages are not ported (ROADMAP.md, Queue 1 item 7)")
            if not stacked and any(a == "pipe" for _, a in splits):
                raise ValueError(f"{name}: only a pipelined model's layer-stacked parameters "
                                 "split over the pipe axis")
            local = p.data
            for dim, ax_name in splits:
                ax = axis(ax_name, mesh)
                if local.shape[dim] % ax.size:
                    raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does not split "
                                     f"{ax.size} ways over {ax_name}")
                local = _narrow(local, dim, ax)
            *mods, attr = name.split(".")
            owner = model.get_submodule(".".join(mods)) if mods else model
            # a copy: a slice along dim 0 would keep the whole tensor's storage
            owner._parameters[attr] = nn.Parameter(
                local.clone(memory_format=torch.contiguous_format),
                requires_grad=p.requires_grad)
            layout[name] = splits
    model.tp_layout, model.tp_mesh = layout, mesh
    model.tp_gathered = {}
    model.tp_logits = None

    def split_of(mod_name: str, attr: str = "weight"):
        key = f"{mod_name}.{attr}" if mod_name else attr
        s = layout.get(key)
        return s[0] if s and len(s) == 1 and s[0][1] == "model" else ("other" if s else None)

    forms: dict[str, Form] = {}
    for mod_name, mod in model.named_modules():
        s = split_of(mod_name)
        kinds = getattr(mod, "tp_forms", None)
        if kinds is None or s is None or s == "other" or (
                stacked and mod_name.startswith(stacked.rstrip("."))):
            continue
        bias = split_of(mod_name, "bias")
        bias_split = bias not in (None, "other") and bias[0] == 0
        kind = kinds.get(s[0])
        if kind is not None and not (kind == "row" and bias_split):
            forms[mod_name] = Form(kind, axis("model", mesh), bias_split)
    # the pairs the modules declare; a column or row form without its
    # partner (or that its owner refuses) is gathered on use
    keep: set[str] = set()
    for mod_name, mod in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        for cols, row in getattr(mod, "tp_pairs", ()):
            f_cols, f_row = [forms.get(pre + n) for n in cols], forms.get(pre + row)
            if not all(f is not None and f.kind == "col" for f in f_cols) or f_row is None \
                    or f_row.kind != "row":
                continue
            take = getattr(mod, "tp_pair", None)
            if take is not None:
                if not take(f_row.ax):
                    continue
                for n in cols:  # the owner copies the input once for them
                    forms[pre + n] = dataclasses.replace(forms[pre + n], input_copied=True)
            keep.update(pre + n for n in (*cols, row))
    # the output head whose logits may stay split
    head = getattr(model, "tp_head", None)
    if head is not None and forms.get(head) is not None and forms[head].kind == "col":
        keep.add(head)
        model.tp_logits = forms[head].ax
    for mod_name, form in forms.items():
        mod = model.get_submodule(mod_name)
        if getattr(mod, "tp_alone", False) or mod_name in keep:
            mod.tp = form
    # a split a module runs itself (MoE's experts over the expert axis)
    owned = set()
    for name, splits in layout.items():
        *mods, attr = name.split(".")
        mod = model.get_submodule(".".join(mods)) if mods else model
        take = getattr(mod, "tp_take_split", None)
        if take is not None and take(attr, [(dim, axis(a, mesh)) for dim, a in splits]):
            owned.add(name)
    # every other split parameter is gathered on use
    for name, splits in layout.items():
        if (stacked and name.startswith(stacked)) or name in owned:
            continue
        mod_name = name.rsplit(".", 1)[0] if "." in name else ""
        form = getattr(model.get_submodule(mod_name), "tp", None) if mod_name else None
        attr = name.rsplit(".", 1)[-1]
        if form is not None and (attr == "weight" or form.bias_split):
            continue
        model.tp_gathered[name] = [(dim, axis(a, mesh)) for dim, a in splits]
    return layout




def gathered_params(model: nn.Module, params: Mapping[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """``params`` (by name) with every parameter that ``model`` gathers on
    use rebuilt whole (:func:`gather_from_group`); the others as they are."""
    gathered = getattr(model, "tp_gathered", None)
    if not gathered:
        return dict(params)
    out = dict(params)
    for name, splits in gathered.items():
        if name in out:
            t = out[name]
            for dim, ax in splits:
                t = gather_from_group(t, dim, ax)
            out[name] = t
    return out


def full_tensor(t: torch.Tensor, splits: list[tuple[int, str]], mesh: Any = None
                ) -> torch.Tensor:
    """A shard gathered into the whole tensor over ``mesh`` (default: the
    runtime's; every rank of the axes calls this)."""
    for dim, name in splits:
        t = _all_gather(t.detach(), dim, axis(name, mesh))
    return t


def grad_sq(model: nn.Module) -> torch.Tensor:
    """The summed squares of the whole gradients of a split model: each
    parameter split over an axis summed over that axis's group, each
    replicated one counted once (the global norm's square, the same on
    every rank)."""
    layout = getattr(model, "tp_layout", None) or {}
    parts: dict[str, list[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            key = "+".join(a for _, a in layout.get(name, ()))
            parts.setdefault(key, []).append(p.grad)
    device = next(model.parameters()).device
    total = torch.zeros((), dtype=torch.float32, device=device)
    for key, grads in sorted(parts.items()):
        sq = torch.stack([n.float() for n in torch._foreach_norm(grads)]).square().sum()
        for name in key.split("+") if key else ():
            sq = _sum(sq, axis(name, model.tp_mesh))
        total = total + sq
    return total


# -- the loss and the prediction over split logits -------------------------------


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy of logits split over the vocabulary (module docstring
    of :func:`vocab_parallel_cross_entropy`)."""

    @staticmethod
    def forward(ctx, logits, labels, ax):
        from tpuframe_torch.ops.cross_entropy import cross_entropy_fwd

        rows = logits.shape[-1]
        local = labels - ax.index * rows
        mine = (local >= 0) & (local < rows)
        safe = torch.where(mine, local, torch.zeros_like(local))
        _, stats = cross_entropy_fwd(logits, safe, with_stats=True)  # K2a
        m = stats[:, 0].contiguous()
        m_all = m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=ax.group)
        picked = torch.gather(logits, 1, safe[:, None].long())[:, 0].float()
        packed = torch.stack([torch.exp(m - m_all) / stats[:, 1],
                              torch.where(mine, picked, torch.zeros_like(picked))])
        dist.all_reduce(packed, group=ax.group)
        total = packed[0]
        loss = m_all + torch.log(total) - packed[1]
        ctx.ax = ax
        ctx.save_for_backward(logits, torch.where(mine, local, torch.full_like(local, -1)),
                              torch.stack([m_all, 1.0 / total], 1).contiguous())
        return loss

    @staticmethod
    def backward(ctx, g):
        from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd

        logits, local, stats = ctx.saved_tensors
        # K2b on the shard from the global statistics; a label another rank
        # owns is -1 here, so no column of this shard takes its one-hot
        return cross_entropy_bwd(logits, local, g.float(), stats), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ax: Axis
                                 ) -> torch.Tensor:
    """Per-example softmax cross entropy of (N, V / size) logits, this
    rank's columns of the vocabulary, against (N,) global labels: K2a's row
    statistics of the shard make the global log-sum-exp with one all-reduce
    of the maxima and one of the rescaled sums (beside the label's logit,
    which the rank that owns it contributes); the backward runs K2b on the
    shard from the global statistics.  The losses are the same on every
    rank of the group."""
    return _VocabParallelCE.apply(logits.contiguous(), labels.contiguous(), ax)


@torch.no_grad()
def split_argmax(logits: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The global argmax over the last dim of logits split over it: each
    rank's best and its global column, gathered; the first maximum wins,
    as ``argmax`` takes it."""
    best, idx = logits.float().max(-1)
    idx = idx + ax.index * logits.shape[-1]
    vals = _all_gather(best.unsqueeze(0), 0, ax)
    cols = _all_gather(idx.unsqueeze(0), 0, ax)
    return torch.gather(cols, 0, vals.argmax(0, keepdim=True))[0]
