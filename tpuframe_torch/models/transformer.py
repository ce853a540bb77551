"""Decoder-only transformer LM: (B, L) int tokens -> (B, L, vocab) logits.

Port of ``tpuframe/models/transformer.py`` for one card.  Module names
follow the JAX tree (``embed``, ``pos_embed``, ``block{i}`` with ``ln1``,
``attn`` (``query``, ``key``, ``value``, ``attn_out``), ``ln2``, ``mlp_in``,
``mlp_out``; ``ln_f``, ``lm_head``), so ``models.interop`` maps the JAX
parameters one to one.

The dtype flow is the JAX model's: flax ``Dense(dtype=...)`` and
``Embed(dtype=...)`` cast kernel, bias and table to the compute dtype
before the product or gather, so the residual stream runs in it; every
LayerNorm (``ops.layer_norm.FusedLayerNorm``, kernels K3a and K3b on the
card) outputs it; GELU is the tanh form (flax's ``nn.gelu`` default); the
logits are cast to float32 at the end.

Attention (``attn_impl``): ``"full"`` is ``ops.ring_attention.
attention_reference``, which scales, masks and softmaxes in the compute
dtype; ``"blockwise"`` is ``ops.blockwise_attention`` (kernels K6a-K6c on
the card), memory linear in L; ``"ring"`` is ``ops.ring_attention``'s ring
over the ``seq`` axis and ``"ulysses"`` ``ops.ulysses``'s all-to-all form,
both K6 tiles on the card; ``"auto"`` takes the ring when the runtime's mesh
splits ``seq``, else blockwise at ``_BLOCKWISE_AUTO_LEN`` (4096) tokens or
more and full below.  JAX's ``auto`` first asks its kernel ledger for a
measured verdict and falls back to this static rule without one; the port
has no ledger yet, so it always takes the rule.

**Sequence parallelism.**  Under a mesh that splits ``seq`` over n ranks a
rank holds its run of L / n positions (the train steps cut it from the
batch): the positional embedding takes the global positions ``seq_index ·
L_local + arange(L_local)``, and attention must be ``"ring"`` or
``"ulysses"`` (or ``"auto"``).  ``"full"`` and ``"blockwise"`` would attend
within the run alone, so they raise there; JAX's gather the sequence
(ROADMAP.md, Queue 3).

**MoE** (``moe_experts > 0``): every block's MLP is ``models.moe.MoEMLP``
under the flax name ``moe``; each forward leaves its load-balancing loss in
the MoE modules' ``aux_loss``, which the train step adds to the objective
(JAX's ``aux_loss`` collection).

``dropout`` (flax ``nn.Dropout``) drops after attention and after the MLP
in train mode (``module.training``) with probability ``rate`` and scales
what it keeps by ``1 / (1 - rate)``; in eval mode it does nothing.  Its
masks are drawn from the ``torch.Generator`` in the model's
``dropout_generator``, which the train steps set for each step (``train.
step``: derived from the state's generator, the step, the rank and the
microbatch, as JAX's ``state.step_rng("dropout")``); a train-mode forward
with dropout and no generator raises, as flax does without a ``dropout``
rng.

``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant): JAX's ``RematBlock =
nn.remat(Block)``.  The recompute takes the block's parameters as they were
in the forward (the cast ones under a bf16 policy) and the generator state
the block started from, so it reproduces the forward bit for bit, dropout
masks included.

Initializers draw flax's distributions from a seeded ``torch.Generator``:
``Dense`` kernels LeCun-normal (a normal truncated at two standard
deviations, scaled by 1 / 0.8796 so the variance is 1 / fan_in), biases
zero, ``Embed`` tables normal with variance 1 / features, LayerNorm scale
one and bias zero.

"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpuframe_torch.core.runtime import MODEL_AXIS, SEQUENCE_AXIS, current_runtime, resolve_device
from tpuframe_torch.models.moe import MoEMLP
from tpuframe_torch.models.resnet import Linear
from tpuframe_torch.ops.blockwise_attention import blockwise_attention
from tpuframe_torch.ops.layer_norm import FusedLayerNorm
from tpuframe_torch.ops.ring_attention import _ring, attention_reference, mesh_axis
from tpuframe_torch.ops.ulysses import _ulysses

__all__ = ["Block", "Dropout", "SelfAttention", "TransformerLM", "remat_call",
           "transformer_tp_rules"]

#: attn_impl="auto" switches full -> blockwise at this unsharded length
_BLOCKWISE_AUTO_LEN = 4096
#: flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def transformer_tp_rules():
    """The plan's tensor-parallel rules (Megatron's pairing, as the JAX
    package declares them): ``query``/``key``/``value`` and ``mlp_in``
    column-parallel, ``attn_out`` and ``mlp_out`` row-parallel, the
    embedding tables split on their features and ``lm_head`` on the
    vocabulary, over ``model``.  Specs name the flax layout's dims."""
    return (
        (r"(query|key|value)/kernel", (None, MODEL_AXIS)),
        (r"attn_out/kernel", (MODEL_AXIS, None)),
        (r"mlp_in/kernel", (None, MODEL_AXIS)),
        (r"mlp_out/kernel", (MODEL_AXIS, None)),
        (r"embed/embedding", (None, MODEL_AXIS)),
        (r"lm_head/kernel", (None, MODEL_AXIS)),
    )


def _seq_split():
    """The runtime mesh's ``seq`` axis for this rank where it is above 1,
    else None (no runtime, or no split)."""
    try:
        mesh = current_runtime(auto_init=False).mesh
    except RuntimeError:
        return None
    return mesh_axis(SEQUENCE_AXIS, mesh) if int(mesh.shape.get(SEQUENCE_AXIS, 1)) > 1 else None


class Embed(nn.Embedding):
    """flax ``Embed``: the table cast to ``compute_dtype``, then gathered
    (vocab-parallel, or split on the features, once a plan splits it:
    ``parallel.tensor``)."""

    #: the split form ``parallel.tensor.shard_model`` gives it, or None
    tp = None
    #: the form it takes by the dim a plan splits its table on, applied alone
    tp_forms, tp_alone = {0: "vocab", 1: "features"}, True

    def __init__(self, num_embeddings: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(num_embeddings, features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.embed(self.weight.to(self.compute_dtype), tokens)
        return F.embedding(tokens, self.weight.to(self.compute_dtype))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` (a uniform draw below it) and scaled by
    ``1 / (1 - rate)``, else zeroed; in eval mode, or at rate 0, the input
    as it is.  The masks come from the ``generator`` the caller hands in.
    ``broadcast_dims`` are the dims one draw covers (flax's, so
    ``(2, 3)`` on NCHW maps drops whole channels, ``Dropout2d``)."""

    def __init__(self, rate: float, broadcast_dims: tuple[int, ...] = ()):
        super().__init__()
        self.rate = float(rate)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(
                f"dropout {self.rate} in train mode needs a generator (the train steps set the "
                "model's dropout_generator; flax needs a 'dropout' rng)")
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    """Multi-head self-attention: full or blockwise on one card, the ring or
    Ulysses over the ``seq`` axis; under a plan that splits
    ``query``/``key``/``value`` by columns and ``attn_out`` by rows
    (``tp_heads``, the ``model`` axis), over this rank's heads."""

    #: the model axis the heads are split over, or None
    tp_heads = None
    #: the column-parallel products and the row-parallel one that pair
    tp_pairs = ((("query", "key", "value"), "attn_out"),)

    def __init__(self, features: int, num_heads: int, head_dim: int, *, causal: bool = True,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if attn_impl not in ("auto", "full", "ring", "ulysses", "blockwise"):
            raise ValueError(
                f"unknown attn_impl {attn_impl!r}; known: auto, full, ring, ulysses, blockwise")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal, self.attn_impl = causal, attn_impl
        inner = num_heads * head_dim
        dense = dict(bias=False, compute_dtype=dtype, device=device)
        for name in ("query", "key", "value"):
            self.add_module(name, Linear(features, inner, **dense))
        self.attn_out = Linear(inner, features, **dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        impl, seq = self.attn_impl, _seq_split()
        if impl == "auto":
            impl = "ring" if seq is not None else (
                "blockwise" if l >= _BLOCKWISE_AUTO_LEN else "full")
        if impl in ("ring", "ulysses") and seq is None:
            seq = mesh_axis(SEQUENCE_AXIS)  # raises without a runtime mesh
        elif seq is not None and impl not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_impl={impl!r} under a seq split of {seq.size} would attend within this "
                "rank's run of positions alone; take 'ring', 'ulysses' or 'auto'")
        n_heads = self.num_heads
        if self.tp_heads is not None:  # one all-reduce of the cotangent for q, k and v
            n_heads //= self.tp_heads.size
            x = self.tp_heads.copy_to_group(x)
        heads = (b, l, n_heads, self.head_dim)
        q = self.query(x).reshape(heads)
        k = self.key(x).reshape(heads)
        v = self.value(x).reshape(heads)
        if impl == "ring":
            out = _ring(q, k, v, seq, self.causal)
        elif impl == "ulysses":
            out = _ulysses(q, k, v, seq, self.causal)
        elif impl == "blockwise":
            out = blockwise_attention(q, k, v, causal=self.causal)
        else:
            out = attention_reference(q, k, v, causal=self.causal)
        return self.attn_out(out.reshape(b, l, -1))

    def tp_pair(self, ax) -> bool:
        """Take the pair of :attr:`tp_pairs` over ``ax`` (a
        ``parallel.tensor.Axis``): run this rank's heads, the input passed
        through ``ax.copy_to_group`` once for the three columns.  False
        (the pair is gathered on use) when the heads do not divide."""
        if self.num_heads % ax.size:
            return False
        self.tp_heads = ax
        return True


class Block(nn.Module):
    """Pre-norm block: LN -> attention -> dropout -> +residual, LN -> MLP ->
    dropout -> +residual; ``moe_experts > 0`` makes the MLP a top-k gated
    ``MoEMLP`` (named ``moe``, as in JAX)."""

    #: the MLP's column- and row-parallel products, paired under a plan
    tp_pairs = ((("mlp_in",), "mlp_out"),)

    def __init__(self, features: int, num_heads: int, head_dim: int, *, mlp_ratio: int = 4,
                 dropout: float = 0.0, causal: bool = True, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, moe_experts: int = 0, moe_top_k: int = 2,
                 device=None):
        super().__init__()
        self.ln1 = FusedLayerNorm(features, dtype=dtype, device=device)
        self.attn = SelfAttention(features, num_heads, head_dim, causal=causal,
                                  attn_impl=attn_impl, dtype=dtype, device=device)
        self.attn_dropout = Dropout(dropout)
        self.ln2 = FusedLayerNorm(features, dtype=dtype, device=device)
        if moe_experts:
            self.moe = MoEMLP(features, num_experts=moe_experts, mlp_ratio=mlp_ratio,
                              top_k=moe_top_k, dtype=dtype, device=device)
        else:
            self.mlp_in = Linear(features, features * mlp_ratio, compute_dtype=dtype,
                                 device=device)
            self.mlp_out = Linear(features * mlp_ratio, features, compute_dtype=dtype,
                                  device=device)
        self.mlp_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn_dropout(self.attn(self.ln1(x)), generator)
        if hasattr(self, "moe"):
            y = self.moe(self.ln2(x))
        else:
            y = self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))
        return x + self.mlp_dropout(y, generator)


def _recompute(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective checkpoint's policy of :func:`remat_call` when traced:
    every operator recomputed, as ``nn.remat`` does."""
    return CheckpointPolicy.MUST_RECOMPUTE


def _set_modes(modes) -> None:
    """Each ``(module, training)`` flag, set only where it differs."""
    for m, flag in modes:
        if m.training != flag:
            m.training = flag


def remat_call(block: nn.Module, x: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
    """``block(x, generator)`` whose activations are recomputed in the
    backward (JAX's ``nn.remat(Block)``).

    The recompute runs the block over the parameter tensors of the forward
    (``functional_call``: under a bf16 policy the step's cast ones, which
    are swapped in only while the step's forward runs), in the train or
    eval mode of the forward (the step restores the modes before the
    backward), and draws its masks from a generator started at the state
    ``generator`` had before the block, so it saves the same tensors as the
    forward did.  ``generator`` ends where the forward left it.

    Traced by TorchDynamo (a compiled step), the checkpoint is its
    activation-checkpoint operator, whose recompute is the traced forward
    itself: ``run`` then calls the block as it stands (the parameters the
    trace reads are the forward's) and sets no module flag, as none
    differs from the forward's (Dynamo refuses a module mutated inside
    the checkpoint)."""
    names, tensors = zip(*block.named_parameters())
    modes = [(m, m.training) for m in block.modules()]
    start = None if generator is None else generator.get_state()
    drawn: list[torch.Generator] = []

    def run(x, *params):
        g = None
        if start is not None:
            g = torch.Generator(device=x.device)
            g.set_state(start)
            drawn.append(g)
        now = [(m, m.training) for m, _ in modes]
        _set_modes(modes)
        try:
            if torch.compiler.is_compiling():
                return block(x, g)
            return functional_call(block, dict(zip(names, params)), (x, g))
        finally:
            _set_modes(now)

    # the masks come from the block's own generator: no global RNG to keep.
    # Traced, every operator of the block is marked for recompute: a plain
    # checkpoint only prefers it, and the partitioner of a compiler may keep
    # what it bans from recompute (products, custom ops) instead
    kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts, _recompute)}
          if torch.compiler.is_compiling() else {})
    out = checkpoint(run, x, *tensors, use_reentrant=False, preserve_rng_state=False, **kw)
    if generator is not None:
        generator.set_state(drawn[0].get_state())
    return out


def run_blocks(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model``'s ``block{i}`` in order, each under :func:`remat_call`
    when ``model.remat`` and a gradient is being recorded, with the masks
    drawn from ``model.dropout_generator`` in train mode (where it is None,
    :class:`Dropout` raises)."""
    generator = model.dropout_generator if model.training and model.dropout > 0.0 else None
    remat = model.remat and torch.is_grad_enabled()
    for i in range(model.num_layers):
        block = getattr(model, f"block{i}")
        x = remat_call(block, x, generator) if remat else block(x, generator)
    return x


class TransformerLM(nn.Module):
    """Decoder-only LM over (B, L) int tokens, float32 logits.

    Args (the JAX model's, plus ``device`` and ``seed``):
      vocab_size, num_layers, num_heads, head_dim, max_len, mlp_ratio.
      dropout, remat: module docstring.
      moe_experts, moe_top_k: above 0, every block's MLP is a top-k gated
        MoE (module docstring).
      attn_impl: ``"auto"``, ``"full"``, ``"ring"``, ``"ulysses"`` or
        ``"blockwise"`` (module docstring).
      dtype: compute dtype; parameters stay float32.
      device: where the parameters live; None means ``cuda``, which raises
        without CUDA.
      seed: seeds the parameter init (a ``torch.Generator`` on ``device``).
    """

    #: the output head whose logits stay split over the vocabulary under a
    #: plan that splits it by columns (``parallel.tensor.shard_model``)
    tp_head = "lm_head"

    def __init__(self, vocab_size: int, num_layers: int = 4, num_heads: int = 8,
                 head_dim: int = 32, max_len: int = 2048, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 2, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        d = num_heads * head_dim
        self.compute_dtype = dtype
        self.dropout, self.remat = float(dropout), bool(remat)
        #: the train step's dropout generator, set for each step
        self.dropout_generator: torch.Generator | None = None
        self.embed = Embed(vocab_size, d, compute_dtype=dtype, device=device)
        self.pos_embed = Embed(max_len, d, compute_dtype=dtype, device=device)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(d, num_heads, head_dim, mlp_ratio=mlp_ratio,
                                               dropout=dropout, attn_impl=attn_impl, dtype=dtype,
                                               moe_experts=moe_experts, moe_top_k=moe_top_k,
                                               device=device))
        self.ln_f = FusedLayerNorm(d, dtype=dtype, device=device)
        self.lm_head = Linear(d, vocab_size, bias=False, compute_dtype=dtype, device=device)
        self._init_parameters(torch.Generator(device=device).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, Embed):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim), generator=gen)
            elif isinstance(m, MoEMLP):
                m.init_weights(gen, _TRUNC_STD)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run every product, gather and LayerNorm output in ``dtype``; a MoE
        router stays float32, as in JAX."""
        self.compute_dtype = dtype
        routers = {id(m.router) for m in self.modules() if isinstance(m, MoEMLP)}
        for m in self.modules():
            if isinstance(m, (Linear, Embed, MoEMLP)) and id(m) not in routers:
                m.compute_dtype = dtype
            elif isinstance(m, FusedLayerNorm):
                m.dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        l, seq = tokens.shape[1], _seq_split()
        start = 0 if seq is None else seq.index * l  # this rank's run of the sequence
        positions = torch.arange(start, start + l, device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(positions)[None]
        x = run_blocks(self, x)
        return self.lm_head(self.ln_f(x)).to(torch.float32)
