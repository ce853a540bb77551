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
the card), memory linear in L; ``"auto"`` takes blockwise at
``_BLOCKWISE_AUTO_LEN`` (4096) tokens or more and full below.  JAX's
``auto`` first asks its kernel ledger for a measured verdict and falls back
to this static rule without one; the port has no ledger yet, so it always
takes the rule.

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

Not ported yet, each raising ``NotImplementedError`` that names its slice:
``attn_impl`` ``"ring"`` and ``"ulysses"`` and ``moe_experts > 0``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.models.resnet import Linear
from tpuframe_torch.ops.blockwise_attention import blockwise_attention
from tpuframe_torch.ops.layer_norm import FusedLayerNorm
from tpuframe_torch.ops.ring_attention import attention_reference

__all__ = ["Block", "Dropout", "SelfAttention", "TransformerLM", "remat_call"]

#: attn_impl="auto" switches full -> blockwise at this unsharded length
_BLOCKWISE_AUTO_LEN = 4096
#: flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {where} (ROADMAP.md, Queue 1)")


class Embed(nn.Embedding):
    """flax ``Embed``: the table cast to ``compute_dtype``, then gathered."""

    def __init__(self, num_embeddings: int, features: int, *,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(num_embeddings, features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.weight.to(self.compute_dtype))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` (a uniform draw below it) and scaled by
    ``1 / (1 - rate)``, else zeroed; in eval mode, or at rate 0, the input
    as it is.  The masks come from the ``generator`` the caller hands in."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

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
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    """Multi-head self-attention, full or blockwise on one card."""

    def __init__(self, features: int, num_heads: int, head_dim: int, *, causal: bool = True,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if attn_impl in ("ring", "ulysses"):
            raise _later(f"attn_impl={attn_impl!r}", "the sequence-parallel slice")
        if attn_impl not in ("auto", "full", "blockwise"):
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
        impl = self.attn_impl
        if impl == "auto":
            impl = "blockwise" if l >= _BLOCKWISE_AUTO_LEN else "full"
        heads = (b, l, self.num_heads, self.head_dim)
        q = self.query(x).reshape(heads)
        k = self.key(x).reshape(heads)
        v = self.value(x).reshape(heads)
        if impl == "blockwise":
            out = blockwise_attention(q, k, v, causal=self.causal)
        else:
            out = attention_reference(q, k, v, causal=self.causal)
        return self.attn_out(out.reshape(b, l, -1))


class Block(nn.Module):
    """Pre-norm block: LN -> attention -> dropout -> +residual, LN -> MLP ->
    dropout -> +residual."""

    def __init__(self, features: int, num_heads: int, head_dim: int, *, mlp_ratio: int = 4,
                 dropout: float = 0.0, causal: bool = True, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ln1 = FusedLayerNorm(features, dtype=dtype, device=device)
        self.attn = SelfAttention(features, num_heads, head_dim, causal=causal,
                                  attn_impl=attn_impl, dtype=dtype, device=device)
        self.attn_dropout = Dropout(dropout)
        self.ln2 = FusedLayerNorm(features, dtype=dtype, device=device)
        self.mlp_in = Linear(features, features * mlp_ratio, compute_dtype=dtype, device=device)
        self.mlp_out = Linear(features * mlp_ratio, features, compute_dtype=dtype, device=device)
        self.mlp_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn_dropout(self.attn(self.ln1(x)), generator)
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_dropout(self.mlp_out(y), generator)


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
    forward did.  ``generator`` ends where the forward left it."""
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
        for m, flag in modes:
            m.training = flag
        try:
            return functional_call(block, dict(zip(names, params)), (x, g))
        finally:
            for m, flag in now:
                m.training = flag

    # the masks come from the block's own generator: no global RNG to keep
    out = checkpoint(run, x, *tensors, use_reentrant=False, preserve_rng_state=False)
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
      moe_experts, moe_top_k: only ``moe_experts=0`` runs here; others
        raise ``NotImplementedError``.
      attn_impl: ``"auto"``, ``"full"`` or ``"blockwise"`` (module
        docstring).
      dtype: compute dtype; parameters stay float32.
      device: where the parameters live; None means ``cuda``, which raises
        without CUDA.
      seed: seeds the parameter init (a ``torch.Generator`` on ``device``).
    """

    def __init__(self, vocab_size: int, num_layers: int = 4, num_heads: int = 8,
                 head_dim: int = 32, max_len: int = 2048, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 2, *, device=None, seed: int = 0):
        super().__init__()
        if moe_experts > 0:
            raise _later(f"moe_experts={moe_experts}", "the MoE part of slice 4")
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

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run every product, gather and LayerNorm output in ``dtype``."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, (Linear, Embed)):
                m.compute_dtype = dtype
            elif isinstance(m, FusedLayerNorm):
                m.dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(positions)[None]
        x = run_blocks(self, x)
        return self.lm_head(self.ln_f(x)).to(torch.float32)
