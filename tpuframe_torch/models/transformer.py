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
card) outputs it; attention (``ops.ring_attention.attention_reference``)
scales, masks and softmaxes in it; GELU is the tanh form (flax's
``nn.gelu`` default); the logits are cast to float32 at the end.

Initializers draw flax's distributions from a seeded ``torch.Generator``:
``Dense`` kernels LeCun-normal (a normal truncated at two standard
deviations, scaled by 1 / 0.8796 so the variance is 1 / fan_in), biases
zero, ``Embed`` tables normal with variance 1 / features, LayerNorm scale
one and bias zero.

Not ported yet, each raising ``NotImplementedError`` that names its slice:
``attn_impl`` ``"blockwise"``, ``"ring"`` and ``"ulysses"``, ``"auto"`` at
``_BLOCKWISE_AUTO_LEN`` tokens or more, ``moe_experts > 0``, ``remat=True``
and ``dropout > 0``.  ``"auto"`` below that length is full attention, as in
JAX when no kernel-ledger verdict is recorded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.models.resnet import Linear
from tpuframe_torch.ops.layer_norm import FusedLayerNorm
from tpuframe_torch.ops.ring_attention import attention_reference

__all__ = ["Block", "SelfAttention", "TransformerLM"]

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


class SelfAttention(nn.Module):
    """Causal multi-head self-attention (full attention on one card)."""

    def __init__(self, features: int, num_heads: int, head_dim: int, *, causal: bool = True,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if attn_impl in ("blockwise", "ring", "ulysses"):
            raise _later(f"attn_impl={attn_impl!r}",
                         "the long-context slice (blockwise: kernel K6)" if attn_impl == "blockwise"
                         else "the sequence-parallel slice")
        if attn_impl not in ("auto", "full"):
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
        if self.attn_impl == "auto" and l >= _BLOCKWISE_AUTO_LEN:
            raise _later(f"attn_impl='auto' at {l} >= {_BLOCKWISE_AUTO_LEN} tokens (blockwise)",
                         "the long-context slice (kernel K6)")
        heads = (b, l, self.num_heads, self.head_dim)
        q = self.query(x).reshape(heads)
        k = self.key(x).reshape(heads)
        v = self.value(x).reshape(heads)
        out = attention_reference(q, k, v, causal=self.causal)
        return self.attn_out(out.reshape(b, l, -1))


class Block(nn.Module):
    """Pre-norm block: LN -> attention -> +residual, LN -> MLP -> +residual."""

    def __init__(self, features: int, num_heads: int, head_dim: int, *, mlp_ratio: int = 4,
                 causal: bool = True, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ln1 = FusedLayerNorm(features, dtype=dtype, device=device)
        self.attn = SelfAttention(features, num_heads, head_dim, causal=causal,
                                  attn_impl=attn_impl, dtype=dtype, device=device)
        self.ln2 = FusedLayerNorm(features, dtype=dtype, device=device)
        self.mlp_in = Linear(features, features * mlp_ratio, compute_dtype=dtype, device=device)
        self.mlp_out = Linear(features * mlp_ratio, features, compute_dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(y)


class TransformerLM(nn.Module):
    """Decoder-only LM over (B, L) int tokens, float32 logits.

    Args (the JAX model's, plus ``device`` and ``seed``):
      vocab_size, num_layers, num_heads, head_dim, max_len, mlp_ratio.
      dropout, remat, moe_experts, moe_top_k: only their defaults (0.0,
        False, 0) run here; others raise ``NotImplementedError``.
      attn_impl: ``"auto"`` or ``"full"`` (module docstring).
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
        for what, unported, where in (
            (f"dropout={dropout}", dropout > 0, "the remat and dropout part of the LM slice"),
            ("remat=True", remat, "the remat and dropout part of the LM slice"),
            (f"moe_experts={moe_experts}", moe_experts > 0, "the MoE part of slice 4"),
        ):
            if unported:
                raise _later(what, where)
        device = resolve_device(device)
        d = num_heads * head_dim
        self.compute_dtype = dtype
        self.embed = Embed(vocab_size, d, compute_dtype=dtype, device=device)
        self.pos_embed = Embed(max_len, d, compute_dtype=dtype, device=device)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(d, num_heads, head_dim, mlp_ratio=mlp_ratio,
                                               attn_impl=attn_impl, dtype=dtype, device=device))
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
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return self.lm_head(self.ln_f(x)).to(torch.float32)
