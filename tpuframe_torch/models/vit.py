"""Vision Transformer: (B, H, W, C) images -> (B, num_classes) logits.

Port of ``tpuframe/models/vit.py``, built from the transformer ``Block``
of ``models/transformer.py`` with ``causal=False``.  Module names follow
the JAX tree (``patch_embed``, ``cls_token``, ``pos_embed``, ``block{i}``,
``ln_f``, ``head``), so ``models.interop`` maps the JAX parameters one to
one (the patch kernel HWIO there, OIHW here).

- The patch embedding is one strided ``Conv2d`` over the NHWC input
  (cuDNN on the card, as XLA's convolution on the TPU), its output read in
  (row, column) patch order, as flax reshapes its NHWC output.
- ``pos_embed`` and ``cls_token`` are float32 parameters cast to the
  compute dtype where they are added; the input is cast to it first.
- ``pool="mean"`` averages the tokens, ``"cls"`` prepends a class token and
  reads it out; ``ln_f`` is K3a/K3b on the card; ``head`` is skipped when
  ``num_classes`` is 0; the logits come out in float32.
- ``dropout`` after the position embedding and in every block, ``remat``
  and ``attn_impl`` as in ``TransformerLM`` (``"auto"`` is full attention
  below 4,096 tokens: 196 at 224 px, patch 16).

The JAX model learns its token count from the first input it is
initialized with; a torch module needs it when it is built, so the port
takes ``image_size`` (default 224) and raises for an input of another
size.  :func:`vit_tp_rules` gives the JAX package's tensor-parallel rules
(``parallel.tensor`` has the split forms).

Standard sizes: ViT-S/16 about 22 M parameters, ViT-B/16 about 86 M.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch.core.runtime import MODEL_AXIS, resolve_device
from tpuframe_torch.models.resnet import Linear
from tpuframe_torch.models.transformer import (
    _TRUNC_STD,
    Block,
    Dropout,
    run_blocks,
    transformer_tp_rules,
)
from tpuframe_torch.ops.layer_norm import FusedLayerNorm

__all__ = ["PatchEmbed", "ViT", "ViT_B16", "ViT_S16", "vit_tp_rules"]


class PatchEmbed(nn.Conv2d):
    """flax ``Conv(features, (p, p), strides=(p, p), padding="VALID")`` over
    NHWC images, run in ``compute_dtype``: (B, H, W, C) -> (B, patches, D);
    split on its output channels once a plan splits it (``tp``)."""

    #: the split form ``parallel.tensor.shard_model`` gives it, or None
    tp = None
    #: split on its output channels it runs column-parallel, alone
    tp_forms, tp_alone = {0: "col"}, True

    def __init__(self, in_channels: int, features: int, patch: int, *,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, features, patch, stride=patch, bias=True, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        args = (self.weight.to(dt), self.bias.to(dt), x.permute(0, 3, 1, 2).to(dt))
        if self.tp is not None:
            y = self.tp.conv(*args, self.stride)
        else:
            y = F.conv2d(args[2], args[0], args[1], self.stride)
        return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.out_channels)


class ViT(nn.Module):
    """Args (the JAX model's, plus ``image_size``, ``in_channels``,
    ``device`` and ``seed``):

      num_classes: classifier width; 0 = no head (features out).
      patch_size: square patch edge; the image must divide evenly.
      hidden_dim, num_layers, num_heads: the encoder (head_dim = hidden_dim
        // num_heads); mlp_ratio, dropout.
      pool: ``"mean"`` or ``"cls"``.
      attn_impl: ``"auto"``, ``"full"`` or ``"blockwise"``; ``"ring"`` and
        ``"ulysses"`` raise ``NotImplementedError``: the port splits an LM's
        positions over ``seq`` in the train step, not a ViT's patch tokens.
      dtype: compute dtype; parameters stay float32.
      remat: recompute each block in the backward.
      image_size, in_channels: the input this model takes (224, 3).
      device: where the parameters live; None means ``cuda``.
      seed: seeds the parameter init.
    """

    #: the classifier head whose logits stay split over the classes
    tp_head = "head"

    def __init__(self, num_classes: int = 1000, patch_size: int = 16, hidden_dim: int = 384,
                 num_layers: int = 12, num_heads: int = 6, mlp_ratio: int = 4,
                 dropout: float = 0.0, pool: str = "mean", attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, remat: bool = False, *,
                 image_size: int = 224, in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} must divide into {num_heads} heads")
        if pool not in ("mean", "cls"):
            raise ValueError(f"unknown pool {pool!r}; 'mean' or 'cls'")
        _check_image(image_size, image_size, patch_size)
        if attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"ViT with attn_impl={attn_impl!r} (sequence-parallel attention over the patch "
                "tokens) is not ported: the train step cuts an LM's positions over the seq "
                "axis, not a ViT's tokens (ROADMAP.md, Queue 1 item 8, left waiting)")
        device = resolve_device(device)
        self.num_classes, self.patch_size, self.pool = num_classes, patch_size, pool
        self.image_size, self.num_layers = image_size, num_layers
        self.compute_dtype = dtype
        self.dropout, self.remat = float(dropout), bool(remat)
        #: the train step's dropout generator, set for each step
        self.dropout_generator: torch.Generator | None = None
        n_tokens = (image_size // patch_size) ** 2 + (pool == "cls")
        self.patch_embed = PatchEmbed(in_channels, hidden_dim, patch_size, compute_dtype=dtype,
                                      device=device)
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, hidden_dim, device=device))
        self.embed_dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(
                hidden_dim, num_heads, hidden_dim // num_heads, mlp_ratio=mlp_ratio,
                dropout=dropout, causal=False, attn_impl=attn_impl, dtype=dtype, device=device))
        self.ln_f = FusedLayerNorm(hidden_dim, dtype=dtype, device=device)
        if num_classes:
            self.head = Linear(hidden_dim, num_classes, compute_dtype=dtype, device=device)
        self._init_parameters(torch.Generator(device=device).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        """flax's initializers: LeCun-normal (truncated) Dense and Conv
        kernels over their fan-in, zero biases and class token, position
        embedding N(0, 0.02^2)."""
        for m in self.modules():
            if isinstance(m, (Linear, PatchEmbed)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run every product, LayerNorm output and embedding add in ``dtype``."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, (Linear, PatchEmbed)):
                m.compute_dtype = dtype
            elif isinstance(m, FusedLayerNorm):
                m.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        _check_image(h, w, self.patch_size)
        if h != self.image_size or w != self.image_size:
            raise ValueError(f"image {h}x{w}: this ViT was built for {self.image_size}x"
                             f"{self.image_size} (image_size)")
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        if self.pool == "cls":
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        generator = self.dropout_generator if self.training and self.dropout > 0.0 else None
        x = self.embed_dropout(x, generator)
        x = self.ln_f(run_blocks(self, x))
        x = x[:, 0] if self.pool == "cls" else x.mean(1)
        if self.num_classes:
            x = self.head(x)
        return x.to(torch.float32)


def vit_tp_rules():
    """The ViT's tensor-parallel rules, the JAX package's: the transformer
    block's (column-parallel ``query``/``key``/``value`` and ``mlp_in``,
    row-parallel ``attn_out`` and ``mlp_out``), the patch embedding's
    output channels and the classifier head's classes, over ``model``."""
    block_rules = tuple(r for r in transformer_tp_rules()
                        if "embed" not in r[0] and "lm_head" not in r[0])
    return block_rules + (
        (r"patch_embed/kernel", (None, None, None, MODEL_AXIS)),
        (r"head/kernel", (None, MODEL_AXIS)),
    )


def _check_image(h: int, w: int, p: int) -> None:
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} not divisible by patch size {p}")


#: Standard recipes (patch 16): S about 22 M, B about 86 M parameters.
ViT_S16 = functools.partial(ViT, hidden_dim=384, num_layers=12, num_heads=6)
ViT_B16 = functools.partial(ViT, hidden_dim=768, num_layers=12, num_heads=12)
