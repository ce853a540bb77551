"""Full attention in the (B, L, H, D) layout.

Port of ``attention_reference`` from ``tpuframe/ops/ring_attention.py``,
which the JAX ``SelfAttention`` runs for ``attn_impl="full"``.  It is plain
tensor code in both packages (XLA there, ATen here), not a kernel.  The
scores are formed, scaled, masked and softmaxed in the input dtype, as in
JAX; ``scaled_dot_product_attention`` would round elsewhere.  The ring,
Ulysses and blockwise forms come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Full (unsharded) attention, (B, L, H, D) in and out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
