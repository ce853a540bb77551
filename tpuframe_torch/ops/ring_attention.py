"""Full attention in the (B, L, H, D) layout, and the online-softmax tiles
that the blockwise schedule is built from.

Port of ``attention_reference``, ``_block_update``, ``_tile_grads`` and
``_causal_skip`` from ``tpuframe/ops/ring_attention.py``.
``attention_reference`` is what the JAX ``SelfAttention`` runs for
``attn_impl="full"``: plain tensor code in both packages (XLA there, ATen
here), not a kernel.  Its scores are formed, scaled, masked and softmaxed
in the input dtype, as in JAX; ``scaled_dot_product_attention`` would round
elsewhere.

The three tile functions are the plain version of kernel K6
(``ops/blockwise_attention.py``): one (Q block, K/V block) tile of the
forward's online softmax, of the flash backward, and the causal tile skip.
Products take the storage dtype with float32 accumulation (JAX's
``preferred_element_type=jnp.float32``): the operands are widened to
float32 first, which multiplies bf16 values exactly, so the sums are those
of a bf16 product that accumulates in float32.  The softmax state stays
float32.  The ring and Ulysses schedules come with the sequence-parallel
slice (ROADMAP.md).
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


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 accumulation of storage-dtype products."""
    return torch.einsum(spec, a.float(), b.float())


def _block_update(q, k, v, o, l, m, q_pos, k_pos, causal: bool, scale: float,
                  kv_len: int | None = None):
    """Online-softmax accumulation of one K/V block into ``(o, l, m)``:
    ``o`` (B, Lq, H, D), ``l`` and ``m`` (B, H, Lq), all float32.

    ``kv_len`` masks padded key positions (``k_pos >= kv_len``).  The −inf
    guards are JAX's: ``m_safe`` keeps a fully masked row's exponent finite,
    and the ``correction`` is 0 while the running max is still −inf (the
    first block, or a row masked so far), never ``exp(m_new)``, which
    overflows for large logits and turns ``0 * inf`` into NaN."""
    s = _mm("bqhd,bkhd->bhqk", q, k) * scale  # (B, H, Lq, Lk) f32
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, -math.inf)
    if kv_len is not None:
        s = torch.where((k_pos < kv_len)[None, None, None, :], s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    correction = torch.exp(torch.where(torch.isneginf(m), -math.inf, m - m_new))
    correction = torch.where(torch.isneginf(m_new), 0.0, correction)
    l_new = l * correction + p.sum(-1)
    # probabilities in the value dtype for the second product (the flash
    # recipe), float32 accumulation into o
    pv = _mm("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, l_new, m_new


def _tile_grads(q_blk, k_blk, v_blk, do_blk, lse_blk, delta_blk, q_pos, k_pos,
                causal: bool, scale: float, kv_len: int | None = None):
    """``(p, ds)`` of one (Q block, K/V block) tile of the flash backward,
    (B, H, bq, bk) float32.

    Probabilities are recomputed from the saved logsumexp, ``p = exp(s -
    lse)``; masking ``s`` to −inf first gives exact zeros, also for a fully
    masked row (``lse = −inf``, taken as 0 by ``lse_safe``)."""
    s = _mm("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
    valid = None
    if kv_len is not None:
        valid = (k_pos < kv_len)[None, :]
    if causal:
        cmask = k_pos[None, :] <= q_pos[:, None]
        valid = cmask if valid is None else (valid & cmask)
    if valid is not None:
        s = torch.where(valid[None, None], s, -math.inf)
    lse_safe = torch.where(torch.isneginf(lse_blk), 0.0, lse_blk)
    p = torch.exp(s - lse_safe[..., None])
    dp = _mm("bqhd,bkhd->bhqk", do_blk, v_blk)
    ds = p * (dp - delta_blk[..., None]) * scale
    return p, ds


def _causal_skip(pred: bool | None, update, carry):
    """``update(carry)``, or ``carry`` untouched where ``pred`` is False: the
    tile above the causal diagonal is skipped, not masked.  ``pred`` is None
    for bidirectional attention (always update); here it is a host bool,
    the block indices being Python ints."""
    if pred is None or pred:
        return update(carry)
    return carry
