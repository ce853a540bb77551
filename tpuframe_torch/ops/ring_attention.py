"""Full attention in the (B, L, H, D) layout, the online-softmax tiles that
the blockwise schedule is built from, and ring attention over the ``seq``
axis (K7).

Port of ``tpuframe/ops/ring_attention.py``.  ``attention_reference`` is
what the JAX ``SelfAttention`` runs for ``attn_impl="full"``: plain tensor
code in both packages (XLA there, ATen here), not a kernel.  Its scores are
formed, scaled, masked and softmaxed in the input dtype, as in JAX;
``scaled_dot_product_attention`` would round elsewhere.

The three tile functions are the plain version of kernel K6
(``ops/blockwise_attention.py``): one (Q block, K/V block) tile of the
forward's online softmax, of the flash backward, and the causal tile skip.
Products take the storage dtype with float32 accumulation (JAX's
``preferred_element_type=jnp.float32``): the operands are widened to
float32 first, which multiplies bf16 values exactly, so the sums are those
of a bf16 product that accumulates in float32.  The softmax state stays
float32.

**The ring** (:func:`ring_attention_local`, JAX's ``_ring_fused`` with its
hand-written backward).  A rank of the ``seq`` group holds its run of
L / n positions of q, k and v, (B, L / n, H, D); the global sequence is the
runs in ``seq`` rank order.  K and V travel the ring n times while every
rank attends its queries to the block it holds:

- **Each tile is K6.**  The block that started at ring position ``src``
  is a full tile (``causal=False``) where ``src < my``, the rank's own block
  the causal diagonal (``causal=True``, the positions' offsets being equal);
  under a causal mask a block from ``src > my`` is skipped and launches
  nothing.  So rank r runs r + 1 tiles of each kernel and rank n - 1 runs n,
  the imbalance of JAX's ring.
- **The forward** asks K6a for each tile's float32 output and logsumexp
  and merges them by their logsumexps as they come: ``lse = logaddexp(lse,
  lse_i)``, ``o = o·exp(lse_old − lse) + o_i·exp(lse_i − lse)``, in float32
  (JAX keeps its unnormalized o, l and m across hops; the merge is the same
  sum).  The output is cast once at the end.
- **The backward** is one more sweep, a :class:`torch.autograd.Function`
  whose backward is that sweep (the hops are not differentiated): K6b gives
  each visiting block's float32 dq partial from the *global* output and
  logsumexp (so its delta = rowsum(dO · O) is the global one), K6c the dk
  and dv partials, and the dk and dv accumulators travel with their blocks,
  landing home after n rotations, as in JAX.
- **The hop** sends every buffer to ``(rank + 1) % n`` and receives from
  ``(rank − 1) % n`` as one ``dist.all_to_all_single`` over the ``seq``
  group whose splits are zero but those two, the buffers packed as bytes
  (gloo carries no point-to-point send of a CUDA tensor, ROADMAP.md).
  Every rank calls every hop, also where it skips the tile.  The forward's
  hop of the next K and V is issued before the tile's kernel and waited for
  after it; the backward's hop carries K, V, dK and dV together (dK and dV
  alone on the last rotation).

The functions take the rank's own shards and find the ``seq`` group in the
runtime's mesh (or the ``mesh`` given): JAX's take global arrays under
``shard_map``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpuframe_torch.core.runtime import DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS

__all__ = ["attention_reference", "ring_attention", "ring_attention_local"]


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


# -- the ring (K7): a schedule of K6 tiles over the seq axis ----------------------


def mesh_axis(axis_name: str = SEQUENCE_AXIS, mesh=None):
    """``mesh``'s (default: the runtime's) ``axis_name`` axis for this rank,
    a ``parallel.tensor.Axis``; without a runtime, ValueError."""
    from tpuframe_torch.core.runtime import current_runtime
    from tpuframe_torch.parallel.tensor import axis

    if mesh is None:
        try:
            mesh = current_runtime(auto_init=False).mesh
        except RuntimeError:
            raise ValueError(f"sequence-parallel attention over the {axis_name!r} axis needs "
                             "an initialized runtime mesh (core.initialize) or a mesh") from None
    return axis(axis_name, mesh)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


class _RingHop:
    """One rotation of ``tensors`` (sent to ``(index + 1) % n``, received from
    ``(index - 1) % n``) as one ``all_to_all_single`` of their bytes; the
    wider dtypes first, so every unpacked view is aligned.  ``wait()``
    returns the received tensors, views of one fresh buffer."""

    def __init__(self, tensors: list[torch.Tensor], ax, async_op: bool = False):
        order = sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())
        self._meta = [(i, tensors[i].shape, tensors[i].dtype, tensors[i].numel()
                       * tensors[i].element_size()) for i in order]
        flat = torch.cat([_bytes(tensors[i]) for i in order])
        self._got = torch.empty_like(flat)
        n, me = ax.size, ax.index
        send, recv = [0] * n, [0] * n
        send[(me + 1) % n] = recv[(me - 1) % n] = flat.numel()
        self._work = dist.all_to_all_single(self._got, flat, recv, send, group=ax.group,
                                            async_op=async_op)

    def wait(self) -> list[torch.Tensor]:
        if self._work is not None:
            self._work.wait()
        out: list = [None] * len(self._meta)
        at = 0
        for i, shape, dtype, nbytes in self._meta:
            out[i] = self._got[at:at + nbytes].view(dtype).view(shape)
            at += nbytes
        return out


def _hop(tensors: list[torch.Tensor], ax) -> list[torch.Tensor]:
    return _RingHop(tensors, ax).wait()


def _merge(o, lse, o_i, lse_i):
    """Two normalized float32 partials merged by their logsumexps; a row
    that no block reached keeps lse = −inf and o = 0."""
    new = torch.logaddexp(lse, lse_i)
    safe = torch.where(torch.isneginf(new), 0.0, new)
    w_old = torch.exp(lse - safe).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - safe).transpose(1, 2)[..., None]
    return o * w_old + o_i * w_new, new


class _Ring(torch.autograd.Function):
    """The ring's forward sweep; its backward is the second sweep (module
    docstring).  Saves q, the rank's own k and v, the output and the float32
    logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal):
        from tpuframe_torch.ops.blockwise_attention import blockwise_attention_fwd

        n, me = ax.size, ax.index
        b, lq, h, d = q.shape
        o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, lq), -math.inf, dtype=torch.float32, device=q.device)
        kv = [k, v]
        for step in range(n):
            src = (me - step) % n
            hop = _RingHop(kv, ax, async_op=True) if step + 1 < n else None
            if not causal or src <= me:
                o_i, lse_i = blockwise_attention_fwd(q, *kv, causal=causal and src == me,
                                                     out_dtype=torch.float32)
                o, lse = _merge(o, lse, o_i, lse_i)
            if hop is not None:
                kv = hop.wait()
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ax, ctx.causal = ax, causal
        return out

    @staticmethod
    def backward(ctx, g):
        from tpuframe_torch.ops.blockwise_attention import (
            blockwise_attention_bwd_dkv,
            blockwise_attention_bwd_dq,
        )

        q, k, v, out, lse = ctx.saved_tensors
        ax, causal = ctx.ax, ctx.causal
        n, me = ax.size, ax.index
        g = g.to(q.dtype).contiguous()
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, **f32)
        dk, dv = torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32)
        kv = [k, v]
        for step in range(n):
            src = (me - step) % n
            if not causal or src <= me:
                kw = dict(causal=causal and src == me, out_dtype=torch.float32)
                dq_i, delta = blockwise_attention_bwd_dq(q, *kv, out, lse, g, **kw)
                dk_i, dv_i = blockwise_attention_bwd_dkv(q, *kv, lse, delta, g, **kw)
                dq += dq_i
                dk += dk_i
                dv += dv_i
            if n > 1:  # the accumulators ride with their blocks; k and v die after the last tile
                got = _hop([dk, dv] + (kv if step + 1 < n else []), ax)
                dk, dv, kv = got[0], got[1], got[2:] or kv
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _ring(q, k, v, ax, causal: bool) -> torch.Tensor:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shards must match, got {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    return _Ring.apply(q, k, v, ax, bool(causal))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         axis_name: str = SEQUENCE_AXIS, causal: bool = False) -> torch.Tensor:
    """Ring attention over this rank's shards (B, L_local, H, D) of the
    ``axis_name`` axis of the runtime's mesh; the same layout out.  Exact:
    full attention over the global sequence, differentiable in q, k and v
    (module docstring).  Every rank of the axis calls it together."""
    return _ring(q, k, v, mesh_axis(axis_name), causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None, *,
                   causal: bool = False, seq_axis: str = SEQUENCE_AXIS,
                   batch_axes=(DATA_AXIS, FSDP_AXIS), head_axis: str | None = None
                   ) -> torch.Tensor:
    """:func:`ring_attention_local` over ``mesh`` (default: the runtime's).

    JAX's takes global (B, L, H, D) arrays and splits them under
    ``shard_map``: batch over ``batch_axes``, sequence over ``seq_axis``,
    heads over ``head_axis``.  The port's takes this rank's shard of each,
    which already is that split, so ``batch_axes`` and ``head_axis`` only
    name it."""
    del batch_axes, head_axis
    return _ring(q, k, v, mesh_axis(seq_axis, mesh), causal)
