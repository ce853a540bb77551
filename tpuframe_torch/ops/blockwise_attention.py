"""Blockwise (flash-style) attention on one device: memory linear in L,
forward and backward (K6a, K6b, K6c).

Port of ``tpuframe/ops/blockwise_attention.py``.  There it is no Pallas
kernel but a hand-written ``jax.custom_vjp`` on ``lax.scan``: the forward
runs the online softmax over K/V blocks for every Q block and emits each
row's logsumexp; the backward is FlashAttention-2's two passes, which
recompute the probabilities one (block x block) tile at a time from that
logsumexp: pass 1 accumulates dQ over the K/V blocks, pass 2 dK and dV
over the Q blocks.  Tiles above the causal diagonal are skipped.  Nothing
of size (L, L) is stored.

Here :func:`blockwise_attention` is a :class:`torch.autograd.Function` that
saves q, k, v, the output and the float32 logsumexp (B, H, L).  On a CUDA
tensor its forward launches K6a and its backward K6b (the softmax term
``delta = rowsum(dO * O)`` and dQ) then K6c (dK and dV), the kernels of
``csrc/blockwise_attention.cu``.  On a CPU tensor the same three steps take
the plain version: JAX's schedule in torch (:func:`blockwise_attention_
reference` and :func:`blockwise_attention_bwd_reference`), built from the
tile functions of ``ops/ring_attention.py``: L padded up to a multiple of
the block, padded keys masked with ``kv_len``, padded query rows sliced
off, the causal tile skip, the softmax state in float32.

``block_size`` (default 512, JAX's default block; the port does not read
``TPUFRAME_KERNEL_ATTN_BLOCK``) shapes only the plain schedule.  The
kernels take tiles of their own (64 x 64), which changes where the sums
round but not what they compute.  In bf16, K6a, K6b and K6c run on the
tensor cores (``mma.sync`` bf16 products with float32 accumulators, P and
dS kept in registers); every float32 kernel takes float32 FMAs (the
source's header comment has the design).

Numerics, on both paths as in JAX: products in the storage dtype with
float32 accumulation; P rounded to v's dtype before P·V; in the backward
dO = g in q's dtype, delta from g in float32, dS rounded to k's dtype for
dQ and to q's dtype for dK, P to dO's dtype for dV; ``out = o / max(lsum,
1e-30)`` cast last; a fully masked row gives lse = −inf and zeros.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.ops.ring_attention import _block_update, _causal_skip, _mm, _tile_grads

__all__ = [
    "blockwise_attention",
    "blockwise_attention_bwd_dkv",
    "blockwise_attention_bwd_dq",
    "blockwise_attention_bwd_reference",
    "blockwise_attention_fwd",
    "blockwise_attention_reference",
]

#: the plain schedule's default block (JAX: ``attn_block()``'s default)
DEFAULT_BLOCK = 512
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("blockwise_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]  # B L H D causal scale dtype stream
    lib.tf_blockwise_attention_fwd.argtypes = [ptr] * 5 + shape
    lib.tf_blockwise_attention_bwd_dq.argtypes = [ptr] * 8 + shape
    lib.tf_blockwise_attention_bwd_dkv.argtypes = [ptr] * 8 + shape
    for fn in (lib.tf_blockwise_attention_fwd, lib.tf_blockwise_attention_bwd_dq,
               lib.tf_blockwise_attention_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


# -- the plain version: JAX's schedule ---------------------------------------


def _shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int, int]:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes must match, got {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if q.ndim != 4:
        raise ValueError(f"blockwise attention takes (B, L, H, D), got {tuple(q.shape)}")
    if q.shape[1] < 1:
        raise ValueError("blockwise attention over an empty sequence")
    return tuple(q.shape)


def _padded(a: torch.Tensor, l_pad: int, value: float = 0.0) -> torch.Tensor:
    """``a`` padded along its sequence axis (1 for (B, L, H, D), the last
    for (B, H, L)) to ``l_pad``."""
    if a.ndim == 3:
        return a if a.shape[-1] == l_pad else F.pad(a, (0, l_pad - a.shape[-1]), value=value)
    if a.shape[1] == l_pad:
        return a
    return F.pad(a, (0, 0, 0, 0, 0, l_pad - a.shape[1]), value=value)


def _blocks(l: int, block_size: int | None) -> tuple[int, int, int]:
    """(block, number of blocks, padded length), as JAX cuts L."""
    block = min(DEFAULT_BLOCK if block_size is None else block_size, l)
    n = -(-l // block)
    return block, n, n * block


def blockwise_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                  causal: bool = False, block_size: int | None = None):
    """Plain forward: ``(out, lse)``, out (B, L, H, D) in q's dtype, lse
    (B, H, L) float32 (JAX's ``_blockwise_padded_fwd`` over the padded
    sequence, then sliced)."""
    b, l, h, d = _shape(q, k, v)
    block, n, l_pad = _blocks(l, block_size)
    q, k, v = (_padded(a, l_pad) for a in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(block, device=q.device)
    outs, lses = [], []
    for qi in range(n):
        q_blk, q_pos = q[:, qi * block:(qi + 1) * block], qi * block + pos
        carry = (torch.zeros(b, block, h, d, dtype=torch.float32, device=q.device),
                 torch.zeros(b, h, block, dtype=torch.float32, device=q.device),
                 torch.full((b, h, block), -math.inf, dtype=torch.float32, device=q.device))
        for ki in range(n):
            sl = slice(ki * block, (ki + 1) * block)
            carry = _causal_skip(
                (ki <= qi) if causal else None,
                lambda c: _block_update(q_blk, k[:, sl], v[:, sl], *c, q_pos, ki * block + pos,
                                        causal, scale, kv_len=l), carry)
        o, lsum, m = carry
        lsum = lsum.clamp_min(1e-30)  # fully masked (padded or causal) rows
        lses.append(m + torch.log(lsum))  # -inf rows stay -inf
        outs.append((o / lsum.transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, 1)[:, :l], torch.cat(lses, -1)[..., :l]


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` (B, H, L) in float32, from ``g`` in float32."""
    return torch.einsum("bqhd,bqhd->bhq", out.float(), g.float())


def _bwd_setup(q, k, v, lse, g, causal, block_size):
    """What both plain passes share: the padded operands, dO = g in q's
    dtype, and the padded lse.  A padded query row has dO = 0 and delta =
    0, so it adds nothing; its lse is +inf here (JAX keeps the padded row's
    own lse), which makes its probabilities exactly 0, also at logits large
    enough that ``exp(s)`` overflows."""
    b, l, h, d = _shape(q, k, v)
    block, n, l_pad = _blocks(l, block_size)
    do = g.to(q.dtype)
    q, k, v, do = (_padded(a, l_pad) for a in (q, k, v, do))
    lse = _padded(lse.float(), l_pad, math.inf)
    pos = torch.arange(block, device=q.device)
    return q, k, v, do, lse, (b, l, h, d, block, n, 1.0 / math.sqrt(d), pos)


def _bwd_dq_reference(q, k, v, lse, delta, g, causal, block_size) -> torch.Tensor:
    """Pass 1 (JAX ``:150-178``): dQ over the K/V blocks, in q's dtype."""
    q, k, v, do, lse, (b, l, h, d, block, n, scale, pos) = _bwd_setup(
        q, k, v, lse, g, causal, block_size)
    delta = _padded(delta, q.shape[1])
    dqs = []
    for qi in range(n):
        sq = slice(qi * block, (qi + 1) * block)

        def update(dq, sk):
            _, ds = _tile_grads(q[:, sq], k[:, sk], v[:, sk], do[:, sq], lse[..., sq],
                                delta[..., sq], qi * block + pos, sk.start + pos, causal, scale, l)
            return dq + _mm("bhqk,bkhd->bqhd", ds.to(k.dtype), k[:, sk])

        dq = torch.zeros(b, block, h, d, dtype=torch.float32, device=q.device)
        for ki in range(n):
            sk = slice(ki * block, (ki + 1) * block)
            dq = _causal_skip((ki <= qi) if causal else None, lambda c: update(c, sk), dq)
        dqs.append(dq)
    return torch.cat(dqs, 1)[:, :l].to(q.dtype)


def _bwd_dkv_reference(q, k, v, lse, delta, g, causal, block_size):
    """Pass 2 (JAX ``:180-216``): dK and dV over the Q blocks, in k's and
    v's dtypes."""
    q, k, v, do, lse, (b, l, h, d, block, n, scale, pos) = _bwd_setup(
        q, k, v, lse, g, causal, block_size)
    delta = _padded(delta, q.shape[1])
    dks, dvs = [], []
    for ki in range(n):
        sk = slice(ki * block, (ki + 1) * block)

        def update(c, sq):
            dk, dv = c
            p, ds = _tile_grads(q[:, sq], k[:, sk], v[:, sk], do[:, sq], lse[..., sq],
                                delta[..., sq], sq.start + pos, ki * block + pos, causal, scale, l)
            dv = dv + _mm("bhqk,bqhd->bkhd", p.to(do.dtype), do[:, sq])
            dk = dk + _mm("bhqk,bqhd->bkhd", ds.to(q.dtype), q[:, sq])
            return dk, dv

        zero = torch.zeros(b, block, h, d, dtype=torch.float32, device=q.device)
        carry = (zero, zero)
        for qi in range(n):
            sq = slice(qi * block, (qi + 1) * block)
            carry = _causal_skip((qi >= ki) if causal else None, lambda c: update(c, sq), carry)
        dks.append(carry[0])
        dvs.append(carry[1])
    return torch.cat(dks, 1)[:, :l].to(k.dtype), torch.cat(dvs, 1)[:, :l].to(v.dtype)


def blockwise_attention_bwd_reference(q, k, v, out, lse, g, *, causal: bool = False,
                                      block_size: int | None = None):
    """Plain backward: ``(dq, dk, dv)`` in q's, k's and v's dtypes for the
    upstream gradient ``g`` of :func:`blockwise_attention_reference`'s
    ``out`` (its ``lse`` saved), JAX's ``_blockwise_padded_bwd``."""
    delta = _delta(out, g)
    dq = _bwd_dq_reference(q, k, v, lse, delta, g, causal, block_size)
    return (dq, *_bwd_dkv_reference(q, k, v, lse, delta, g, causal, block_size))


# -- the kernels --------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernels load 16
    bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(q, *others) -> tuple:
    """Checks what the kernels take; returns the aligned tensors and the
    shape arguments (B, L, H, D)."""
    b, l, h, d = _shape(q, q, q)
    if d not in HEAD_DIMS:
        raise ValueError(f"the blockwise attention kernels take head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in _CODES:
        raise TypeError(f"the blockwise attention kernels take float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.device != q.device:
            raise ValueError(f"blockwise attention operands on {t.device} and {q.device}")
    return tuple(_aligned(t) for t in (q, *others)), (b, l, h, d)


def _launch(fn, name: str, ptrs, dims, causal: bool, dtype, device) -> None:
    b, l, h, d = dims
    with torch.cuda.device(device):
        rc = fn(*(t.data_ptr() for t in ptrs), b, l, h, d, int(bool(causal)),
                1.0 / math.sqrt(d), _CODES[dtype], torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blockwise attention {name} kernel launch failed: CUDA error {rc}")


def blockwise_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = False, block_size: int | None = None):
    """``(out, lse)`` of attention over (B, L, H, D): out in q's dtype, lse
    (B, H, L) float32.  A CUDA tensor launches K6a (``block_size`` is not
    read); a CPU tensor takes :func:`blockwise_attention_reference`.
    ``blockwise_attention_fwd.launches`` counts kernel launches."""
    if not use_kernel(q):
        return blockwise_attention_reference(q, k, v, causal=causal, block_size=block_size)
    _shape(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes must match for the kernel, got {q.dtype}/{k.dtype}/{v.dtype}")
    (q, k, v), dims = _kernel_args(q, k, v)
    b, l, h, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    _launch(_library().tf_blockwise_attention_fwd, "forward", (q, k, v, out, lse), dims, causal,
            q.dtype, q.device)
    blockwise_attention_fwd.launches += 1
    return out, lse


def _bwd_check(q, k, v, lse, *rest) -> torch.Tensor:
    """The backward's checks; returns ``lse`` as float32."""
    b, l, h, _ = _shape(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes must match for the kernel, got {q.dtype}/{k.dtype}/{v.dtype}")
    if tuple(lse.shape) != (b, h, l):
        raise ValueError(f"lse must be (B, H, L) = {(b, h, l)}, got {tuple(lse.shape)}")
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"out and g must be shaped like q {tuple(q.shape)}, got {tuple(t.shape)}")
    return lse.float()


def blockwise_attention_bwd_dq(q, k, v, out, lse, g, *, causal: bool = False,
                               block_size: int | None = None):
    """Pass 1 of the backward: ``(dq, delta)``, dq in q's dtype and delta =
    rowsum(dO * O) (B, H, L) float32 from ``g`` in float32 (dO is ``g`` in
    q's dtype).  A CUDA tensor launches K6b; a CPU tensor takes the plain
    pass.  ``blockwise_attention_bwd_dq.launches`` counts kernel launches."""
    lse = _bwd_check(q, k, v, lse, out, g)
    if not use_kernel(q):
        delta = _delta(out, g)
        return _bwd_dq_reference(q, k, v, lse, delta, g, causal, block_size), delta
    g = g.to(q.dtype)  # dO; autograd hands g in out's dtype, which is q's
    (q, k, v, out, lse, g), dims = _kernel_args(q, k, v, out.to(q.dtype), lse, g)
    b, l, h, _ = dims
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    _launch(_library().tf_blockwise_attention_bwd_dq, "backward dq",
            (q, k, v, out, g, lse, dq, delta), dims, causal, q.dtype, q.device)
    blockwise_attention_bwd_dq.launches += 1
    return dq, delta


def blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, *, causal: bool = False,
                                block_size: int | None = None):
    """Pass 2 of the backward: ``(dk, dv)`` in k's and v's dtypes, from the
    saved ``lse`` and pass 1's ``delta``.  A CUDA tensor launches K6c; a CPU
    tensor takes the plain pass.  ``blockwise_attention_bwd_dkv.launches``
    counts kernel launches."""
    lse = _bwd_check(q, k, v, lse, g)
    if tuple(delta.shape) != tuple(lse.shape):
        raise ValueError(f"delta must be shaped like lse {tuple(lse.shape)}, got {tuple(delta.shape)}")
    if not use_kernel(q):
        return _bwd_dkv_reference(q, k, v, lse, delta.float(), g, causal, block_size)
    g = g.to(q.dtype)
    (q, k, v, g, lse, delta), dims = _kernel_args(q, k, v, g, lse, delta.float())
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_library().tf_blockwise_attention_bwd_dkv, "backward dk/dv",
            (q, k, v, g, lse, delta, dk, dv), dims, causal, q.dtype, q.device)
    blockwise_attention_bwd_dkv.launches += 1
    return dk, dv


blockwise_attention_fwd.launches = 0
blockwise_attention_bwd_dq.launches = 0
blockwise_attention_bwd_dkv.launches = 0


class _BlockwiseAttention(torch.autograd.Function):
    """K6a forward; K6b then K6c backward.  Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_size):
        out, lse = blockwise_attention_fwd(q, k, v, causal=causal, block_size=block_size)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_size = causal, block_size
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, block_size=ctx.block_size)
        dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, **kw)
        dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, **kw)
        return dq, dk, dv, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, block_size: int | None = None) -> torch.Tensor:
    """Exact attention over (B, L, H, D) without materializing (.., L, L),
    differentiable in q, k and v.

    ``block_size`` (default 512) is the plain schedule's block, taken on
    a CPU tensor; the kernels pick their own tile (module docstring)."""
    _shape(q, k, v)
    return _BlockwiseAttention.apply(q, k, v, causal, block_size)
