"""MoE top-k dispatch and combine (K9a-K9c): capacity-truncated row copies,
not one-hots.

Port of ``tpuframe/ops/moe_gating.py``.  The routing is JAX's
(``_routing``): the top-k choices fill the expert buffers in choice-major
order, a slot past ``capacity`` is dropped (its combine weight is zero).
``moe_dispatch_combine_reference`` is JAX's dense GShard form, the one-hot
``(kN, E, C)`` dispatch tensor and its einsums; ``moe_dispatch_combine``
with ``fused`` None or True takes the row copies, ``fused=False`` the dense
form.  The port reads no kernel ledger (JAX's ``kernel_enabled(
"moe_gating")``; ``ops.ledger`` is ROADMAP.md, Queue 1 item 9).

**The kernels** (``csrc/moe_gating.cu``, on a CUDA tensor; their plain
PyTorch versions on a CPU tensor).  JAX's fused path is plain XLA, a
scatter-add and a gather; its scatter-add has no deterministic one-call
form on CUDA (``index_add_`` sums with atomics), so the port writes the row
copies by hand:

- **K9a** :func:`moe_dispatch`, the forward dispatch: the whole ``(E_local,
  C, D)`` buffer in one launch: ``buf[e_f, slot_f, :] = src[f mod N, :]``
  over the kept slots of the experts held here, every other row zero.
- **K9b** :func:`moe_combine`: ``out[n, :] = Σ_{j<k} w[j·N + n] ·
  buf[e, slot, :]``, j in order.  The forward combines with ``w`` = gate ·
  keep; the dispatch's backward with ``w`` = keep.
- **K9c** :func:`moe_combine_backward`, the combine's backward in one
  launch: ``dbuf`` laid out as K9a lays out the forward, with the
  cotangent row scaled by the gate weight (``dbuf[e_f, slot_f, :] = w_f ·
  g[f mod N, :]``, zero rows elsewhere), and ``dgate_f = ⟨g[f mod N],
  buf[e_f, slot_f]⟩``, a float32 dot a slot (zero where it is not held
  here), from one read of each held ``g`` row.

**The ops.**  ``tpuframe::moe_dispatch`` (K9a into a buffer it allocates:
the kernel writes all of it), ``tpuframe::moe_combine`` (K9b) and
``tpuframe::moe_combine_backward`` (K9c, ``(dbuf, dgate)`` from one launch)
are custom ops, the kernel on CUDA and the plain version on the CPU, whose
``nonzero`` stays inside the op, opaque to TorchDynamo.  ``_Dispatch`` and
``_Combine`` call them through ``ops.dispatch.launch_site``: the op while
Dynamo traces, its implementation directly when eager.
:func:`moe_dispatch` and :func:`moe_combine_backward` themselves write into
the buffers they are handed.

They take float32 or bfloat16 rows and float32 weights, and compute in
float32.  The plain versions do the same steps: the rows past each
expert's count zeroed and an ``index_put_`` at the (distinct)
destinations (each row scaled in float32 and rounded once in the
backward), the (k, N, D) rows summed over k in order, a float32 dot;
deterministic too.  The expert products between them are
``torch.bmm`` (JAX computes them outside any kernel).

**Slots.**  The routing's ``(kN,)`` frame becomes two int32 descriptors:
``e_loc``, the slot's expert among those held here (−1 where it is dropped
or held by another rank), and ``slot``, its row in that expert's buffer;
``count`` holds each local expert's number of held slots.  The rows are
compacted per expert in choice-major order (expert e's held slots are its
rows ``0 .. count_e − 1``, the rest are zero), so one process
holding every expert gets JAX's positions exactly, and a rank that holds
only its own tokens (``routed=``, the global routing of ``models.moe``)
fills a buffer of ``min(capacity, kN)`` rows with no other rank's rows.

**Expert parallelism** (``expert_axis=``, a ``parallel.tensor.Axis``):
``w_in`` and ``w_out`` hold this rank's E / n experts; the tokens and gate
values enter through ``copy_to_group`` (their cotangents summed over the
experts) and the rank's contributions are summed over the group with
``reduce_from_group``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import count_launch, custom_op, launch_site, use_kernel

__all__ = ["moe_dispatch_combine", "moe_dispatch_combine_reference"]

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (flax's ``nn.gelu``)."""
    return F.gelu(x, approximate="tanh")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("moe_gating")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # N K D capacity dtype stream; the buffers' also E_local before dtype
    lib.tf_moe_dispatch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.tf_moe_combine.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.tf_moe_combine_backward.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    for fn in (lib.tf_moe_dispatch, lib.tf_moe_combine, lib.tf_moe_combine_backward):
        fn.restype = ctypes.c_int
    return lib


# -- routing ------------------------------------------------------------------------


def _routing(gate_idx: torch.Tensor, e: int, capacity: int):
    """JAX's Switch-style routing over the flattened choice-major frame:
    ``(choice_exp, pos, keep, tok_idx)``, each (k·N,): the expert of each
    slot, its position in that expert's buffer (a running count, so choice
    0 fills before choice 1), whether it fits under ``capacity``, and the
    token it came from."""
    n, k = gate_idx.shape
    choice_exp = gate_idx.t().reshape(-1).long()
    onehot = F.one_hot(choice_exp, e).to(torch.int32)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    tok_idx = torch.arange(n, device=gate_idx.device).repeat(k)
    return choice_exp, pos, keep, tok_idx


def _descriptors(choice_exp, keep, e0: int, e_local: int):
    """``(e_loc, slot, count)`` int32 of the slots (module docstring): the
    kept slots of experts ``e0 .. e0 + e_local - 1``, each given the next
    row of its expert in choice-major order, −1 elsewhere; and each local
    expert's number of held slots, (e_local,)."""
    held = keep & (choice_exp >= e0) & (choice_exp < e0 + e_local)
    e_loc = torch.where(held, choice_exp - e0, torch.full_like(choice_exp, e_local))
    onehot = F.one_hot(e_loc, e_local + 1)[:, :e_local].to(torch.int32)
    ahead = torch.cumsum(onehot, 0)
    slot = ((ahead - onehot) * onehot).sum(-1)
    e_loc = torch.where(held, e_loc, torch.full_like(e_loc, -1))
    return (e_loc.to(torch.int32).contiguous(), slot.to(torch.int32).contiguous(),
            ahead[-1].to(torch.int32).contiguous())


# -- the kernels and their plain versions -------------------------------------------


def _check_rows(*tensors: torch.Tensor) -> None:
    dtype = tensors[0].dtype
    if dtype not in _CODES:
        raise TypeError(f"the MoE kernels take float32 or bfloat16 rows, got {dtype}")
    for t in tensors:
        if t.dtype != dtype or t.device != tensors[0].device:
            raise ValueError(f"MoE rows must share dtype and device, got {t.dtype} on "
                             f"{t.device} and {dtype} on {tensors[0].device}")


def _launch(fn, name: str, ptrs, sizes: tuple, dtype, device) -> None:
    with torch.cuda.device(device):
        rc = fn(*(0 if t is None else t.data_ptr() for t in ptrs), *sizes, _CODES[dtype],
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"MoE {name} kernel launch failed: CUDA error {rc}")


def _check_buffer(buf: torch.Tensor, count: torch.Tensor, d: int, name: str) -> None:
    if buf.dim() != 3 or buf.shape[2] != d or count.numel() != buf.shape[0]:
        raise ValueError(f"{name} takes an (E_local, C, {d}) buffer with a count an expert; got "
                         f"{tuple(buf.shape)} and {count.numel()} counts")


def _rows(buf: torch.Tensor, e_loc: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The buffer rows the slots point at (row 0 of expert 0 where a slot
    points nowhere), (kN, D)."""
    e = e_loc.long().clamp_min(0)
    s = slot.long().clamp(0, buf.shape[1] - 1)
    return buf[e, s]


def moe_dispatch_reference(src: torch.Tensor, buf: torch.Tensor, e_loc: torch.Tensor,
                           slot: torch.Tensor, scale: torch.Tensor | None = None, *,
                           count: torch.Tensor) -> torch.Tensor:
    """Plain K9a (``scale`` None) and K9c's ``dbuf`` (``scale`` the gate
    weights): the rows of expert e from ``count[e]`` on zeroed, then
    ``index_put_`` of the held slots' rows (each scaled in float32 and
    rounded once) at their distinct destinations, rows ``0 .. count[e] −
    1``: the zero-filled result whatever ``buf`` held."""
    n = src.shape[0]
    row = torch.arange(buf.shape[1], device=buf.device)
    buf.masked_fill_((row[None, :] >= count.long()[:, None])[..., None], 0)
    sel = (e_loc >= 0).nonzero()[:, 0]
    rows = src[sel % n]
    if scale is not None:
        rows = (scale[sel, None] * rows.float()).to(buf.dtype)
    buf.index_put_((e_loc[sel].long(), slot[sel].long()), rows)
    return buf


def moe_combine_reference(buf: torch.Tensor, w: torch.Tensor, e_loc: torch.Tensor,
                          slot: torch.Tensor, n: int) -> torch.Tensor:
    """Plain K9b: the weighted rows as (k, N, D) in float32, summed over k in
    order, rounded once."""
    d = buf.shape[-1]
    k = e_loc.numel() // n
    held = e_loc >= 0
    prod = _rows(buf, e_loc, slot).float() * torch.where(held, w.float(), 0.0)[:, None]
    acc = torch.zeros((n, d), dtype=torch.float32, device=buf.device)
    for part in prod.view(k, n, d):
        acc = acc + part
    return acc.to(buf.dtype)


def moe_gate_grad_reference(g: torch.Tensor, buf: torch.Tensor, e_loc: torch.Tensor,
                            slot: torch.Tensor) -> torch.Tensor:
    """Plain K9c's ``dgate``: the float32 dot of each held slot's cotangent
    row and buffer row, 0 where the slot is not held."""
    n = g.shape[0]
    tok = torch.arange(n, device=g.device).repeat(e_loc.numel() // n)
    dots = (g[tok].float() * _rows(buf, e_loc, slot).float()).sum(-1)
    return torch.where(e_loc >= 0, dots, 0.0)


def moe_dispatch(src: torch.Tensor, buf: torch.Tensor, e_loc: torch.Tensor,
                 slot: torch.Tensor, *, count: torch.Tensor) -> torch.Tensor:
    """K9a: ``buf[e_loc[f], slot[f]] = src[f mod N]`` for every slot with
    ``e_loc[f] >= 0`` and every other row of ``buf`` zero, in place,
    whatever ``buf`` held (``buf`` (E_local, C, D), contiguous; ``src`` (N,
    D); ``count`` (E_local,) int32, each expert's held slots, which
    ``_descriptors`` gives rows ``0 .. count[e] − 1``).  Returns ``buf``.
    ``moe_dispatch.launches`` counts kernel launches."""
    _check_rows(src, buf)
    n, d = src.shape
    k = e_loc.numel() // n
    if not use_kernel(src):
        return moe_dispatch_reference(src, buf, e_loc, slot, count=count)
    _check_buffer(buf, count, d, "moe_dispatch")
    if not buf.is_contiguous():
        raise ValueError(f"moe_dispatch writes a contiguous buffer; got strides {buf.stride()}")
    src = src.contiguous()
    args = (src, buf, e_loc.int().contiguous(), slot.int().contiguous(), count.int().contiguous())
    _launch(_library().tf_moe_dispatch, "dispatch", args, (n, k, d, buf.shape[1], buf.shape[0]),
            src.dtype, src.device)
    count_launch(moe_dispatch)
    return buf


def _combine_cuda(buf: torch.Tensor, w: torch.Tensor, e_loc: torch.Tensor, slot: torch.Tensor,
                  n: int) -> torch.Tensor:
    """K9b's launch site."""
    _check_rows(buf)
    d = buf.shape[-1]
    k = e_loc.numel() // n
    out = torch.empty((n, d), dtype=buf.dtype, device=buf.device)
    args = (buf.contiguous(), w.float().contiguous(), e_loc.int().contiguous(),
            slot.int().contiguous(), out)
    _launch(_library().tf_moe_combine, "combine", args, (n, k, d, buf.shape[1]), buf.dtype,
            buf.device)
    count_launch(moe_combine)
    return out


def _combine_cpu(buf, w, e_loc, slot, n):
    _check_rows(buf)
    return moe_combine_reference(buf, w, e_loc, slot, n)


def _combine_fake(buf, w, e_loc, slot, n):
    return buf.new_empty((n, buf.shape[-1]))


def moe_combine(buf: torch.Tensor, w: torch.Tensor, e_loc: torch.Tensor, slot: torch.Tensor,
                n: int) -> torch.Tensor:
    """K9b: ``out[t] = Σ_{j<k} w[j·n + t] · buf[e_loc, slot]`` over the
    slots of token t with ``e_loc >= 0``, j in order, in float32, rounded
    once to ``buf``'s dtype; (n, D).  ``moe_combine.launches`` counts kernel
    launches."""
    run = launch_site(torch.ops.tpuframe.moe_combine, _combine_cuda, _combine_cpu, buf)
    return run(buf, w, e_loc, slot, n)


def moe_combine_backward(g: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
                         e_loc: torch.Tensor, slot: torch.Tensor, count: torch.Tensor,
                         dbuf: torch.Tensor, dgate: torch.Tensor,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9c, the backward of :func:`moe_combine` in one launch: writes
    ``dbuf`` and ``dgate`` whole, whatever they held, and returns them.
    ``dbuf`` (E_local, C, D) in ``buf``'s dtype, contiguous, gets ``w[f] ·
    g[f mod N]`` (float32, rounded once) at row ``slot[f]`` of expert
    ``e_loc[f]`` for every slot with ``e_loc[f] >= 0``, zero rows elsewhere;
    ``dgate`` (kN,) float32, contiguous, gets ``⟨g[f mod N], buf[e_loc[f],
    slot[f]]⟩``, 0 where ``e_loc[f] < 0``.  ``g`` (N, D) is the cotangent of
    the combine's output, ``buf`` its input, ``w`` its (kN,) weights,
    ``count`` (E_local,) each expert's held slots.
    ``moe_combine_backward.launches`` counts kernel launches."""
    _check_rows(g, buf)
    n, d = g.shape
    k = e_loc.numel() // n
    if not use_kernel(g):
        moe_dispatch_reference(g, dbuf, e_loc, slot, w, count=count)
        return dbuf, dgate.copy_(moe_gate_grad_reference(g, buf, e_loc, slot))
    _check_buffer(buf, count, d, "moe_combine_backward")
    if (dbuf.shape != buf.shape or dbuf.dtype != buf.dtype or not dbuf.is_contiguous()
            or dgate.shape != (e_loc.numel(),) or dgate.dtype != torch.float32
            or not dgate.is_contiguous()):
        raise ValueError(f"moe_combine_backward writes a contiguous {tuple(buf.shape)} "
                         f"{buf.dtype} dbuf and a ({e_loc.numel()},) float32 dgate; got "
                         f"{tuple(dbuf.shape)} {dbuf.dtype} and {tuple(dgate.shape)} "
                         f"{dgate.dtype}")
    args = (g.contiguous(), buf.contiguous(), w.float().contiguous(), e_loc.int().contiguous(),
            slot.int().contiguous(), count.int().contiguous(), dbuf, dgate)
    _launch(_library().tf_moe_combine_backward, "combine backward", args,
            (n, k, d, buf.shape[1], buf.shape[0]), g.dtype, g.device)
    count_launch(moe_combine_backward)
    return dbuf, dgate


moe_dispatch.launches = 0
moe_combine.launches = 0
moe_combine_backward.launches = 0


def _dispatch_new(src: torch.Tensor, e_loc: torch.Tensor, slot: torch.Tensor,
                  count: torch.Tensor, e_local: int, capacity: int) -> torch.Tensor:
    """``tpuframe::moe_dispatch``: K9a (or its plain version) into a new
    (e_local, capacity, D) buffer, which it writes whole."""
    buf = torch.empty((e_local, capacity, src.shape[1]), dtype=src.dtype, device=src.device)
    return moe_dispatch(src, buf, e_loc, slot, count=count)


def _dispatch_fake(src, e_loc, slot, count, e_local, capacity):
    return src.new_empty((e_local, capacity, src.shape[1]))


def _combine_backward_new(g: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
                          e_loc: torch.Tensor, slot: torch.Tensor, count: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``tpuframe::moe_combine_backward``: K9c (or its plain versions) into
    a new ``dbuf`` and ``dgate``, which it writes whole."""
    return moe_combine_backward(
        g, buf, w, e_loc, slot, count, torch.empty(buf.shape, dtype=buf.dtype, device=buf.device),
        torch.empty(e_loc.numel(), dtype=torch.float32, device=buf.device))


def _combine_backward_fake(g, buf, w, e_loc, slot, count):
    return buf.new_empty(buf.shape), buf.new_empty((e_loc.numel(),), dtype=torch.float32)


custom_op("moe_dispatch", _dispatch_new, _dispatch_new, _dispatch_fake)
custom_op("moe_combine", _combine_cuda, _combine_cpu, _combine_fake)
custom_op("moe_combine_backward", _combine_backward_new, _combine_backward_new,
          _combine_backward_fake)


class _Dispatch(torch.autograd.Function):
    """K9a forward (tokens into the expert buffers, which it writes whole);
    K9b backward (the buffers' cotangent back to the tokens, ``w`` =
    keep)."""

    @staticmethod
    def forward(ctx, src, e_loc, slot, count, e_local, capacity):
        run = launch_site(torch.ops.tpuframe.moe_dispatch, _dispatch_new, _dispatch_new, src)
        buf = run(src, e_loc, slot, count, e_local, capacity)
        ctx.save_for_backward(e_loc, slot)
        ctx.n = src.shape[0]
        return buf

    @staticmethod
    def backward(ctx, g):
        e_loc, slot = ctx.saved_tensors
        keep = (e_loc >= 0).float()
        return moe_combine(g.contiguous(), keep, e_loc, slot, ctx.n), None, None, None, None, None


class _Combine(torch.autograd.Function):
    """K9b forward (the expert outputs back to the tokens, weighted); K9c
    backward (the cotangent into the buffers, scaled by the weights, and the
    weights' gradient, in one launch)."""

    @staticmethod
    def forward(ctx, buf, w, e_loc, slot, count, n):
        ctx.save_for_backward(buf, w, e_loc, slot, count)
        return moe_combine(buf, w, e_loc, slot, n)

    @staticmethod
    def backward(ctx, g):
        buf, w, e_loc, slot, count = ctx.saved_tensors
        run = launch_site(torch.ops.tpuframe.moe_combine_backward, _combine_backward_new,
                          _combine_backward_new, g)
        dbuf, dw = run(g.to(buf.dtype).contiguous(), buf, w, e_loc, slot, count)
        return dbuf, dw, None, None, None, None


# -- the public functions ------------------------------------------------------------


def _expert_products(expert_in, w_in, w_out, act):
    h = act(torch.bmm(expert_in, w_in))
    return torch.bmm(h, w_out)


def moe_dispatch_combine_reference(tokens: torch.Tensor, gate_vals: torch.Tensor,
                                   gate_idx: torch.Tensor, w_in: torch.Tensor,
                                   w_out: torch.Tensor, *, capacity: int,
                                   act: Callable = gelu_tanh) -> torch.Tensor:
    """JAX's dense GShard form: the one-hot (kN, E, C) dispatch tensor and
    its einsums, every expert on this process."""
    n, d = tokens.shape
    e = w_in.shape[0]
    choice_exp, pos, keep, tok_idx = _routing(gate_idx, e, capacity)
    dtype = w_in.dtype
    disp = (F.one_hot(choice_exp, e).to(tokens.dtype)[:, :, None]
            * F.one_hot(pos.clamp(0, capacity - 1).long(), capacity).to(tokens.dtype)[:, None, :]
            * keep[:, None, None].to(tokens.dtype))
    gates_flat = gate_vals.t().reshape(-1)
    expert_in = torch.einsum("fec,fd->ecd", disp, tokens[tok_idx].to(dtype))
    h = act(torch.einsum("ecd,edh->ech", expert_in, w_in))
    expert_out = torch.einsum("ech,ehd->ecd", h, w_out)
    combine = disp * gates_flat[:, None, None]
    out_flat = torch.einsum("fec,ecd->fd", combine, expert_out)
    out = torch.zeros((n, d), dtype=out_flat.dtype, device=out_flat.device)
    for part in out_flat.view(gate_idx.shape[1], n, d):  # JAX's .at[tok_idx].add, in order
        out = out + part
    return out


def moe_dispatch_combine(tokens: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor,
                         w_in: torch.Tensor, w_out: torch.Tensor, *, capacity: int,
                         act: Callable = gelu_tanh, fused: bool | None = None,
                         routed: tuple | None = None, expert_axis=None) -> torch.Tensor:
    """Top-k expert MLP: tokens -> the gated mixture of expert outputs.

    Args (JAX's, then the port's):
      tokens: (N, D) flattened tokens.
      gate_vals: (N, k) renormalized gate weights of the chosen experts.
      gate_idx: (N, k) chosen expert ids.
      w_in / w_out: (E, D, H) / (E, H, D) expert-stacked MLP weights (this
        rank's E / n under ``expert_axis``).
      capacity: per-expert buffer slots; overflow slots are dropped.
      fused: None or True, the row copies (K9a-K9c); False, the dense
        reference (one process holding every expert, ``routed`` None).
      routed: ``(choice_exp, pos, keep)`` of the rank's (kN,) slots from a
        routing over more tokens than these (``models.moe``'s global
        routing); None routes these tokens alone.
      expert_axis: the ``expert`` axis (a ``parallel.tensor.Axis``) when
        the experts are split over it (module docstring).

    Returns (N, D) combined outputs in ``w_out``'s dtype (dropped tokens
    contribute zero), differentiable in tokens, gate values and weights.
    """
    n, d = tokens.shape
    if gate_vals.shape != gate_idx.shape or gate_idx.shape[0] != n:
        raise ValueError(f"gate_vals/gate_idx must be (N, k), got {tuple(gate_vals.shape)}/"
                         f"{tuple(gate_idx.shape)} for N={n}")
    e_local = w_in.shape[0]
    split = expert_axis is not None and expert_axis.size > 1
    e = e_local * (expert_axis.size if split else 1)
    if fused is False:
        if split or routed is not None:
            raise ValueError("the dense reference runs every expert on one process over its "
                             "own tokens; take fused=None under a split or a global routing")
        return moe_dispatch_combine_reference(tokens, gate_vals, gate_idx, w_in, w_out,
                                              capacity=capacity, act=act)
    if routed is None:
        routed = _routing(gate_idx, e, capacity)[:3]
    choice_exp, _, keep = routed
    e0 = expert_axis.index * e_local if split else 0
    e_loc, slot, count = _descriptors(choice_exp, keep, e0, e_local)
    if split:  # the cotangents of the replicated inputs are summed over the experts
        tokens, gate_vals = expert_axis.copy_to_group(tokens), expert_axis.copy_to_group(gate_vals)
    rows = min(capacity, e_loc.numel())
    expert_in = _Dispatch.apply(tokens.to(w_in.dtype), e_loc, slot, count, e_local, rows)
    expert_out = _expert_products(expert_in, w_in, w_out, act)
    weight = gate_vals.t().reshape(-1).float() * keep.float()
    out = _Combine.apply(expert_out, weight, e_loc, slot, count, n)
    if split:
        from tpuframe_torch.parallel.tensor import reduce_from_group

        out = reduce_from_group(out, expert_axis)
    return out
