"""The compressed gradient wire: bucketed int8 / fp8 all-reduce with error
feedback.

Port of ``tpuframe/parallel/compression.py`` over ``torch.distributed``:

- **Layout** (:func:`grad_layout`).  Float gradient leaves, sorted by
  name, are flattened into fixed-size float32 buckets, each with its own
  scale; integer leaves are summed exactly.  Under ZeRO stages 1-3 each
  leaf the plan's ``update_shard_specs`` slices over the data world goes
  its own way instead (the sliced leaves, below).  The layout is host-side
  Python, built once per (tree, config, plan).
- **The sync** (:func:`sync_gradients`), one bucket group at a time in
  fire order: per-bucket ``max |v|`` (K5a), the scale every rank agrees on
  (``all_reduce(MAX)``), the encode onto the int8 or e4m3 grid (K5b), the
  sum of the payloads, and the decode to the mean (K5c).  A group's sum is
  left in flight while the next group is issued; the decodes run once
  every sum has returned.  The train steps issue the groups from gradient
  hooks during the backward (``train.step``), through the same
  :class:`_WireRound`.
- **Two transports of the sum, bit-equal.**  The staged one is the
  backend's ``all_reduce(SUM)`` of the int32 or float32-held e4m3 payload,
  as the JAX package's staged ``psum`` carries it.  The fused one
  (``fused_active``: the knob, world >= 2, fp8 within the exact-sum bound)
  puts the narrow containers on the wire (:func:`_fused_allreduce`): a
  reduce-scatter, then an all-gather, in one of three forms, ``ring``
  (W - 1 hops each way, point to point), ``concurrent`` (one all-to-all of
  the one-byte payloads, a local sum, one all-gather of the int16 totals)
  and ``single`` (the staged all-reduce); :func:`_form_default` picks it by
  the process group's backend.  Every narrow container crosses as a byte
  view (``uint8``), which every backend carries.  Grid sums are exact, so
  every form gives the staged totals; a float total of zero is made +0.0
  on every path, as the JAX package's ``psum`` folds its sum into a +0.0
  identity (:func:`_canonical_zero`).  :func:`wire_plan` meters one byte
  an element either way.
- **Error feedback.**  Each rank's quantization error ``v - deq(Q(v))`` is
  its ``(1, n_buckets, bucket_elems)`` row of ``TrainState.comms["flat"]``
  and is added to its next gradient, so the compressed run tracks the f32
  one.  It is reset to zero in a bucket whose agreed scale is not finite.
- **Non-finite gradients** decode to NaN in their bucket, on every rank:
  a NaN abs-max is mapped to +inf before the ``MAX`` (NCCL's and gloo's
  max may drop a NaN; JAX's ``pmax`` keeps it), and the decode writes NaN
  where the agreed scale is not finite.
- **ZeRO-sliced leaves**, after the flat groups, in path order (reverse
  path order under a grouped schedule): the leaf's shard dim moved to the
  front as a (world, chunk) array, one agreed abs-max a chunk (K5a and a
  ``MAX``), the encode (K5b), a reduce-scatter (the staged path the
  backend's own, the fused path :func:`_reduce_scatter_chunks` in its
  form), and the decode of the owned chunk as a (1, chunk) row (K5c; NaN
  when any chunk's scale is not finite, as in JAX).  The owned chunk of
  the mean is what the train step's optimizer steps; each leaf's residual
  is full-shape, one row a rank.
- :func:`quantized_pmean`, the per-tensor int8 mean over the data axis.

Without a process group no collective is called: at world 1 the wire is
the identity, as in JAX, and the kernels still run.  With one (even of one
rank) every collective goes through it; the default process group is the
data axes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from tpuframe_torch.core.runtime import DATA_AXIS
from tpuframe_torch.parallel.comms_env import COMMS_ENV_VARS, CommsConfig
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "COMMS_ENV_VARS",
    "CommsConfig",
    "GradLayout",
    "comms_template",
    "fused_active",
    "grad_layout",
    "init_comms_state",
    "make_compressed_pmean",
    "quantized_pmean",
    "resolve_fused",
    "sync_gradients",
    "wire_plan",
]

#: past this world size the fp8 wire's float32 partial sums could round
_FP8_EXACT_WORLD = 73
#: below this world size there is no wire to fuse
_MIN_FUSED_WORLD = 2
#: int8-mode totals (and ring partial sums) fit int16 while W * 128 <= 2**15
_INT16_TOTAL_WORLD = 255
_QMAX = 127.0  # the symmetric int8 grid of quantized_pmean


# -- canonical flat layout ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradLayout:
    """How a named gradient tree maps onto the wire.

    ``flat``: ``(name, shape, dtype, offset)`` in sorted-name order (bucket
    membership is a function of the sorted names alone); ``sliced``: ZeRO
    leaves, ``(name, shape, dtype, dim)`` with ``dim`` the leaf's own shard
    dim; ``exact``: the names of integer leaves, summed exactly.  ``group_bounds``: ``(start, stop)`` bucket ranges in
    fire order (reverse bucket order); empty = one shot."""

    flat: tuple
    sliced: tuple
    exact: tuple
    flat_elems: int
    n_buckets: int
    bucket_elems: int
    axes: tuple
    world: int
    group_bounds: tuple = ()

    @property
    def padded_elems(self) -> int:
        return self.n_buckets * self.bucket_elems

    @property
    def n_groups(self) -> int:
        return len(self.group_bounds) or 1


def _bucket_layout(total: int, config: CommsConfig) -> tuple[int, int]:
    """(n_buckets, bucket_elems): fixed-size buckets covering ``total``
    elements with minimal tail padding (sizes round up to 64)."""
    if total <= 0:
        return 0, 0
    n = max(1, -(-total // config.bucket_elems))
    be = -(-total // n)
    be = -(-be // 64) * 64
    return n, be


def _group_bounds(n_buckets: int, groups: int) -> tuple:
    """``n_buckets`` in ``groups`` contiguous near-equal ranges, in fire
    order (reverse bucket order); more groups than buckets clamps to one
    bucket a group."""
    g = max(1, min(int(groups), n_buckets)) if n_buckets else 0
    if not g:
        return ()
    base, rem = divmod(n_buckets, g)
    bounds, start = [], 0
    for i in range(g):
        stop = start + base + (1 if i < rem else 0)
        bounds.append((start, stop))
        start = stop
    return tuple(reversed(bounds))


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the JAX layout's dtype column."""
    return str(dtype).removeprefix("torch.")


def grad_layout(tree: Mapping[str, Any], config: CommsConfig, plan: Any = None,
                group_buckets: int | None = None,
                orders: Mapping[str, Sequence[int]] | None = None) -> GradLayout:
    """The wire layout of ``tree`` (name -> tensor, or anything with
    ``shape`` and a torch ``dtype``) under ``plan``.  ``group_buckets``
    splits the buckets into that many groups; None takes the plan's
    ``comms_groups``, then ``config.groups``.  Under ZeRO stages 1-3 the
    leaves of ``plan.update_shard_specs`` are sliced, each on the dim JAX
    picks on its flax layout (``orders``: ``sharding.flax_orders``)."""
    mesh = getattr(plan, "mesh", None)
    if mesh is not None:
        axes = tuple(a for a in plan.data_axes if mesh.shape.get(a, 1) > 1) or tuple(
            plan.data_axes[:1])
        world = math.prod(int(mesh.shape.get(a, 1)) for a in axes)
    else:
        axes, world = (), 1
    update_specs: dict[str, tuple] = {}
    if plan is not None and getattr(plan, "zero_stage", 0) in (1, 2, 3):
        update_specs = plan.update_shard_specs(tree, orders)
    flat, sliced, exact = [], [], []
    offset = 0
    for path in sorted(tree):
        leaf = tree[path]
        shape = tuple(int(d) for d in leaf.shape)
        if not leaf.dtype.is_floating_point:
            exact.append(path)
        elif path in update_specs:
            sliced.append((path, shape, _dtype_name(leaf.dtype), update_specs[path][0]))
        else:
            flat.append((path, shape, _dtype_name(leaf.dtype), offset))
            offset += math.prod(shape)
    n, be = _bucket_layout(offset, config)
    if group_buckets is None:
        group_buckets = getattr(plan, "comms_groups", None)
    if group_buckets is None:
        group_buckets = getattr(config, "groups", 1) or 1
    return GradLayout(flat=tuple(flat), sliced=tuple(sliced), exact=tuple(exact),
                      flat_elems=offset,
                      n_buckets=n, bucket_elems=be, axes=axes, world=world,
                      group_bounds=_group_bounds(n, group_buckets))


def _leaf_key(path: str) -> str:
    """The ``comms`` key of a sliced leaf's residual (the JAX package's)."""
    return "leaf." + path.replace("/", ".")


def comms_template(params: Mapping[str, Any], config: CommsConfig | None, plan: Any) -> dict:
    """The ``TrainState.comms`` residual structure: {key: global shape},
    ``(world, n_buckets, bucket_elems)`` for the buckets and ``(world,
    *shape)`` for each sliced leaf.  Empty when compression or error
    feedback is off."""
    if config is None or not config.error_feedback:
        return {}
    layout = grad_layout(params, config, plan)
    out: dict[str, tuple] = {}
    if layout.flat_elems:
        out["flat"] = (layout.world, layout.n_buckets, layout.bucket_elems)
    for path, shape, _, _ in layout.sliced:
        out[_leaf_key(path)] = (layout.world,) + shape
    return out


def init_comms_state(params: Mapping[str, torch.Tensor], plan: Any,
                     config: CommsConfig | None) -> dict:
    """Zero error-feedback residuals for ``TrainState.comms``: each rank
    holds its own row of the template, ``(1, n_buckets, bucket_elems)``
    float32 on the parameters' device."""
    template = comms_template(params, config, plan)
    if not template:
        return {}
    device = next(iter(params.values())).device
    return {key: torch.zeros((1,) + tuple(shape[1:]), dtype=torch.float32, device=device)
            for key, shape in template.items()}


# -- quantization -------------------------------------------------------------


def _encode(v: torch.Tensor, amax: torch.Tensor, config: CommsConfig,
            noise: torch.Tensor | None = None):
    """``(payload, deq)`` of ``v`` against the agreed ``amax`` (K5b on the
    card): int32-held int8 or float32-held e4m3 values, and the factor
    that maps summed payloads back to gradient units.  Stochastic rounding
    (int8 only) takes ``noise``, uniforms like ``v``."""
    from tpuframe_torch.ops.quant_wire import quant_encode

    if config.mode == "fp8" or not config.stochastic_rounding:
        noise = None
    return quant_encode(v, amax, config.mode, noise=noise)


def _wired() -> bool:
    return dist.is_available() and dist.is_initialized()


def _agreed_amax(amax: torch.Tensor, wired: bool) -> torch.Tensor:
    """The abs-max every rank agrees on.  A NaN is first mapped to +inf:
    the collective's max may drop it, and either way the bucket then
    decodes to NaN and keeps no residual."""
    amax = torch.where(torch.isnan(amax), torch.inf, amax)
    if wired:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    return amax


def _widen(x: torch.Tensor) -> torch.Tensor:
    """Narrow integer leaves overflow their own dtype under a sum: widen
    to int32 for the collective."""
    if x.dtype in (torch.int8, torch.int16, torch.uint8, torch.uint16, torch.bool):
        return x.to(torch.int32)
    return x.clone()


@torch.no_grad()
def quantized_pmean(tree: Any, axis_names: Sequence[str] | str) -> Any:
    """Mean of a gradient tree (a tensor, or mappings and sequences of
    them) across the ranks of ``axis_names``, int8 payloads with one scale
    a tensor: the per-tensor form of the wire, called by every rank with
    its own tree.

    Each float leaf takes the abs-max every rank agrees on (a NaN mapped to
    +inf first), rounds half to even onto the int8 grid of that scale,
    sums the int32 payloads and scales the total back to the mean; it is
    NaN where the agreed abs-max is not finite.  Integer and bool leaves
    are summed exactly, narrow ones widened to int32 for the sum and cast
    back.  The port's mesh has the data axis alone; another name raises
    ``ValueError``."""
    names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    other = [a for a in names if a != DATA_AXIS]
    if other:
        raise ValueError(f"quantized_pmean over {other}: the port's mesh has only the "
                         f"{DATA_AXIS!r} axis; other axes come with ROADMAP.md Queue 1 item 7")
    wired = _wired() and bool(names)
    world = dist.get_world_size() if wired else 1

    def reduce_leaf(g: torch.Tensor) -> torch.Tensor:
        if not g.is_floating_point():
            total = _widen(g)
            if wired:
                dist.all_reduce(total, op=dist.ReduceOp.SUM)
            return total.to(g.dtype)
        g32 = g.to(torch.float32)
        amax = _agreed_amax(g32.abs().amax() if g.numel() else g32.new_zeros(()), wired)
        scale = torch.maximum(amax, amax.new_full((), torch.finfo(torch.float32).tiny)) / _QMAX
        q = torch.clip(torch.round(g32 / scale), -_QMAX, _QMAX)
        total = torch.where(torch.isnan(q), 0.0, q).to(torch.int32)
        if wired:
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        out = (total.to(torch.float32) * scale / world).to(g.dtype)
        return torch.where(torch.isfinite(amax), out, torch.nan)

    def walk(node):
        if torch.is_tensor(node):
            return reduce_leaf(node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"quantized_pmean takes tensors in mappings and sequences, got "
                        f"{type(node).__name__}")

    return walk(tree)


def fused_active(layout: GradLayout, config: CommsConfig) -> bool:
    """Would the in-collective (fused) transport engage: the knob, one
    data axis, world >= 2, and for fp8 a world inside the exact-sum bound."""
    if not getattr(config, "fused", False):
        return False
    if len(layout.axes) != 1 or layout.world < _MIN_FUSED_WORLD:
        return False
    if config.mode == "fp8" and layout.world > _FP8_EXACT_WORLD:
        return False
    return True


def resolve_fused(plan: Any, config: CommsConfig | None) -> CommsConfig | None:
    """Fold a pinned ``ParallelPlan.comms_fused`` into ``config``: the plan
    wins over the env knob."""
    pinned = getattr(plan, "comms_fused", None)
    if config is None or pinned is None:
        return config
    return dataclasses.replace(config, fused=bool(pinned))


# -- the fused (in-collective) transport --------------------------------------


def _form_default() -> str:
    """The fused transport's form for the default process group's backend,
    as JAX's goes by its platform: ``"concurrent"`` on NCCL (JAX's GPU
    choice: one all-to-all of the one-byte payloads, a local sum, one
    all-gather), ``"single"`` on gloo and anything else (JAX's choice for a
    backend without an async collective scheduler: the staged all-reduce).
    Without a group every form is the world-1 identity."""
    if not _wired():
        return "single"
    return "concurrent" if "nccl" in str(dist.get_backend()) else "single"


def _narrow_wire(buf: torch.Tensor):
    """``(sent, widen)``: the one-byte container of *un-summed* payloads,
    int8 for the int32-held int8 grid and e4m3 for the float32-held e4m3
    grid, and the cast back.  Exact by the encode contract."""
    if buf.dtype == torch.int32:
        return buf.to(torch.int8), lambda g: g.to(torch.int32)
    if buf.dtype == torch.float32:
        return buf.to(torch.float8_e4m3fn), lambda g: g.to(torch.float32)
    return buf, lambda g: g


def _narrow_total(buf: torch.Tensor, world: int):
    """``(sent, widen)``: the container of summed int8-grid payloads, int16
    while ``world <= 255`` (a NaN bucket's payload is 0 on the int8 grid, so
    the bound holds there too).  Float totals leave the e4m3 grid and stay
    float32."""
    if buf.dtype == torch.int32 and world <= _INT16_TOTAL_WORLD:
        return buf.to(torch.int16), lambda g: g.to(torch.int32)
    return buf, lambda g: g


def _canonical_zero(buf: torch.Tensor) -> torch.Tensor:
    """A float zero total made +0.0, in place: JAX's ``psum`` folds its
    sum into a +0.0 identity, so a sum of -0.0 payloads (fp8 underflow) is
    +0.0 there, while gloo's, NCCL's and a chained sum keep -0.0.  NaN and
    integer totals pass unchanged."""
    if buf.is_floating_point():
        buf.masked_fill_(buf == 0, 0.0)
    return buf


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The byte view a narrow container crosses the wire as: gloo refuses
    int16 and float8 in some collectives, and every backend carries
    uint8."""
    return t.contiguous().view(torch.uint8)


def _group_rank(group=None) -> int:
    """This process's rank inside ``group`` (None: the default group)."""
    return dist.get_rank() if group is None else dist.get_group_rank(group, dist.get_rank())


def _exchange(sent: torch.Tensor, group=None) -> torch.Tensor:
    """One ring hop: ``sent`` to the next rank of ``group``, the same shape
    from the previous one."""
    rank, world = _group_rank(group), dist.get_world_size(group)

    def peer(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    got = torch.empty_like(sent)
    ops = [dist.P2POp(dist.isend, _bytes(sent), peer((rank + 1) % world), group),
           dist.P2POp(dist.irecv, got.view(torch.uint8), peer((rank - 1) % world), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got


def _ring_reduce_scatter(own: torch.Tensor, group=None, exact: bool = False) -> torch.Tensor:
    """Exact ring reduce-scatter: ``own`` is this rank's (W, chunk)
    contribution; rank *i* ends owning the sum of chunk *i*.  W - 1 hops,
    each carrying one partial sum in :func:`_narrow_total`'s container
    (as it is with ``exact``), widened and summed on arrival in the
    payload's accumulator dtype."""
    world = own.shape[0]
    if world == 1:
        return own[0]
    my = _group_rank(group)
    buf = own[(my - 1) % world]
    for hop in range(world - 1):
        sent, widen = (buf, _same) if exact else _narrow_total(buf, world)
        buf = widen(_exchange(sent, group)) + own[(my - 2 - hop) % world]
    return buf if exact else _canonical_zero(buf)


def _a2a_reduce_scatter(own: torch.Tensor, group=None, exact: bool = False) -> torch.Tensor:
    """Exact concurrent reduce-scatter: one all-to-all of the one-byte
    containers (of the values as they are with ``exact``) gives each rank
    every peer's contribution to its chunk, then a local sum over the peers
    in rank order."""
    world = own.shape[0]
    if world == 1:
        return own[0]
    sent, widen = (own, _same) if exact else _narrow_wire(own)
    got = torch.empty_like(sent)
    dist.all_to_all_single(got.view(torch.uint8), _bytes(sent), group=group)
    wide = widen(got)
    if exact:  # chained in rank order, as a backend's sum of the same terms
        total = wide[0].clone()
        for row in wide[1:]:
            total += row
        return total
    return _canonical_zero(wide.sum(0, dtype=wide.dtype))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _reduce_scatter_chunks(own: torch.Tensor, form: str | None = None, group=None,
                           exact: bool = False) -> torch.Tensor:
    """The fused transport's reduce-scatter of the (W, chunk) contributions
    over ``group`` (None: the default group) in ``form`` (default
    :func:`_form_default`); ``"single"`` is the backend's own
    reduce-scatter.  ``exact`` sums the values as they are (the
    uncompressed ZeRO gradients): no narrow containers, and a zero sum
    keeps the sign the backend gives it."""
    form = form or _form_default()
    if form == "ring":
        return _ring_reduce_scatter(own, group, exact)
    if form == "concurrent":
        return _a2a_reduce_scatter(own, group, exact)
    if own.shape[0] == 1:
        return own[0]
    mine = own.new_empty(own.shape[1:])
    dist.reduce_scatter_tensor(mine.view(-1), own.contiguous().view(-1), op=dist.ReduceOp.SUM,
                               group=group)
    return mine if exact else _canonical_zero(mine)


def _ring_all_gather(chunk: torch.Tensor, world: int, group=None,
                     exact: bool = False) -> torch.Tensor:
    """Exact ring all-gather: rank *i*'s ``chunk`` lands at index *i* of
    every rank's (W, chunk) result after W - 1 hops of narrowed totals (as
    they are with ``exact``)."""
    if world == 1:
        return chunk[None]
    my = _group_rank(group)
    sent, widen = (chunk, _same) if exact else _narrow_total(chunk, world)
    out = sent.new_zeros((world,) + tuple(sent.shape))
    out[my] = sent
    buf = sent
    for hop in range(world - 1):
        buf = _exchange(buf, group)
        out[(my - 1 - hop) % world] = buf
    return widen(out)


def _all_gather_chunks(chunk: torch.Tensor, world: int, form: str | None = None, group=None,
                       exact: bool = False) -> torch.Tensor:
    """The fused transport's all-gather of each rank's reduced chunk into a
    (W, chunk) array over ``group``: the ring form hop by hop, the
    concurrent form one all-gather of the narrowed container, the single
    form one all-gather as it is.  ``exact`` sends every form's values as
    they are (the ZeRO parameter slices)."""
    form = form or _form_default()
    if form == "ring":
        return _ring_all_gather(chunk, world, group, exact)
    if world == 1:
        return chunk[None]
    sent, widen = (_narrow_total(chunk, world) if form == "concurrent" and not exact
                   else (chunk, _same))
    out = sent.new_empty((world,) + tuple(sent.shape))
    dist.all_gather_into_tensor(out.view(-1).view(torch.uint8), _bytes(sent).view(-1),
                                group=group)
    return widen(out)


class _Pending:
    """A sum in flight: ``wait()`` returns it (a zero total made +0.0 where
    the sum had more than one term)."""

    def __init__(self, value: torch.Tensor, work=None, terms: int = 1):
        self.value, self.work, self.terms = value, work, terms

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
            if self.terms > 1:
                _canonical_zero(self.value)
        return self.value


def _all_reduce_sum(q: torch.Tensor, async_op: bool = False):
    """The staged transport: the backend's ``all_reduce(SUM)`` of the
    payload in its accumulator dtype, in place, then :func:`_canonical_zero`
    (a :class:`_Pending` when ``async_op``)."""
    pending = _Pending(q, dist.all_reduce(q, op=dist.ReduceOp.SUM, async_op=True),
                       dist.get_world_size())
    return pending if async_op else pending.wait()


def _fused_allreduce(q: torch.Tensor, world: int, form: str | None = None,
                     async_op: bool = False):
    """In-collective sum of an encoded payload over the default process
    group: a reduce-scatter of the int8- or e4m3-grid values, then an
    all-gather of the reduced chunks, the ``ring`` and ``concurrent`` forms
    shipping the narrow containers.  Grid sums are exact, so every form
    returns the staged transport's totals bit for bit (a zero total +0.0).
    ``q`` is left as it was.  With ``async_op`` a :class:`_Pending`: the
    single form's one all-reduce is left in flight; the ring's and the
    concurrent form's later steps need their earlier ones, so they run to
    their end first."""
    if world == 1:
        return _Pending(q) if async_op else q
    form = form or _form_default()
    if form == "single":
        return _all_reduce_sum(q.clone(), async_op)
    size = q.numel()
    chunk = -(-size // world)
    flat = q.reshape(-1)
    if world * chunk != size:
        flat = torch.cat([flat, flat.new_zeros(world * chunk - size)])
    own = flat.view(world, chunk)
    mine = _reduce_scatter_chunks(own, form)
    full = _all_gather_chunks(mine, world, form).reshape(-1)[:size].view(q.shape)
    return _Pending(full) if async_op else full


class _WireRound:
    """One sync of a named gradient tree through the wire, group by group.

    ``deliver(name, grad)`` copies a leaf's final gradient into the float32
    bucket array (during the backward, where the hooks deliver); once every
    leaf a group covers has arrived, and every group before it in fire
    order has been issued, the group is issued: its abs-max (K5a), the
    agreed scale, the encode (K5b), the residual, and its sum, left in
    flight.  ``finish()`` waits for the sums in fire
    order, decodes them (K5c) and returns ``(synced, new_comms)`` as
    :func:`sync_gradients` does.  Groups are issued in the layout's order,
    never in the order they become ready, so every rank issues its
    collectives in one sequence.  Every per-bucket quantity is elementwise
    over the buckets, so the grouping and the moment of issue change the
    schedule, never the bits."""

    def __init__(self, layout: GradLayout, config: CommsConfig,
                 comms: Mapping[str, torch.Tensor], device: torch.device,
                 rng: torch.Generator | None = None):
        self.wired = _wired()
        world = layout.world
        if self.wired and dist.get_world_size() != world:
            raise ValueError(f"the plan's world is {world} but the process group has "
                             f"{dist.get_world_size()} ranks")
        if not self.wired and world > 1:
            raise RuntimeError(f"a world of {world} needs a process group; call "
                               "core.initialize()")
        self.layout, self.config, self.comms = layout, config, comms
        self.ef = config.error_feedback and bool(comms)
        self.fused = fused_active(layout, config)
        self.bounds = layout.group_bounds or (((0, layout.n_buckets),)
                                              if layout.flat_elems else ())
        self.v = self.noise = None
        if layout.flat_elems:
            self.v = torch.empty((layout.n_buckets, layout.bucket_elems), dtype=torch.float32,
                                 device=device)
            self.v.view(-1)[layout.flat_elems:].zero_()
            # one draw over all buckets, sliced per group: the grouped
            # schedule rounds with the uniforms the single shot would
            if rng is not None and config.stochastic_rounding and config.mode != "fp8":
                self.noise = torch.rand(self.v.shape, generator=rng, device=device)
        #: the sliced leaves' stochastic-rounding stream (after the buckets' draw)
        self.noise_rng = (rng if rng is not None and config.stochastic_rounding
                          and config.mode != "fp8" else None)
        be = layout.bucket_elems
        #: leaf name -> (offset, size, the groups whose buckets it touches);
        #: a group of padding alone (buckets round up to 64 elements) waits
        #: for no leaf
        self.leaves = {}
        self.waiting = [0] * len(self.bounds)
        for path, shape, _, offset in layout.flat:
            size = math.prod(shape)
            groups = [i for i, (s, e) in enumerate(self.bounds)
                      if offset < e * be and offset + size > s * be]
            for i in groups:
                self.waiting[i] += 1
            self.leaves[path] = (offset, size, groups)
        self.delivered: dict[str, torch.dtype] = {}
        self.exact: dict[str, torch.Tensor] = {}
        self.sliced_names = {path for path, _, _, _ in layout.sliced}
        self.issued: list[tuple] = []  # (start, amax, pending sum, residual)

    def deliver(self, path: str, grad: torch.Tensor) -> None:
        """Leaf ``path``'s final gradient; issues every group it completes
        (and the ready groups after it in fire order)."""
        if path in self.delivered:
            raise RuntimeError(f"gradient {path!r} delivered twice in one sync")
        self.delivered[path] = grad.dtype
        if path in self.leaves:
            offset, size, groups = self.leaves[path]
            self.v.view(-1)[offset:offset + size].copy_(grad.reshape(-1))
            for i in groups:
                self.waiting[i] -= 1
            while len(self.issued) < len(self.bounds) and not self.waiting[len(self.issued)]:
                self._issue(*self.bounds[len(self.issued)])
        else:  # an exact or a sliced leaf: sent after the backward
            self.exact[path] = grad

    def _issue(self, s: int, e: int) -> None:
        from tpuframe_torch.ops.quant_wire import bucket_abs_max

        seg = self.v[s:e]
        if self.ef:
            seg.add_(self.comms["flat"][0][s:e])
        amax = _agreed_amax(bucket_abs_max(seg), self.wired)
        q, deq = _encode(seg, amax, self.config,
                         noise=None if self.noise is None else self.noise[s:e])
        resid = None
        if self.ef:  # this rank's own payload, before the sum replaces it
            resid = torch.where(torch.isfinite(amax), seg - q.to(torch.float32) * deq, 0.0)
        if not self.wired:
            total = _Pending(q)
        elif self.fused:
            total = _fused_allreduce(q, self.layout.world, async_op=True)
        else:
            total = _all_reduce_sum(q, async_op=True)
        self.issued.append((s, amax, total, resid))

    def finish(self) -> tuple[dict, dict]:
        """Wait for every group's sum in fire order, decode, and return
        ``(synced, new_comms)``."""
        from tpuframe_torch.ops.quant_wire import quant_decode

        missing = [p for p in self.leaves if p not in self.delivered]
        if missing:
            raise RuntimeError(f"the sync is missing the gradients of {missing[:4]}")
        layout, comms = self.layout, self.comms
        out: dict[str, torch.Tensor] = {}
        new_comms: dict[str, torch.Tensor] = {}
        if self.issued:
            mean_seg, resid_seg = {}, {}
            for s, amax, total, resid in self.issued:
                mean_seg[s] = quant_decode(total.wait(), amax, self.config.mode, layout.world)
                resid_seg[s] = resid
            mean = torch.cat([mean_seg[s] for s in sorted(mean_seg)]).view(-1)
            if self.ef:
                new_comms["flat"] = torch.cat([resid_seg[s] for s in sorted(resid_seg)])[None]
            for path, shape, _, offset in layout.flat:
                out[path] = mean[offset:offset + math.prod(shape)].view(shape).to(
                    self.delivered[path])
        sliced = list(enumerate(layout.sliced))
        if layout.group_bounds[1:]:  # a grouped schedule: reverse path order
            sliced.reverse()
        for tag, (path, shape, _, dim) in sliced:
            out[path], resid = self._slice_sync(tag, path, shape, dim)
            if resid is not None:
                new_comms[_leaf_key(path)] = resid
        for path in layout.exact:
            g = self.exact[path]
            total = _widen(g)
            if self.wired:
                dist.all_reduce(total, op=dist.ReduceOp.SUM)
            out[path] = total.to(g.dtype)
        if self.ef:
            new_comms = {k: new_comms.get(k, comms[k]) for k in comms}
        else:
            new_comms = dict(comms)
        return out, new_comms


    def _slice_sync(self, tag: int, path: str, shape: tuple, dim: int):
        """One sliced leaf: ``(owned chunk of the mean, new residual or
        None)``.  The chunk is the leaf's shard dim moved to the front,
        rows ``[i * c, (i + 1) * c)`` for rank ``i``, in the leaf's dtype."""
        from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode

        world, grad = self.layout.world, self.exact[path]
        g = grad.to(torch.float32)
        if self.ef:
            g = g + self.comms[_leaf_key(path)][0]
        moved = g.movedim(dim, 0)
        rows = moved.reshape(world, -1).contiguous()  # (world, chunk): one scale a chunk
        amax = _agreed_amax(bucket_abs_max(rows), self.wired)
        noise = None
        if self.noise_rng is not None:
            noise = torch.rand(rows.shape, generator=self.noise_rng, device=rows.device)
        q, deq = _encode(rows, amax, self.config, noise=noise)
        if not self.wired:
            mine = q[0]
        else:
            form = _form_default() if self.fused else "single"
            mine = _reduce_scatter_chunks(q, form)
        index = dist.get_rank() if self.wired else 0
        finite = torch.isfinite(amax).all()
        own_amax = torch.where(finite, amax[index], torch.inf).reshape(1, 1)
        mean = quant_decode(mine.reshape(1, -1), own_amax, self.config.mode, world)
        chunk_shape = (moved.shape[0] // world,) + tuple(moved.shape[1:])
        mean = mean.view(chunk_shape).to(grad.dtype)
        resid = None
        if self.ef:
            r = torch.where(finite, rows - q.to(torch.float32) * deq, 0.0)
            resid = r.view(moved.shape).movedim(0, dim)[None]
        return mean, resid


@torch.no_grad()
def sync_gradients(grads: Mapping[str, torch.Tensor], comms: Mapping[str, torch.Tensor],
                   layout: GradLayout, config: CommsConfig,
                   rng: torch.Generator | None = None):
    """Compress and average this rank's gradients across the process group.

    Returns ``(synced, new_comms)``: the mean gradients by name, in each
    leaf's dtype (integer leaves summed; for a sliced leaf the owned chunk
    of its mean, the shard dim moved to the front), and the new
    residuals.  ``comms``
    holds this rank's ``(1, ...)`` residual rows; empty = error feedback
    off.  Groups are issued in ``layout.group_bounds`` order, each sum left
    in flight while the next is issued; the sums go through the fused
    transport where ``fused_active`` holds, else through the staged
    all-reduce (module docstring)."""
    device = next(iter(grads.values())).device if grads else torch.device("cpu")
    sync = _WireRound(layout, config, comms, device, rng)
    for path, shape, _, _ in layout.flat:
        sync.deliver(path, grads[path])
    for path in layout.exact:
        sync.deliver(path, grads[path])
    for path, _, _, _ in layout.sliced:
        sync.deliver(path, grads[path])
    synced, new_comms = sync.finish()
    return {name: synced[name] for name in grads}, new_comms


# -- static wire accounting ---------------------------------------------------


def wire_plan(layout: GradLayout, config: CommsConfig, exact_bytes: int = 0) -> dict:
    """Per-step bytes each rank puts on the wire, ring model (an all-reduce
    moves ``2 (W - 1) / W`` payloads), one byte a payload element: the JAX
    package's dict, key for key.  The f32 column is the same reduction
    uncompressed."""
    W = layout.world
    if W <= 1:
        return {
            "mode": config.mode, "world": W, "bytes_per_step": 0,
            "f32_bytes_per_step": 0, "reduction_x": None,
            "n_buckets": layout.n_buckets,
            "bucket_elems": layout.bucket_elems,
            "flat_elems": layout.flat_elems,
            "sliced_leaves": len(layout.sliced),
            "overlap_groups": layout.n_groups,
            "fused": False,
            "fused_hops": 0,
            "groups": [],
        }
    ar = 2.0 * (W - 1) / W
    rs = 1.0 * (W - 1) / W  # a reduce-scatter or all-gather leg
    bpe = config.wire_bytes_per_elem
    comp = f32 = 0.0
    groups = []
    if layout.flat_elems:
        comp += ar * (layout.padded_elems * bpe + layout.n_buckets * 4)
        f32 += ar * layout.flat_elems * 4
        for s, e in (layout.group_bounds or ((0, layout.n_buckets),)):
            nb = e - s
            groups.append({
                "buckets": nb,
                "payload_bytes": int(round(ar * nb * layout.bucket_elems * bpe)),
                "scale_bytes": int(round(ar * nb * 4)),
            })
    for _, shape, _, _ in layout.sliced:
        size = math.prod(shape)
        # the quantized reduce-scatter and the per-chunk scales, then the
        # f32 all-gather of the updated slices
        comp += rs * size * bpe + ar * W * 4 + rs * size * 4
        f32 += ar * size * 4
    comp += ar * exact_bytes
    f32 += ar * exact_bytes
    fused = fused_active(layout, config)
    return {
        "mode": config.mode,
        "world": W,
        "bytes_per_step": int(round(comp)),
        "f32_bytes_per_step": int(round(f32)),
        "reduction_x": round(f32 / comp, 3) if comp else None,
        "n_buckets": layout.n_buckets,
        "bucket_elems": layout.bucket_elems,
        "flat_elems": layout.flat_elems,
        "sliced_leaves": len(layout.sliced),
        "overlap_groups": layout.n_groups,
        "fused": fused,
        "fused_hops": 2 * (W - 1) if fused else 0,
        "groups": groups,
    }


# -- host-callable measured collective ---------------------------------------


def make_compressed_pmean(plan: Any, config: CommsConfig | str = "int8"):
    """A measured, host-callable compressed mean over the plan's ranks:
    ``fn(tree, residual={}) -> (mean_tree, new_residual)``, called by every
    rank with its own tree.  Each call runs under a ``comms/allreduce``
    span, observes ``comms/allreduce_s`` (wall time to the device's
    completion), and adds the wire plan's bytes to ``comms/bytes_on_wire``;
    through the fused transport, a ``comms/fused_hop`` span (``hops``,
    ``world``, ``mode``) inside it."""
    if not isinstance(config, CommsConfig):
        config = CommsConfig(mode=config)
    config = resolve_fused(plan, config)
    cache: dict[tuple, tuple] = {}

    def call(tree: Mapping[str, torch.Tensor], residual: Mapping[str, torch.Tensor] | None = None):
        residual = dict(residual or {})
        key = tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(tree.items())) + (
            bool(residual),)
        if key not in cache:
            layout = grad_layout(tree, config, plan)
            cache[key] = (layout, wire_plan(layout, config))
        layout, plan_bytes = cache[key]
        tele = get_telemetry()
        t0 = time.perf_counter()
        with tele.span("comms/allreduce", mode=config.mode, bytes=plan_bytes["bytes_per_step"]):
            with (tele.span("comms/fused_hop", hops=plan_bytes["fused_hops"],
                            world=plan_bytes["world"], mode=config.mode)
                  if plan_bytes["fused"] else contextlib.nullcontext()):
                out, new_resid = sync_gradients(tree, residual, layout, config)
                for t in out.values():
                    if t.device.type == "cuda":
                        torch.cuda.current_stream(t.device).synchronize()
                    break
        tele.registry.histogram("comms/allreduce_s").observe(time.perf_counter() - t0)
        tele.registry.counter("comms/bytes_on_wire").inc(plan_bytes["bytes_per_step"])
        return out, new_resid

    return call
