"""The compressed gradient wire: bucketed int8 / fp8 all-reduce with error
feedback.

Port of ``tpuframe/parallel/compression.py`` for stage-0 data parallelism
over ``torch.distributed``:

- **Layout** (:func:`grad_layout`).  Float gradient leaves, sorted by
  name, are flattened into fixed-size float32 buckets, each with its own
  scale; integer leaves are summed exactly.  The layout is host-side
  Python, built once per (tree, config, plan).
- **The sync** (:func:`sync_gradients`), one bucket group at a time in
  fire order: per-bucket ``max |v|`` (K5a), the scale every rank agrees on
  (``all_reduce(MAX)``), the encode onto the int8 or e4m3 grid (K5b), the
  sum of the payloads (``all_reduce(SUM)`` of int32, or of float32-held
  e4m3 values, exact either way), and the decode to the mean (K5c).  The
  payload crosses the wire in its accumulator type, int32 or float32, as
  the JAX package's staged ``psum`` carries it, while :func:`wire_plan`
  meters one byte an element (the payload's own width).  The narrow bytes
  come with the fused transport, which is not ported.
- **Error feedback.**  Each rank's quantization error ``v - deq(Q(v))`` is
  its ``(1, n_buckets, bucket_elems)`` row of ``TrainState.comms["flat"]``
  and is added to its next gradient, so the compressed run tracks the f32
  one.  It is reset to zero in a bucket whose agreed scale is not finite.
- **Non-finite gradients** decode to NaN in their bucket, on every rank:
  a NaN abs-max is mapped to +inf before the ``MAX`` (NCCL's and gloo's
  max may drop a NaN; JAX's ``pmax`` keeps it), and the decode writes NaN
  where the agreed scale is not finite.

Without a process group no collective is called: at world 1 the wire is
the identity, as in JAX, and the kernels still run.  With one (even of one
rank) every collective goes through it.  Not ported, each raising
``NotImplementedError``: the fused transport where it would engage
(``fused_active``: world >= 2), ZeRO-sliced leaves, ``quantized_pmean``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Mapping

import torch
import torch.distributed as dist

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
    "resolve_fused",
    "sync_gradients",
    "wire_plan",
]

#: past this world size the fp8 wire's float32 partial sums could round
_FP8_EXACT_WORLD = 73
#: below this world size there is no wire to fuse
_MIN_FUSED_WORLD = 2


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported; it comes with a later item of the compressed-wire slice "
        "(ROADMAP.md, Queue 1)")


# -- canonical flat layout ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradLayout:
    """How a named gradient tree maps onto the wire.

    ``flat``: ``(name, shape, dtype, offset)`` in sorted-name order (bucket
    membership is a function of the sorted names alone); ``sliced``: ZeRO
    leaves (always empty here); ``exact``: the names of integer leaves,
    summed exactly.  ``group_bounds``: ``(start, stop)`` bucket ranges in
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
                group_buckets: int | None = None) -> GradLayout:
    """The wire layout of ``tree`` (name -> tensor, or anything with
    ``shape`` and a torch ``dtype``) under ``plan``.  ``group_buckets``
    splits the buckets into that many groups; None takes the plan's
    ``comms_groups``, then ``config.groups``."""
    mesh = getattr(plan, "mesh", None)
    if mesh is not None:
        axes = tuple(a for a in plan.data_axes if mesh.shape.get(a, 1) > 1) or tuple(
            plan.data_axes[:1])
        world = math.prod(int(mesh.shape.get(a, 1)) for a in axes)
    else:
        axes, world = (), 1
    flat, exact = [], []
    offset = 0
    for path in sorted(tree):
        leaf = tree[path]
        shape = tuple(int(d) for d in leaf.shape)
        if not leaf.dtype.is_floating_point:
            exact.append(path)
        else:
            flat.append((path, shape, _dtype_name(leaf.dtype), offset))
            offset += math.prod(shape)
    n, be = _bucket_layout(offset, config)
    if group_buckets is None:
        group_buckets = getattr(plan, "comms_groups", None)
    if group_buckets is None:
        group_buckets = getattr(config, "groups", 1) or 1
    return GradLayout(flat=tuple(flat), sliced=(), exact=tuple(exact), flat_elems=offset,
                      n_buckets=n, bucket_elems=be, axes=axes, world=world,
                      group_bounds=_group_bounds(n, group_buckets))


def comms_template(params: Mapping[str, Any], config: CommsConfig | None, plan: Any) -> dict:
    """The ``TrainState.comms`` residual structure: {key: global shape},
    ``(world, n_buckets, bucket_elems)`` for the buckets.  Empty when
    compression or error feedback is off."""
    if config is None or not config.error_feedback:
        return {}
    layout = grad_layout(params, config, plan)
    if not layout.flat_elems:
        return {}
    return {"flat": (layout.world, layout.n_buckets, layout.bucket_elems)}


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
    if x.dtype in (torch.int8, torch.int16, torch.uint8, torch.bool):
        return x.to(torch.int32)
    return x.clone()


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


def check_transport(layout: GradLayout, config: CommsConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's wire does not carry:
    an active fused transport, ZeRO-sliced leaves."""
    if fused_active(layout, config):
        raise _later(f"the fused transport at world {layout.world} (TPUFRAME_COMMS_FUSED / "
                     "ParallelPlan.comms_fused)")
    if layout.sliced:
        raise _later("ZeRO-sliced gradient leaves")


@torch.no_grad()
def sync_gradients(grads: Mapping[str, torch.Tensor], comms: Mapping[str, torch.Tensor],
                   layout: GradLayout, config: CommsConfig,
                   rng: torch.Generator | None = None):
    """Compress and average this rank's gradients across the process group.

    Returns ``(synced, new_comms)``: the mean gradients by name, in each
    leaf's dtype (integer leaves summed), and the new residuals.  ``comms``
    holds this rank's ``(1, ...)`` residual rows; empty = error feedback
    off.  Groups fire in ``layout.group_bounds`` order; every per-bucket
    quantity is elementwise over the buckets, so the grouping changes the
    schedule, never the bits."""
    # imported here: ops imports the optimizer, which imports the Trainer
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode

    check_transport(layout, config)
    wired = _wired()
    world = layout.world
    if wired and dist.get_world_size() != world:
        raise ValueError(f"the plan's world is {world} but the process group has "
                         f"{dist.get_world_size()} ranks")
    if not wired and world > 1:
        raise RuntimeError(f"a world of {world} needs a process group; call core.initialize()")
    ef = config.error_feedback and bool(comms)
    out: dict[str, torch.Tensor] = {}
    new_comms: dict[str, torch.Tensor] = {}
    if layout.flat_elems:
        parts = [grads[path].reshape(-1).to(torch.float32) for path, _, _, _ in layout.flat]
        pad = layout.padded_elems - layout.flat_elems
        if pad:
            parts.append(parts[0].new_zeros(pad))
        v = torch.cat(parts).view(layout.n_buckets, layout.bucket_elems)
        if ef:
            v = v + comms["flat"][0]
        # one draw over all buckets, sliced per group: the grouped schedule
        # rounds with the uniforms the single shot would
        noise = None
        if rng is not None and config.stochastic_rounding and config.mode != "fp8":
            noise = torch.rand(v.shape, generator=rng, device=v.device)
        bounds = layout.group_bounds or ((0, layout.n_buckets),)
        mean_seg, resid_seg = {}, {}
        for s, e in bounds:  # fire order: reverse-backward
            amax = _agreed_amax(bucket_abs_max(v[s:e]), wired)
            q, deq = _encode(v[s:e], amax, config,
                             noise=None if noise is None else noise[s:e])
            if ef:  # this rank's own payload, before the sum replaces it
                resid = v[s:e] - q.to(torch.float32) * deq
                resid_seg[s] = torch.where(torch.isfinite(amax), resid, 0.0)
            if wired:
                dist.all_reduce(q, op=dist.ReduceOp.SUM)
            mean_seg[s] = quant_decode(q, amax, config.mode, world)
        mean = torch.cat([mean_seg[s] for s in sorted(mean_seg)]).view(-1)
        if ef:
            new_comms["flat"] = torch.cat([resid_seg[s] for s in sorted(resid_seg)])[None]
        for path, shape, _, offset in layout.flat:
            size = math.prod(shape)
            out[path] = mean[offset:offset + size].view(shape).to(grads[path].dtype)
    for path in layout.exact:
        g = grads[path]
        total = _widen(g)
        if wired:
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        out[path] = total.to(g.dtype)
    synced = {name: out[name] for name in grads}
    if ef:
        new_comms = {k: new_comms.get(k, comms[k]) for k in comms}
    else:
        new_comms = dict(comms)
    return synced, new_comms


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
    completion), and adds the wire plan's bytes to ``comms/bytes_on_wire``."""
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
            check_transport(layout, config)
            cache[key] = (layout, wire_plan(layout, config))
        layout, plan_bytes = cache[key]
        tele = get_telemetry()
        t0 = time.perf_counter()
        with tele.span("comms/allreduce", mode=config.mode, bytes=plan_bytes["bytes_per_step"]):
            out, new_resid = sync_gradients(tree, residual, layout, config)
            for t in out.values():
                if t.device.type == "cuda":
                    torch.cuda.current_stream(t.device).synchronize()
                break
        tele.registry.histogram("comms/allreduce_s").observe(time.perf_counter() - t0)
        tele.registry.counter("comms/bytes_on_wire").inc(plan_bytes["bytes_per_step"])
        return out, new_resid

    return call
