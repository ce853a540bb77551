"""Plan-level memory estimator: bytes from the ParallelPlan, no device.

The port's own copy of ``tpuframe/parallel/memory.py`` (stdlib only there,
so the arithmetic is the same code): ``plan_memory(plan, model_template)``
walks a template of leaves (tensors, arrays, or ``(shape, dtype)`` pairs,
the dtype a name or a torch dtype) and prices each under the plan's own
sharding semantics (``plan._rule_spec``, the ZeRO fsdp layering with its
``min_shard_elems`` gate and largest-divisible-dim placement, the batch
over the data axes) into a per-device budget of params, grads, optimizer
state, error-feedback residuals, batch and activations, keyed by
``plan.signature()``.  ``suggest_fit`` walks the escalation ladder (raise
``zero_stage``, more grad-accum microbatches, offload the optimizer) until
the estimate fits.  For the same plan and templates both return the JAX
package's dicts.

The dims are priced on the template's own shapes: pass the flax layout of
a leaf (as the JAX package's trees hold it) for JAX's placement; the byte
counts do not depend on it.  Activations are ``activation_factor x`` the
f32 bytes of one microbatch slice (stated in ``assumptions``).
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Mapping, Sequence

__all__ = [
    "DTYPE_BYTES",
    "PLAN_MEMORY_VERSION",
    "plan_memory",
    "suggest_fit",
]

#: schema version of the ``plan_memory`` record (rides into the
#: ``memory/oom`` event and the doctor's memory section).
PLAN_MEMORY_VERSION = "1.0"

#: fallback bytes-per-element by dtype *name* — used only when a leaf's
#: dtype has no ``.itemsize`` (e.g. a plain string in a ``(shape,
#: dtype)`` pair).  Unknown names price as 4 (f32): overestimating a
#: quantized leaf is the safe failure for a capacity check.
DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
}

_MB = 1024.0 * 1024.0

#: optimizer slot count when no ``opt_template`` is given: param-shaped
#: f32-class buffers per param leaf (adam keeps mu+nu; sgd a trace).
_OPT_SLOTS = {
    "adam": 2, "adamw": 2, "lamb": 2, "lion": 1,
    "sgd": 1, "momentum": 1, "adafactor": 1, "none": 0,
}


# -- template walking ---------------------------------------------------------

def _leaf_shape_dtype(x: Any) -> tuple[tuple[int, ...], Any] | None:
    """(shape, dtype) if ``x`` is a priceable leaf, else None."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(int(d) for d in x.shape), x.dtype
    if (
        isinstance(x, tuple)
        and not hasattr(x, "_fields")
        and len(x) == 2
        and isinstance(x[0], (tuple, list))
        and all(isinstance(d, int) for d in x[0])
        and (isinstance(x[1], str) or hasattr(x[1], "itemsize"))
    ):
        return tuple(x[0]), x[1]
    return None


def _walk(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[
    tuple[str, tuple[int, ...], Any]
]:
    """Yield ``(path, shape, dtype)`` per leaf; paths render ``a/b/c``
    like ``sharding.path_str`` so TP rules and param-suffix matching see
    the same strings the live tree would produce."""
    if tree is None:
        return
    leaf = _leaf_shape_dtype(tree)
    if leaf is not None:
        yield "/".join(prefix), leaf[0], leaf[1]
        return
    if isinstance(tree, Mapping):
        for k in tree:
            yield from _walk(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):  # optax states are NamedTuples
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + (str(name),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    # other scalars (ints, floats, strings) carry no buffer


def _dtype_bytes(dtype: Any) -> int:
    itemsize = getattr(dtype, "itemsize", None)
    if itemsize:
        return int(itemsize)
    name = str(getattr(dtype, "name", dtype)).lower()
    return DTYPE_BYTES.get(name, 4)


# -- sharding math ------------------------------------------------------------

def _spec_entries(spec: Any) -> tuple:
    """A PartitionSpec (or any sequence of axis entries) as a tuple."""
    return tuple(spec) if spec is not None else ()


def _with_fsdp(plan: Any, shape: Sequence[int], entries: tuple) -> tuple:
    """Layer the plan's fsdp axis onto ``entries`` — same decision
    procedure as ``ParallelPlan._maybe_fsdp`` (size/min_shard_elems
    gates, no duplicate axis, largest divisible untaken dim), kept apart
    so a hypothetical ZeRO stage can be priced without a plan of that
    stage."""
    size = plan.axis_size(plan.fsdp_axis)
    if size <= 1 or math.prod(shape) < plan.min_shard_elems:
        return entries
    named = {
        a for e in entries if e is not None
        for a in (e if isinstance(e, tuple) else (e,))
    }
    if plan.fsdp_axis in named:
        return entries
    ent = list(entries) + [None] * (len(shape) - len(entries))
    taken = {i for i, e in enumerate(ent) if e is not None}
    best = None
    for dim, s in enumerate(shape):
        if dim in taken or s % size or s < size:
            continue
        if best is None or s > shape[best]:
            best = dim
    if best is None:
        return entries
    ent[best] = plan.fsdp_axis
    return tuple(ent)


def _param_entries(plan: Any, path: str, shape: Sequence[int],
                   zero_stage: int) -> tuple:
    """``ParallelPlan.param_spec`` under a hypothetical ZeRO stage."""
    entries = _spec_entries(plan._rule_spec(path))
    if zero_stage == 3:
        entries = _with_fsdp(plan, shape, entries)
    return entries


def _state_entries(plan: Any, path: str, shape: Sequence[int],
                   zero_stage: int) -> tuple:
    """``ParallelPlan._state_spec`` under a hypothetical ZeRO stage."""
    entries = _spec_entries(plan._rule_spec(path))
    if len(entries) > len(shape):
        entries = ()
    if zero_stage >= 1:
        entries = _with_fsdp(plan, shape, entries)
    return entries


def _local_elems(plan: Any, shape: Sequence[int], entries: tuple) -> int:
    """Per-device element count after sharding ``shape`` by ``entries``."""
    elems = 1
    for i, size in enumerate(shape):
        e = entries[i] if i < len(entries) else None
        div = 1
        if e is not None:
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= plan.axis_size(a)
        elems *= -(-size // div)  # ceil: ragged shards pay the pad
    return max(elems, 1) if shape else 1


# -- the estimator ------------------------------------------------------------

def plan_memory(
    plan: Any,
    model_template: Any,
    batch_spec: Any = None,
    *,
    opt_template: Any = None,
    comms_template: Any = None,
    optimizer: str = "adam",
    microbatches: int | None = None,
    activation_factor: float = 2.0,
    top_leaves: int = 8,
    zero_stage: int | None = None,
    offload_optimizer: bool | None = None,
) -> dict:
    """Per-device memory budget for ``plan`` — stdlib math, no compile.

    Args:
      plan: a composed ``ParallelPlan`` (only its sharding-decision
        surface is used, so any object with the same methods works).
      model_template: param pytree of shape/dtype carriers.
      batch_spec: batch pytree of shape/dtype carriers (one step's
        global batch; the leading dim shards over the data axes).
      opt_template: optimizer-state pytree (e.g. from ``eval_shape``);
        when omitted, ``optimizer`` prices param-shaped slots instead.
      comms_template: error-feedback residual pytree (``TrainState
        .comms``); omitted = no EF term.
      microbatches: grad-accum split (None = plan.pp_microbatches or 1).
        Activations scale with one microbatch slice; the super-batch
        stays argument-resident.
      zero_stage / offload_optimizer: hypothetical overrides used by
        ``suggest_fit`` — default to the plan's own values.

    Returns a dict keyed by ``plan.signature()`` with ``per_device_mb``
    component breakdown, a ``top_leaves`` attribution table, and the
    ``assumptions`` that produced it.
    """
    stage = plan.zero_stage if zero_stage is None else int(zero_stage)
    offload = (
        bool(plan.offload_optimizer) if offload_optimizer is None
        else bool(offload_optimizer)
    )
    micro = int(microbatches or getattr(plan, "pp_microbatches", None) or 1)

    leaves: list[tuple[str, float]] = []  # (component:path, bytes)
    param_paths: list[str] = []
    params_b = grads_b = 0.0
    for path, shape, dtype in _walk(model_template):
        param_paths.append(path)
        bpe = _dtype_bytes(dtype)
        local = _local_elems(plan, shape, _param_entries(plan, path, shape, stage))
        params_b += local * bpe
        # grads are param-shaped and param-sharded (stage-3 partitions
        # them; stage 1/2's transient reduce-scatter shards are priced
        # as full grads — the conservative side)
        grads_b += local * bpe
        leaves.append((f"params:{path}", local * bpe))

    opt_b = 0.0
    if opt_template is not None:
        param_set = set(param_paths)
        for path, shape, dtype in _walk(opt_template):
            # longest param-path suffix identifies param-mirroring slots
            parts = path.split("/")
            match = next(
                ("/".join(parts[s:]) for s in range(len(parts))
                 if "/".join(parts[s:]) in param_set), path,
            )
            local = _local_elems(
                plan, shape, _state_entries(plan, match, shape, stage)
            )
            opt_b += local * _dtype_bytes(dtype)
            leaves.append((f"opt_state:{match}", local * _dtype_bytes(dtype)))
    else:
        slots = _OPT_SLOTS.get(optimizer.lower(), 2)
        for path, shape, dtype in _walk(model_template):
            local = _local_elems(
                plan, shape, _state_entries(plan, path, shape, stage)
            )
            opt_b += local * _dtype_bytes(dtype) * slots
            if slots:
                leaves.append(
                    (f"opt_state:{path}", local * _dtype_bytes(dtype) * slots)
                )

    ef_b = 0.0
    for path, shape, dtype in _walk(comms_template):
        local = _local_elems(plan, shape, _state_entries(plan, path, shape, stage))
        ef_b += local * _dtype_bytes(dtype)
        leaves.append((f"ef_residual:{path}", local * _dtype_bytes(dtype)))

    batch_b = 0.0
    batch_elems_local = 0
    batch_entries = _spec_entries(plan.batch_spec())
    for path, shape, dtype in _walk(batch_spec):
        local = _local_elems(plan, shape, batch_entries)
        batch_b += local * _dtype_bytes(dtype)
        batch_elems_local += local
        leaves.append((f"batch:{path}", local * _dtype_bytes(dtype)))

    # crude-by-design: activation_factor x one f32 microbatch slice
    act_b = activation_factor * batch_elems_local * 4.0 / max(micro, 1)

    hbm_b = params_b + grads_b + ef_b + batch_b + act_b
    host_b = 0.0
    if offload:
        host_b = opt_b
    else:
        hbm_b += opt_b

    leaves.sort(key=lambda kv: -kv[1])
    top = [
        {
            "component": name.split(":", 1)[0],
            "path": name.split(":", 1)[1],
            "mb": round(b / _MB, 3),
        }
        for name, b in leaves[: max(int(top_leaves), 0)]
    ]

    world = int(getattr(getattr(plan.mesh, "devices", None), "size", 0) or 0)
    round_mb = lambda b: round(b / _MB, 3)  # noqa: E731
    return {
        "schema_version": PLAN_MEMORY_VERSION,
        "plan_signature": plan.signature(),
        "topology": {
            "world": world,
            "dp": int(plan.dp_size),
            "tp": int(plan.axis_size("model")),
            "pp": int(plan.axis_size("pipe")),
            "sp": int(plan.axis_size("seq")),
            "zero_stage": stage,
            "microbatches": micro,
            "offload_optimizer": offload,
        },
        "per_device_mb": {
            "params": round_mb(params_b),
            "grads": round_mb(grads_b),
            "opt_state": round_mb(opt_b),
            "ef_residual": round_mb(ef_b),
            "batch": round_mb(batch_b),
            "activations": round_mb(act_b),
            "total": round_mb(hbm_b),
            "host_total": round_mb(host_b),
        },
        "top_leaves": top,
        "assumptions": {
            "optimizer": optimizer if opt_template is None else "template",
            "activation_factor": activation_factor,
            "grads": "param-sharded, param dtype",
            "activations": "factor x f32 bytes of one microbatch slice",
        },
    }


# -- fit suggestion -----------------------------------------------------------

def suggest_fit(
    plan: Any,
    model_template: Any,
    batch_spec: Any = None,
    *,
    budget_mb: float | None = None,
    opt_template: Any = None,
    comms_template: Any = None,
    optimizer: str = "adam",
    microbatches: int | None = None,
    activation_factor: float = 2.0,
) -> dict:
    """Walk the escalation ladder until the estimate fits.

    Rungs, cumulative and cheap-first (each is a restartable knob move,
    no mesh rebuild): raise ``zero_stage`` to 1 then 3, split grad-accum
    into 2x/4x microbatches, finally offload the optimizer to host.
    "Fits" means total <= 0.9 x ``budget_mb`` (headroom for allocator
    fragmentation); with no budget a rung counts as a fix when it cuts
    >= 20% off the base estimate.  Returns the base estimate, every rung
    priced, and ``suggestion`` = the first fitting rung (None when even
    the top rung doesn't fit — the caller should shrink the model or
    grow the mesh).
    """
    base_micro = int(microbatches or getattr(plan, "pp_microbatches", None) or 1)
    kw = dict(
        opt_template=opt_template, comms_template=comms_template,
        optimizer=optimizer, activation_factor=activation_factor,
        top_leaves=0,
    )
    base = plan_memory(
        plan, model_template, batch_spec, microbatches=base_micro, **kw
    )
    base_total = base["per_device_mb"]["total"]

    def fits(total_mb: float) -> bool:
        if budget_mb:
            return total_mb <= 0.9 * budget_mb
        return total_mb <= 0.8 * base_total

    stage0 = int(plan.zero_stage)
    rungs: list[dict] = []
    for s in (1, 3):
        if s > stage0:
            rungs.append({"zero_stage": s})
    top_stage = max(stage0, 3)
    for mult in (2, 4):
        rungs.append({"zero_stage": top_stage, "microbatches": base_micro * mult})
    rungs.append({
        "zero_stage": top_stage, "microbatches": base_micro * 4,
        "offload_optimizer": True,
    })

    candidates = []
    suggestion = None
    for rung in rungs:
        est = plan_memory(
            plan, model_template, batch_spec,
            zero_stage=rung.get("zero_stage", stage0),
            microbatches=rung.get("microbatches", base_micro),
            offload_optimizer=rung.get("offload_optimizer"),
            **kw,
        )
        total = est["per_device_mb"]["total"]
        cand = dict(rung, total_mb=total, fits=fits(total))
        candidates.append(cand)
        if suggestion is None and cand["fits"]:
            suggestion = dict(cand, estimate=est)

    return {
        "schema_version": PLAN_MEMORY_VERSION,
        "plan_signature": plan.signature(),
        "budget_mb": budget_mb,
        "base_total_mb": base_total,
        "base_fits": fits(base_total) if budget_mb else False,
        "candidates": candidates,
        "suggestion": suggestion,
    }
