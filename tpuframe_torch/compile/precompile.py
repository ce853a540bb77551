"""Precompile and recompile-proof step shapes: the other half of the compile
spine.

Port of ``tpuframe/compile/precompile.py``.  JAX lowers and compiles a
jitted step ahead of time and dispatches to the executable; the port's
counterpart compiles the step's model region with Inductor
(``torch.compile``; the hand kernels are opaque ``tpuframe::`` custom ops in
its graphs) and, on the card, captures the whole step, update included,
as one CUDA graph that each step replays:

- :func:`batch_signature` / :func:`format_signature`: the hashable identity
  of a step's batch (key, shape, dtype per leaf).  One signature, one
  compiled program and one graph.
- :func:`loader_batch_template`: the batch a Trainer's loader will produce,
  derived before any data flows (sample shape, ``transfer_dtype``, the
  host algorithms probed on a zeros batch, the ``weight`` mask of a loader
  that keeps its ragged tail, the grad-accum ``(n_micro, micro, ...)``
  shape).  The port's batch is the rank's own: no process-count scaling.
- :func:`abstract_state`: shape, dtype, device and stride of every tensor
  of a ``TrainState``, what a graph's static inputs must match.
- :func:`precompile_call` / :func:`precompile_step`: compile and warm the
  function on static inputs of the template (spans ``compile/lower`` and
  ``compile/backend_compile``), then on the card capture it; the returned
  :class:`Executable` replays the graph, adds the capture's kernel
  launches to the wrappers' counts (``ops.dispatch``) and clones what it
  returns.  On the CPU the executable calls the compiled function.
- :class:`ShapeGuard`: any runtime signature outside the expected set
  emits one ``compile/recompile`` event.

A train step's warm-up runs on the live state and restores it bit for bit
(parameters, buffers, optimizer state, counts, ``updates``, the health
sentinel, ``step`` and the generator).  Host bookkeeping stays out of the
graph: the executable raises ``state.step`` after each replay and feeds the
graph's device copy of it.  What precompile does not cover yet raises
:class:`PrecompileSkipped` with the reason (the Trainer reports the step
``skipped`` and runs it eagerly): more than one rank, ZeRO, offload, the
compressed wire, a ``seq``, ``expert``, ``model`` or ``pipe`` axis above 1,
dropout, and an EMA's eval.  Every kernel on one card's paths is a
``tpuframe::`` op (K1-K4, the blockwise attention K6a-K6c and the MoE
dispatch and combine K9a-K9c), so the long-context LM (with ``remat`` too)
and the MoE LM on one process trace whole, the MoE routing and aux loss
inside the region; the compressed wire's K5 is not an op yet.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import types
from typing import Any, Callable, Mapping

import numpy as np
import torch

from tpuframe_torch.compile.cache import compile_label, install_listeners
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "Executable",
    "PrecompileSkipped",
    "ShapeGuard",
    "TensorSpec",
    "abstract_state",
    "batch_signature",
    "format_signature",
    "loader_batch_template",
    "precompile_call",
    "precompile_step",
]

#: the torch.compile backend of precompile; tests of the mechanics set
#: ``"aot_eager"`` here (no code generation)
_BACKEND = "inductor"

#: eager runs of a function before its capture: the first compiles and
#: builds the kernels, the next settles cuDNN's and the allocator's state
_WARMUP = 2


class PrecompileSkipped(Exception):
    """A step precompile does not cover yet; the message says why."""


def _dtype_name(dtype) -> str:
    """``uint8`` for ``torch.uint8`` and for numpy's ``uint8`` alike."""
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.")


def batch_signature(batch) -> tuple:
    """Hashable identity of a batch dict of tensors, numpy arrays or
    :class:`TensorSpec`: sorted (key, shape, dtype) triples."""
    return tuple(
        sorted(
            (k, tuple(int(s) for s in v.shape), _dtype_name(v.dtype))
            for k, v in batch.items()
        )
    )


def format_signature(sig: tuple) -> str:
    """``image:(32,28,28,1):float32`` — the grep-able form events carry."""
    return " ".join(
        f"{k}:({','.join(map(str, shape))}):{dtype}" for k, shape, dtype in sig
    )


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The port's ``jax.ShapeDtypeStruct``: a tensor's shape, dtype,
    device and strides (contiguous when None)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")
    stride: tuple | None = None

    @classmethod
    def like(cls, t: torch.Tensor) -> "TensorSpec":
        return cls(tuple(t.shape), t.dtype, t.device, tuple(t.stride()))

    def zeros(self) -> torch.Tensor:
        """A zero tensor of this spec: a static input."""
        if self.stride is None:
            return torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return torch.empty_strided(self.shape, self.stride, dtype=self.dtype,
                                   device=self.device).zero_()


def _state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor a train step reads or writes, by name: the model's
    parameters and buffers, the optimizer's state, ``updates``, the health
    sentinel, the wire's residuals, the moving average and the schedule's
    table."""
    out = {f"model/{n}": p.data for n, p in state.model.named_parameters()}
    out.update({f"model/{n}": b for n, b in state.model.named_buffers()})
    names = {p: n for n, p in state.model.named_parameters()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            for k, v in state.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v):
                    out[f"optimizer/{names.get(p, id(p))}/{k}"] = v
    out["updates"] = state.updates
    out.update({f"health/{k}": v for k, v in state.health.items()})
    out.update({f"comms/{k}": v for k, v in state.comms.items()})
    if state.ema is not None:
        out.update({f"ema/{k}": v for k, v in state.ema.ema.items()})
    if state._lr_table is not None:
        out["lr_table"] = state._lr_table
    return out


def abstract_state(state) -> dict[str, TensorSpec]:
    """Shape, dtype, device and stride of every tensor of a ``TrainState``
    (JAX's ``abstract_state``: what a graph's static inputs must match)."""
    return {k: TensorSpec.like(v) for k, v in _state_tensors(state).items()}


def loader_batch_template(trainer, train: bool) -> dict | None:
    """The batch (dict of :class:`TensorSpec` on the trainer's device) the
    Trainer's device pipeline will feed its step, derived from the loader
    spec alone; None when underivable (duck-typed loader, empty dataset)."""
    loader = trainer.train_dataloader if train else trainer.eval_dataloader
    if loader is None or not hasattr(loader, "local_batch_size"):
        return None
    try:
        img0, lab0 = loader.dataset[0][:2]
    except Exception:
        return None
    img0, lab0 = np.asarray(img0), np.asarray(lab0)
    dtype = loader.transfer_dtype or img0.dtype
    n = int(loader.local_batch_size)
    accum = trainer.grad_accum if train else 1
    # probe the host algorithms on a small zeros batch: MixUp and friends
    # change the label's rank and the image's dtype; trailing dims and
    # dtypes do not depend on the batch size
    algs = trainer.algorithms if train else []
    probe_n = min(n, 8)
    images = np.zeros((probe_n,) + img0.shape, dtype)
    # the loader's label buffer takes the first label's shape and dtype (a
    # class id is numpy's int64 here, where JAX's x64-off pipeline makes
    # it int32; a next-token label is a row); torch keeps it as it is
    labels = np.zeros((probe_n,) + lab0.shape, lab0.dtype)
    if algs:
        from tpuframe_torch.train.algorithms import apply_algorithms

        try:
            images, labels = apply_algorithms(algs, images, labels, np.random.default_rng(0))
        except Exception:
            return None  # an unprobeable algorithm: skip rather than guess

    def local_shape(arr: np.ndarray) -> tuple:
        shape = (n,) + tuple(arr.shape[1:])
        if accum > 1:
            if n % accum:
                return shape  # the step itself will raise; don't mask it
            shape = (accum, n // accum) + tuple(arr.shape[1:])
        return shape

    template = {
        "image": (local_shape(images), images.dtype),
        "label": (local_shape(labels), labels.dtype),
    }
    if not getattr(loader, "drop_last", True):
        # padded ragged tails ride a validity mask, which the Trainer's
        # host pipeline forwards as a float32 ``weight`` on every batch
        template["weight"] = (local_shape(np.zeros((probe_n,))), np.float32)
    device = getattr(trainer, "device", torch.device("cpu"))
    return {k: TensorSpec(shape, torch.from_numpy(np.zeros((), dt)).dtype, device)
            for k, (shape, dt) in template.items()}


def _clone(out):
    """What a replay returned, cloned: the next replay overwrites it."""
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, Mapping):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(v) for v in out)
    return out


class Executable:
    """A precompiled function, dispatchable on inputs of its signature.

    With a ``graph`` (on the card), a call copies its tensor arguments
    into the static inputs, replays the graph, adds ``tally`` (the
    capture's kernel launches by wrapper) to the wrappers' counts, and
    returns the static outputs cloned.  Without one (the CPU) it calls the
    compiled function.  ``warmup_launches`` are the kernel launches of the
    warm-up (by wrapper name), reported apart from the step's."""

    def __init__(self, fn: Callable, *, label: str, graph=None, static_in=None,
                 static_out=None, tally=None, warmup_launches=None):
        self.fn = fn
        self.label = label
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.tally = tally or {}
        self.warmup_launches = warmup_launches or {}
        self.replays = 0

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        if len(args) != len(self.static_in):
            raise TypeError(f"{self.label}: {len(args)} arguments for {len(self.static_in)}")
        for dst, src in zip(self.static_in, args):
            dst.copy_(src, non_blocking=True)
        return self._replay()

    def _replay(self):
        from tpuframe_torch.ops.dispatch import add_tally  # ops import the train package

        self.graph.replay()
        self.replays += 1
        add_tally(self.tally)
        return _clone(self.static_out)


class StepExecutable(Executable):
    """A precompiled train or eval step, ``(state, batch) -> ...`` over the
    one state it was captured on; see :func:`precompile_step`.
    ``template`` is the batch template it was compiled for, and
    ``pool_bytes`` the bytes its graph's private memory pool holds after
    the capture, outputs and temporaries (None on the CPU):
    ``track.memory.record_executable_memory`` reads both."""

    def __init__(self, fn: Callable, state, *, label: str, train: bool, step_dev=None,
                 lr_table=None, template=None, pool_bytes=None, **kw):
        super().__init__(fn, label=label, **kw)
        self.state = state
        self.train = train
        self.step_dev = step_dev
        self.lr_table = lr_table
        self.template = template
        self.pool_bytes = pool_bytes

    def __call__(self, state, batch, **kw):
        if kw:
            raise ValueError(f"{self.label}: precompiled without {sorted(kw)}")
        if self.graph is None:
            return self.fn(state, batch)
        if state is not self.state:
            raise ValueError(f"{self.label}: captured on another state")
        if self.train and (state._lr_table is not self.lr_table or (
                self.lr_table is not None and state.step >= len(self.lr_table))):
            raise ValueError(f"{self.label}: the schedule's table moved or ends before step "
                             f"{state.step}")
        if set(batch) != set(self.static_in):
            raise ValueError(f"{self.label}: batch keys {sorted(batch)} != "
                             f"{sorted(self.static_in)}")
        for k, t in batch.items():
            self.static_in[k].copy_(t, non_blocking=True)
        if self.step_dev is not None:
            self.step_dev.fill_(state.step)
        out = self._replay()
        if not self.train:
            return out
        state.step += 1
        return state, out


def precompile_call(fn: Callable, abstract_args: tuple, *, label: str,
                    dynamic_batch: bool = False) -> Executable:
    """Compile ``fn`` with ``torch.compile`` (Inductor), warm it on zero
    inputs of ``abstract_args`` (:class:`TensorSpec`), and on the card
    capture it as a CUDA graph: the generic form shared by the train step
    and the serve engine's buckets.

    Spans ``compile/lower`` (building the compiled function and its static
    inputs) and ``compile/backend_compile`` (the first call, where Dynamo
    traces and Inductor compiles, and the warm-up), the latter under
    :func:`compile_label`.  ``dynamic_batch`` marks dim 0 of every input
    dynamic (one compile for every batch size: the serve engine's
    buckets).  Returns the :class:`Executable`; on the CPU it calls the
    compiled function directly.  ``fn`` may also
    be a compiled function already (``Executable.fn`` of another bucket):
    then nothing compiles."""
    install_listeners()
    tele = get_telemetry()
    with tele.span("compile/lower", label=label):
        compiled = fn if _is_compiled(fn) else torch.compile(
            _fresh(fn), backend=_BACKEND, dynamic=None if dynamic_batch else False)
        static_in = [spec.zeros() for spec in abstract_args]
        if dynamic_batch:
            for t in static_in:
                if t.shape[0] > 1:  # Dynamo specializes a dim of 1 apart
                    torch._dynamo.mark_dynamic(t, 0)
    on_cuda = any(t.is_cuda for t in static_in)
    with tele.span("compile/backend_compile", label=label), compile_label(label, span=True):
        warm = _warmup(lambda: compiled(*static_in), on_cuda)
    if not on_cuda:
        return Executable(compiled, label=label, warmup_launches=warm)
    graph, tally, out = _capture(lambda: compiled(*static_in))
    return Executable(compiled, label=label, graph=graph, static_in=static_in, static_out=out,
                      tally=tally, warmup_launches=warm)


def _fresh(fn: Callable) -> Callable:
    """``fn`` over a code object of its own.  TorchDynamo keeps its
    compiled code on the code object: a new Trainer or engine then
    compiles anew (its own guards, its own recompile budget) and reads the
    persistent cache, as a new ``jax.jit`` does, instead of reusing an
    earlier compile in memory."""
    if not isinstance(fn, types.FunctionType):
        target = fn

        def fn(*args, **kw):
            return target(*args, **kw)
    fresh = types.FunctionType(fn.__code__.replace(), fn.__globals__, fn.__name__,
                               fn.__defaults__, fn.__closure__)
    fresh.__kwdefaults__ = fn.__kwdefaults__
    return functools.update_wrapper(fresh, fn)


def _is_compiled(fn) -> bool:
    return hasattr(fn, "_torchdynamo_orig_callable") or type(fn).__name__ == "OptimizedModule"


def launch_counters() -> dict[str, Any]:
    """Every kernel wrapper whose launches a warm-up reports, by name."""
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )
    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from tpuframe_torch.ops.moe_gating import moe_combine, moe_combine_backward, moe_dispatch
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode

    return {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd, "layer_norm_fwd": layer_norm_fwd,
            "layer_norm_bwd": layer_norm_bwd, "fused_adamw": fused_adamw_multi_update_,
            "bucket_abs_max": bucket_abs_max, "quant_encode": quant_encode,
            "quant_decode": quant_decode, "blockwise_attention_fwd": blockwise_attention_fwd,
            "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
            "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv,
            "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
            "moe_combine_backward": moe_combine_backward}


def _warmup(run: Callable, on_cuda: bool) -> dict[str, int]:
    """Run ``run`` eagerly (once on the CPU, :data:`_WARMUP` times on a
    side stream on the card, as a capture wants); the kernel launches it
    made, by wrapper name."""
    counters = launch_counters()
    before = {k: w.launches for k, w in counters.items()}
    if on_cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                run()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
    else:
        run()
    return {k: w.launches - before[k] for k, w in counters.items() if w.launches != before[k]}


def _capture(run: Callable):
    """Capture ``run()`` as a CUDA graph: (graph, launch tally, outputs).
    ``thread_local`` capture, so another thread's allocations (the loader's
    pinned buffers) do not break it."""
    from tpuframe_torch.ops.dispatch import capture_tally

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"), capture_tally() as tally:
        out = run()
    torch.cuda.synchronize()
    return graph, tally, out


def _pool_bytes(graph) -> int:
    """The bytes of ``graph``'s private memory pool: every block its capture
    allocated, outputs and freed temporaries alike, which a replay reuses.
    Read from the allocator's segments, so neither the process's peak
    counters nor another thread's allocations enter it."""
    pool = tuple(graph.pool())
    return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _unsupported(fn: Callable, state, train: bool = True) -> str | None:
    """Why precompile cannot take this step over this state yet, or None
    (an eval step runs in eval mode: its dropout draws nothing)."""
    if not hasattr(fn, "with_region"):
        return "not a step of train.step (no model region)"
    plan = state.plan
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return "more than one rank (NCCL capture and the DP stages are not ported)"
    if state.zero is not None or (plan is not None and getattr(plan, "zero_stage", 0) >= 1
                                  and plan.axis_size(plan.fsdp_axis) > 1):
        return "ZeRO"
    if plan is not None and getattr(plan, "offload_optimizer", False):
        return "optimizer offload"
    if state.comms:
        return "the compressed wire"
    if plan is not None:
        split = [a for a in ("seq", "expert", "model", "pipe") if plan.axis_size(a) > 1]
        if split:
            return f"the {'/'.join(split)} axis above 1"
    model = state.model
    if train and hasattr(model, "dropout_generator") and getattr(model, "dropout", 0.0) > 0.0:
        return "dropout (its generator is not registered for graph capture)"
    return None


class _Restore:
    """Clones of every tensor of a state, its host ``step`` and its
    generator, copied back in place (addresses kept, bits exact)."""

    def __init__(self, state):
        self.state = state
        self.live = _state_tensors(state)
        self.saved = {k: v.clone() for k, v in self.live.items()}
        self.step = state.step
        self.rng = state.generator.get_state()

    @torch.no_grad()
    def __call__(self) -> None:
        for k, v in self.live.items():
            v.copy_(self.saved[k])
        self.state.step = self.step
        self.state.generator.set_state(self.rng)


def precompile_step(fn: Callable, state, template: Mapping[str, TensorSpec], *, label: str,
                    train: bool = True, planned_steps: int | None = None) -> StepExecutable:
    """Precompile the train (or eval, ``train=False``) step ``fn`` for
    ``state`` and the batch ``template``: its model region compiled by
    Inductor, warmed on a zeros batch of the template on the live state,
    the state restored bit for bit; on the card the whole step captured as
    one CUDA graph (the update and the health sentinel included, the lr
    read from the schedule's table, reserved first for ``planned_steps``).
    Raises :class:`PrecompileSkipped` for what it does not cover yet."""
    why = _unsupported(fn, state, train)
    if why is not None:
        raise PrecompileSkipped(why)
    install_listeners()
    tele = get_telemetry()
    with tele.span("compile/lower", label=label):
        region = torch.compile(_fresh(fn.region), backend=_BACKEND, dynamic=False)
        cstep = fn.with_region(region)
        batch = {k: spec.zeros() for k, spec in template.items()}
        if train and planned_steps is not None:
            state.reserve_lr(max(int(planned_steps), state.step))
    on_cuda = any(t.is_cuda for t in batch.values())
    restore = _Restore(state) if train else None
    try:
        with tele.span("compile/backend_compile", label=label), \
                compile_label(label, span=True):
            warm = _warmup(lambda: cstep(state, batch), on_cuda)
        if not on_cuda:
            return StepExecutable(cstep, state, label=label, train=train, warmup_launches=warm,
                                  template=dict(template))
        if not train:
            graph, tally, out = _capture(lambda: cstep(state, batch))
            return StepExecutable(cstep, state, label=label, train=False, graph=graph,
                                  static_in=batch, static_out=out, tally=tally,
                                  warmup_launches=warm, template=dict(template),
                                  pool_bytes=_pool_bytes(graph))
        state.reserve_lr(state.step)
        step_dev = torch.zeros((), dtype=torch.int64, device=state.updates.device)
        host_step = state.step
        state.step = step_dev  # the step reads its device copy inside the graph
        try:
            graph, tally, (_, out) = _capture(lambda: cstep(state, batch))
        finally:
            state.step = host_step
        return StepExecutable(cstep, state, label=label, train=True, graph=graph,
                              static_in=batch, static_out=out, tally=tally,
                              warmup_launches=warm, step_dev=step_dev,
                              lr_table=state._lr_table, template=dict(template),
                              pool_bytes=_pool_bytes(graph))
    finally:
        if restore is not None:
            restore()


def precompile_enabled(value: bool | None) -> bool:
    """``value``, or ``TPUFRAME_PRECOMPILE`` where it is None; the port's
    default is off (ROADMAP Queue 3)."""
    if value is not None:
        return bool(value)
    return os.environ.get("TPUFRAME_PRECOMPILE", "").strip().lower() in ("1", "true", "yes", "on")


class ShapeGuard:
    """Expected-signature set + the loud runtime-miss event.

    Disarmed (no :meth:`expect` yet) it only records.  Armed, any signature
    outside the expected set emits ONE ``compile/recompile`` event naming
    it, then adopts it.
    """

    def __init__(self, telemetry=None):
        self._telemetry = telemetry
        self._known: set[tuple] = set()
        self.armed = False

    def _tele(self):
        return self._telemetry if self._telemetry is not None else get_telemetry()

    def expect(self, kind: str, sig: tuple) -> None:
        """Register an expected signature; arms the guard."""
        self._known.add((kind, sig))
        self.armed = True

    def check(self, kind: str, sig: tuple) -> bool:
        """True when ``sig`` was expected; False (plus one loud event if
        armed) on a miss."""
        key = (kind, sig)
        if key in self._known:
            return True
        self._known.add(key)
        if self.armed:
            tele = self._tele()
            tele.registry.counter("compile/recompiles").inc()
            tele.event(
                "compile/recompile",
                step_kind=kind,
                signature=format_signature(sig),
            )
        return False
