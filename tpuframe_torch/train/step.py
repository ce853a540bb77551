"""Train, eval and predict steps: the port of ``tpuframe/train/step.py``.

The JAX step is one jitted program: forward, loss, backward and update.
Here each step is eager PyTorch over a :class:`~tpuframe_torch.train.state.
TrainState` that it updates in place, with the JAX step's semantics:

- **Casts.**  Every float parameter is cast to the compute dtype inside the
  differentiated forward (``functional_call`` over the cast parameters), so
  under ``bf16_compute`` BatchNorm's scale and bias are rounded to bf16 as
  in JAX, and the gradients reach the float32 masters through the cast.
  The batch is cast to the compute dtype, the logits to the output dtype.
- **Mode.**  Each step sets the model's train/eval mode for the call and
  restores it after, as the JAX steps pass ``train=`` on every call; a
  model left in ``train()`` mode is evaluated and served with its running
  statistics.
- **Dropout.**  A model with a ``dropout_generator`` attribute and dropout
  in it (``TransformerLM``, ``ViT``) gets a fresh ``torch.Generator`` for
  each train forward, :func:`step_generator`'s ``"dropout"`` stream: the
  state's seed, the step and the rank, as JAX's ``state.step_rng(
  "dropout")`` folded with the data-axis index, and in the grad-accum step
  the microbatch besides, as JAX folds in the microbatch index.  Eval and
  predict run in eval mode, where dropout does nothing.
- **Loss routing** (``step.py:33-56``).  (B,) integer labels go to the
  fused cross entropy (kernels K2a and K2b on the card); soft labels of
  the logits' rank go to a plain soft cross entropy.
- **Every parameter steps.**  After the backward each parameter that
  autograd left without a gradient gets a zero one, so the optimizer
  updates it as optax updates every leaf (moment decay, weight decay, the
  count); torch's optimizers would skip it.  A frozen parameter
  (``requires_grad=False``, ``models.transfer.freeze``) gets none: it
  must not move at all, as under optax's ``set_to_zero``, and the
  data-parallel stages below carry only the trainable parameters
  (``trainable_parameters``).
- **Metrics** stay on the device, summed (``loss_sum``, ``correct``,
  ``count``); whoever logs reads them and takes the mean.
- **Health.**  With a ``HealthPolicy`` the step computes the sentinel's
  verdict on the device and applies no update on a bad step: parameters,
  BatchNorm buffers and optimizer state are copied before the step and
  selected back with ``torch.where(bad, old, new)`` in place, with no host
  sync.  The copies are one more float32 set of parameters, buffers and
  optimizer state on the card (about 0.2 GB for ResNet50 with momentum),
  each written and read once per step.  Bad steps report zero metrics.
- **Data parallelism** (a ``ParallelPlan`` whose ``dp_size`` is the
  process group's world size, above 1), the JAX GSPMD step over a data
  mesh: a stage of the same step around its backward and before its
  update.  Each rank runs forward and backward on its local batch;
  BatchNorm takes its moments over the global batch ("sync", the default)
  or per group of it ("local", ``bn_groups``) through ``models.norm.
  cross_rank_statistics``, entered around the train forward alone; the
  ``.grad``s are averaged in buckets of at most 25 MB of one dtype, cut
  from the trainable parameters in reverse registration order (DDP's
  order): each bucket's ``all_reduce`` (SUM; gloo has no AVG) is issued
  from the gradient hooks as soon as the backward has finished its
  gradients, in bucket order, and waited for, then divided by the world
  size, after the backward; the running buffers are averaged only where
  BatchNorm runs "local" (under "sync" they are equal on every rank
  already); metrics are summed across ranks and the loss is the global
  mean, so the health verdict, taken on the synced gradients, is the same
  on every rank.  Grad accumulation syncs once per super-batch, from the
  last microbatch's backward.
- **The compressed wire** (``grad_compression`` with a ``ParallelPlan``,
  after the JAX ``_make_compressed_train_step``), the same kind of stage.
  Each rank runs forward and backward on its local batch (microbatches
  first, compressed once per super-batch); the wire's bucket groups
  (``comms_groups``) are issued from the gradient hooks during the
  backward, each as soon as the gradients it covers are final and the
  group before it in fire order was issued (``parallel.compression.
  _WireRound``: K5a, the agreed scale, K5b, the sum or the fused
  transport, left in flight); after the backward the stage waits for the
  sums, decodes them (K5c) and writes the means into the ``.grad``s;
  floating BatchNorm buffers are averaged (JAX's ``pmean`` of the updated
  statistics; BatchNorm itself sees only the local batch, torch-DDP
  semantics); metrics are summed across ranks; the health verdict is taken
  on the global mean loss and the synced gradients, so it is the same on
  every rank; the error-feedback residual (``TrainState.comms``) is part of
  what a skipped step restores.  Without a process group (world 1) no
  collective runs.
- **ZeRO** (a state built with ``create_train_state(..., plan=)`` at
  stage 1-3, ``parallel.zero.ZeroShards``).  A step without a ``plan``
  takes the state's.  Under the exact mean each bucket of sliced leaves
  (the buckets keep sliced and whole leaves apart) is reduce-scattered
  inside the fsdp group as its hook completes it (``compression.
  _reduce_scatter_chunks``, the values as they are) and its owned chunk
  summed across the data group; divided by the world size it becomes the
  shard's gradient, and the full gradient is freed.  Under the compressed
  wire the sliced leaves take the wire's reduce-scatter.  Stage 3 gathers
  the resting parameters on the step's entry and frees them on its exit
  (and the eval step gathers them for its forward).  The health verdict
  and the clip take the plan-global norm.
- **Tensor and pipeline parallelism** (a state built with
  ``create_train_state(..., plan=)`` under rules that split parameters
  over ``model`` or ``pipe``, ``parallel.tensor`` and
  ``parallel.pipeline``).  The forward gathers the parameters that are
  gathered on use; over vocabulary-split logits (``model.tp_logits``) the
  loss is ``parallel.tensor.vocab_parallel_cross_entropy`` (K2a and K2b on
  the shard) and the prediction ``split_argmax``, any other ``loss_fn``
  taking the gathered logits.  The gradients are averaged over the data
  plane's group alone (``Runtime.groups["dp"]``), and the metrics summed
  over it; the ranks along ``model`` and ``pipe`` hold the same loss.  The
  clip and the health verdict take the global norm
  (``parallel.tensor.grad_sq``).  Dropout draws by data shard, so the
  ranks of one shard draw the same masks.
- **Sequence and expert parallelism** (a mesh that splits ``seq`` or
  ``expert``).  Every rank of a data shard is handed the same rows; under
  a ``seq`` split the step cuts the rank's run of positions from
  ``input`` and ``label`` (``L / n`` of them, in ``seq`` order).  The
  gradients are averaged, and the metrics summed, over the token group
  (``data`` x ``fsdp`` x ``seq``, ``Runtime.groups["tok"]``), never over
  ``expert``.  A model's auxiliary losses (MoE's load balance, left in its
  modules' ``aux_loss``) join the train objective, ``mean(losses) + aux``,
  while ``loss_sum`` reports the data loss alone, as JAX's step does.
  Dropout draws by token shard, so the ranks along ``expert``, ``model``
  and ``pipe`` draw the same masks.
- **The model region.**  Each step's batch transform, forward and losses
  are one function, ``step.region``; ``step.with_region(f)`` builds the
  same step over another one, which is how ``compile.precompile`` puts
  Inductor's compile of the region (the kernels as ``tpuframe::`` ops)
  into the step it captures.
- **The hooks** are ``register_post_accumulate_grad_hook``s on the
  trainable parameters, armed at a train step's start (in the grad-accum
  step, for the last microbatch, where the hook also divides by the
  microbatch count) and disarmed when the step ends: eval, predict and a
  backward of the caller's own fire nothing.  A parameter the backward
  leaves without a gradient gets its zero one after the backward, and the
  buckets or groups that hold it are issued then, still in order.  Nothing
  is written until every sum has returned.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
import zlib
from typing import Any, Callable, Iterator, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from tpuframe_torch.core.runtime import groups_for
from tpuframe_torch.fault.health import HealthPolicy, health_verdict
from tpuframe_torch.models.norm import cross_rank_statistics, rank_local_buffers
from tpuframe_torch.ops.cross_entropy import fused_cross_entropy
from tpuframe_torch.parallel.compression import (
    CommsConfig,
    _reduce_scatter_chunks,
    _WireRound,
    _wired,
    comms_template,
    grad_layout,
    resolve_fused,
    wire_plan,
)
from tpuframe_torch.parallel.precision import Policy, full_precision
from tpuframe_torch.parallel.sharding import flax_orders
from tpuframe_torch.parallel.tensor import (
    gather_from_group,
    gathered_params,
    split_argmax,
    vocab_parallel_cross_entropy,
)
from tpuframe_torch.parallel.tensor import grad_sq as split_grad_sq
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train.state import TrainState

__all__ = [
    "LossFn",
    "cross_entropy",
    "make_eval_step",
    "make_grad_accum_step",
    "make_predict_fn",
    "make_train_step",
    "merge_metrics",
    "step_generator",
    "summarize_metrics",
    "soft_cross_entropy",
    "trainable_parameters",
]

#: loss_fn(logits, labels) -> per-example losses
LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def soft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax ``softmax_cross_entropy``: ``-sum(labels * log_softmax(x))``."""
    return -(labels * torch.log_softmax(logits.float(), -1)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy per example.  (B,) integer labels take the
    fused kernels; soft labels of the logits' rank the plain soft loss;
    higher-rank integer labels a plain per-position loss (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    if labels.ndim == logits.ndim:
        return soft_cross_entropy(logits, labels)
    if labels.ndim == 1 and logits.ndim == 2:
        return fused_cross_entropy(logits, labels)
    x = logits.float()
    picked = torch.gather(x, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(x, -1) - picked


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool) -> Iterator[None]:
    """Train (or eval) mode for one call; every module's flag is restored."""
    flags = [(m, m.training) for m in model.modules()]
    model.train(train)
    try:
        yield
    finally:
        for m, flag in flags:
            m.training = flag


def step_generator(state: TrainState, device: torch.device, stream: str | None = None,
                   index: int | None = None) -> torch.Generator:
    """A generator on ``device`` for one use of one step: seeded from the
    state's generator seed, ``state.step`` and the process rank, then from
    the ``stream``'s name (crc32, the same in every process, as JAX's
    ``step_rng``) and a microbatch ``index``.  Without a stream it is the
    compressed wire's stochastic-rounding stream."""
    rank = dist.get_rank() if _wired() else 0
    plan = state.plan
    if stream is not None and plan is not None and plan.token_size < plan.mesh.devices.size:
        # the ranks along model, pipe and expert hold one token shard and
        # draw one mask, as JAX folds in the data-axis index
        c = plan.mesh.coords(rank)
        rank = ((c["data"] * plan.axis_size("fsdp") + c["fsdp"]) * plan.axis_size("seq")
                + c["seq"])
    seed = ((state.generator.initial_seed() * 1_000_003 + state.step) * 8191 + rank) % 2**63
    if stream is not None:
        seed = (seed * 1_000_033 + zlib.crc32(stream.encode())) % 2**63
    if index is not None:
        seed = (seed * 1_000_037 + index + 1) % 2**63
    return torch.Generator(device=device).manual_seed(seed)


def _uses_dropout(model: nn.Module) -> bool:
    """Whether ``model`` draws dropout masks in train mode."""
    return hasattr(model, "dropout_generator") and getattr(model, "dropout", 0.0) > 0.0


@contextlib.contextmanager
def _dropout_stream(state: TrainState, index: int | None = None) -> Iterator[None]:
    """The step's dropout generator in the model's ``dropout_generator``
    for one forward (nothing for a model without dropout)."""
    model = state.model
    if not _uses_dropout(model):
        yield
        return
    device = next(model.parameters()).device
    model.dropout_generator = step_generator(state, device, "dropout", index)
    try:
        yield
    finally:
        model.dropout_generator = None


def _seq_local(batch: Mapping[str, torch.Tensor], plan: Any) -> dict:
    """``batch`` with this rank's run of positions (dim 1) of ``input`` (or
    ``image``) and ``label`` under a plan that splits ``seq`` (every rank of
    a data shard was handed the same rows); as it is otherwise."""
    if plan is None or plan.axis_size("seq") <= 1:
        return batch
    n = plan.axis_size("seq")
    index = plan.mesh.coords(dist.get_rank() if _wired() else 0)["seq"]
    out = dict(batch)
    for key in ("input", "image", "label"):
        t = out.get(key)
        if t is not None and t.ndim > 1:
            if t.shape[1] % n:
                raise ValueError(f"batch[{key!r}] has {t.shape[1]} positions, which the seq "
                                 f"axis of {n} does not split evenly")
            run = t.shape[1] // n
            out[key] = t.narrow(1, index * run, run)
    return out


def _pop_aux(model: nn.Module) -> torch.Tensor | None:
    """The auxiliary losses a forward left in ``model``'s modules
    (``aux_loss``, MoE's load balance), summed and cleared; None without
    any."""
    parts = []
    for m in model.modules():
        aux = getattr(m, "aux_loss", None)
        if aux is not None:
            parts.append(aux)
            m.aux_loss = None
    return sum(parts) if parts else None


def _forward(model: nn.Module, batch: Mapping[str, torch.Tensor], policy: Policy,
             train: bool, loss_fn: LossFn,
             params: Mapping[str, torch.Tensor] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(per-example losses, logits, auxiliary loss or None).  Parameters
    (the model's, or ``params`` by name) are cast inside the graph; buffers
    are the module's own (training BatchNorm updates them)."""
    params = policy.cast_params_for_compute(
        dict(model.named_parameters()) if params is None else dict(params))
    params = gathered_params(model, params)
    x = batch["input"] if "input" in batch else batch["image"]
    with _mode(model, train):
        logits = functional_call(model, params, (policy.cast_batch(x),), strict=False)
    aux = _pop_aux(model)
    logits = policy.cast_outputs(logits)
    labels = batch["label"]
    ax = getattr(model, "tp_logits", None)
    if ax is None:
        return loss_fn(logits, labels), logits, aux
    if loss_fn is cross_entropy and labels.ndim == logits.ndim - 1:
        flat = vocab_parallel_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                            labels.reshape(-1), ax)
        return flat.reshape(labels.shape), logits, aux
    return loss_fn(gather_from_group(logits, -1, ax), labels), logits, aux


def _objective(loss: torch.Tensor, aux: torch.Tensor | None) -> torch.Tensor:
    """What a train step differentiates: the mean data loss plus the
    auxiliary losses (JAX's ``data_loss + aux``)."""
    return loss if aux is None else loss + aux.to(loss.dtype)


def _argmax(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """The predicted class: over the last dim, split or whole."""
    ax = getattr(model, "tp_logits", None)
    return logits.argmax(-1) if ax is None else split_argmax(logits, ax)


def _train_metrics(loss: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                   model: nn.Module) -> dict:
    """The summed train metrics: ``loss_sum``, ``correct``, ``count``."""
    hard = labels.argmax(-1) if labels.ndim == logits.ndim else labels
    n = float(hard.numel())
    return {
        "loss_sum": loss.detach().float() * n,
        "correct": (_argmax(model, logits.detach()) == hard).sum().float(),
        "count": torch.full((), n, dtype=torch.float32, device=logits.device),
    }


def _sentinel_tensors(state: TrainState) -> list[torch.Tensor]:
    """What a skipped step must leave untouched: parameters, float buffers
    (BatchNorm running statistics), the optimizer's state tensors, the
    count of applied updates (the schedule's count), the compressed
    wire's error-feedback residuals and the parameters' moving average."""
    if state.zero is not None:
        out = [state.updates] + state.zero.sentinel_tensors()
    else:
        out = [state.updates] + [p.data for p in state.model.parameters()]
    out += [b for b in state.model.buffers() if b.is_floating_point()]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    out += list(state.comms.values())
    if state.ema is not None:
        out += list(state.ema.ema.values())
    return out


class _Snapshot:
    """Copies of the sentinel tensors, kept between steps and refreshed
    before each one (one fused copy per dtype)."""

    def __init__(self):
        self._key: list[tuple] = []
        self._live: list[torch.Tensor] = []
        self._old: list[torch.Tensor] = []
        self._by_dtype: list[tuple[list, list]] = []

    @torch.no_grad()
    def take(self, state: TrainState) -> None:
        self._live = _sentinel_tensors(state)
        key = [(t.data_ptr(), t.shape, t.dtype) for t in self._live]
        if key != self._key:  # first step, or another state
            self._key = key
            self._old = [t.clone() for t in self._live]
            # a list of mixed dtypes (the float32 state beside int counts)
            # makes _foreach_copy_ copy tensor by tensor, one memcpy each
            groups: dict = {}
            for old, live in zip(self._old, self._live):
                olds, lives = groups.setdefault((live.device, live.dtype), ([], []))
                olds.append(old)
                lives.append(live)
            self._by_dtype = list(groups.values())
        else:
            for olds, lives in self._by_dtype:
                torch._foreach_copy_(olds, lives)

    @torch.no_grad()
    def restore_where(self, bad: torch.Tensor) -> None:
        for old, new in zip(self._old, self._live):
            torch.where(bad.to(new.device), old, new, out=new)


def _apply_with_health(state: TrainState, loss: torch.Tensor, metrics: dict,
                       health: HealthPolicy, snap: _Snapshot) -> tuple[TrainState, dict]:
    """The sentinel tail: verdict, update, then the old values back where
    the step was bad; a bad step's metrics are zeroed."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    grad_sq = state.zero.global_grad_sq() if state.zero is not None else None
    if grad_sq is None and getattr(state.model, "tp_layout", None):
        grad_sq = split_grad_sq(state.model)
    bad, new_health, hmetrics = health_verdict(loss, grads, state.health, state.step, health,
                                               grad_sq=grad_sq)
    state.apply_gradients(grad_sq)
    snap.restore_where(bad)
    # in place: a captured CUDA graph reads and writes the same tensors
    torch._foreach_copy_([state.health[k] for k in new_health], list(new_health.values()))
    metrics = {k: torch.where(bad, torch.zeros_like(v), v) for k, v in metrics.items()}
    metrics.update(hmetrics)
    return state, metrics


@torch.no_grad()
def _fill_missing_grads(model: nn.Module) -> None:
    """A zero gradient for every trainable parameter that autograd left
    without one.

    optax updates every leaf on every step, a leaf outside the loss with a
    zero gradient: its moments decay, its weight decay applies and the
    shared count advances.  torch's optimizers skip a parameter whose
    ``.grad`` is None, so a parameter that sat out a step would keep its
    moments and its own count would lag.  A frozen parameter is left
    without one, so the optimizer skips it (no decay, no count)."""
    for p in model.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)


def trainable_parameters(model: nn.Module) -> dict[str, nn.Parameter]:
    """The parameters that step, by name: every one but the frozen
    (``requires_grad=False``).  What the data-parallel stages average and
    what the compressed wire's layout and residual cover; a frozen
    parameter has no gradient to send."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _statistics(sync: "_Stage | None", model: nn.Module):
    """The scope of a train forward: BatchNorm over the ranks under the
    uncompressed data-parallel stage, else as it is."""
    return sync.statistics(model) if sync is not None else contextlib.nullcontext()


@contextlib.contextmanager
def _zero_step(state: TrainState) -> Iterator[None]:
    """A train step's frame under ZeRO: no gradient left from before,
    stage 3's parameters gathered for the step and freed after it."""
    zero = state.zero
    if zero is None:
        yield
        return
    state.model.zero_grad(set_to_none=True)
    zero.gather_params()
    try:
        yield
    finally:
        zero.release_params()


def _stage_for(built: list, state: TrainState, plan: Any, grad_compression,
               n_microbatches: int) -> "_Stage | None":
    """The step's data-parallel stage: built with the step from its
    ``plan``, else at the first call from the state's (``built`` holds
    it)."""
    if built[0] is None and plan is None and state.plan is not None:
        built[0] = _wire_stage(state.plan, grad_compression, n_microbatches)
    return built[0]


def _finish(step: Callable, state: TrainState, loss: torch.Tensor, metrics: dict,
            health: HealthPolicy | None, snap: _Snapshot,
            sync: "_Stage | None") -> tuple[TrainState, dict]:
    """Every train step's tail after the backward: a zero gradient where
    autograd left none, the data-parallel stage's end when there is one
    (the compressed wire's plan then on ``step.wire``), then the update,
    under the sentinel when armed."""
    _fill_missing_grads(state.model)
    if sync is not None:
        loss, metrics = sync(state, loss, metrics)
        step.wire = sync.wire
    if health is None:
        return state.apply_gradients(), metrics
    return _apply_with_health(state, loss, metrics, health, snap)


def make_train_step(
    policy: Policy | None = None,
    loss_fn: LossFn = cross_entropy,
    batch_transform: Callable[[dict], dict] | None = None,
    health: HealthPolicy | None = None,
    plan: Any = None,
    grad_compression: str | CommsConfig | None = None,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], tuple[TrainState, dict]]:
    """The train step: ``(state, batch) -> (state, metrics)``, updating
    ``state`` in place.

    ``batch_transform`` runs first (the Trainer's fused normalize of uint8
    images).  The loss is the mean of ``loss_fn``'s per-example losses.
    ``health`` arms the sentinel (module docstring).  The global-norm clip
    is part of the optimizer's spec (``train.optim``), as optax chains it
    into ``tx``.  A ``plan`` over more than one rank builds the
    data-parallel step, with ``grad_compression`` (``"int8"``, ``"fp8"`` or
    a ``CommsConfig``) the compressed one (module docstring)."""
    policy = policy or full_precision()
    built = [_wire_stage(plan, grad_compression, 1)]
    snap = _Snapshot()

    def forward(model: nn.Module, batch: Mapping[str, torch.Tensor]):
        """The model region: the batch transform, forward and losses."""
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        return _forward(model, batch, policy, True, loss_fn)

    def build(region: Callable) -> Callable:
        def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
            sync = _stage_for(built, state, plan, grad_compression, 1)
            batch = _seq_local(batch, plan if plan is not None else state.plan)
            if health is not None:
                snap.take(state)  # before the forward: BatchNorm moves its buffers
            state.optimizer.zero_grad(set_to_none=True)
            with _zero_step(state), _disarmed_after(sync):
                if sync is not None:
                    sync.arm(state)
                with _statistics(sync, state.model), _dropout_stream(state):
                    losses, logits, aux = region(state.model, batch)
                loss = losses.mean()
                _objective(loss, aux).backward()
                metrics = _train_metrics(loss, logits, batch["label"], state.model)
                return _finish(step, state, loss.detach(), metrics, health, snap, sync)

        return _regioned(step, forward, build)

    return build(forward)


def _regioned(step: Callable, region: Callable, build: Callable) -> Callable:
    """``step`` with its model region (``step.region``: ``(model, batch) ->
    (losses, logits, aux)``, what ``torch.compile`` takes) and
    ``step.with_region(compiled)``, the same step over another region
    (``compile.precompile``); the wire's plan (``step.wire``) from the
    first call on."""
    step.region = region
    step.with_region = build
    step.wire = None
    return step


def make_eval_step(
    policy: Policy | None = None,
    loss_fn: LossFn = cross_entropy,
    batch_transform: Callable[[dict], dict] | None = None,
    plan: Any = None,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], dict]:
    """Eval step: ``(state, batch) -> summed metrics``, in eval mode.

    ``batch["weight"]`` (0/1 per example) masks the padded rows the
    DataLoader adds to the ragged last batch.  With a ``plan`` and a process
    group the metrics are summed across the ranks.  ``params`` (by name)
    stand in for the model's, as the JAX Trainer evaluates the EMA by
    swapping ``state.params``."""
    policy = policy or full_precision()

    def forward(model: nn.Module, batch: Mapping[str, torch.Tensor],
                params: Mapping[str, torch.Tensor] | None = None):
        """The model region: the batch transform, forward and losses."""
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        return _forward(model, batch, policy, False, loss_fn, params)

    def build(region: Callable) -> Callable:
        @torch.no_grad()
        def step(state: TrainState, batch: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor] | None = None) -> dict:
            the_plan = plan if plan is not None else state.plan
            batch = _seq_local(batch, the_plan)
            with state.zero.gathered() if state.zero is not None else contextlib.nullcontext():
                losses, logits, _ = region(state.model, batch, params)
            labels = batch["label"]
            hard = labels.argmax(-1) if labels.ndim == logits.ndim else labels
            weight = batch.get("weight")
            weight = torch.ones_like(losses) if weight is None else weight.to(torch.float32)
            if weight.ndim < losses.ndim:  # per-example mask over per-token losses
                weight = weight.reshape(weight.shape + (1,) * (losses.ndim - weight.ndim))
            metrics = {
                "loss_sum": (losses * weight).sum(),
                "correct": ((_argmax(state.model, logits) == hard).float() * weight).sum(),
                "count": weight.sum(),
            }
            if the_plan is None or not _wired() or the_plan.token_size == 1:
                return metrics
            return _sum_across_ranks(metrics, _dp_group(the_plan))

        return _regioned(step, forward, build)

    return build(forward)


def make_predict_fn(
    policy: Policy | None = None,
    input_transform: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """Logits function for inference: ``predict(model, x)``.

    ``input_transform`` (the fused normalize on the serve path) runs
    first; the model runs in eval mode whatever mode it was left in, with
    its parameters cast to the compute dtype on every call (as the JAX step
    casts them) and its buffers (BatchNorm running statistics) as they
    are; the batch is cast to the compute dtype and the logits to the
    output dtype.  ``params`` (by name, e.g. ``train.ema.ema_params``)
    stand in for the model's.  Runs under ``torch.inference_mode``."""
    policy = policy or full_precision()

    @torch.inference_mode()
    def predict(model: nn.Module, x: torch.Tensor,
                params: Mapping[str, torch.Tensor] | None = None) -> torch.Tensor:
        if input_transform is not None:
            x = input_transform(x)
        if params is None:
            params = dict(model.named_parameters())
        params = policy.cast_params_for_compute(dict(params))  # no autograd here
        with _mode(model, False):
            logits = functional_call(model, params, (policy.cast_batch(x),), strict=False)
        return policy.cast_outputs(logits)

    return predict


def make_grad_accum_step(
    n_microbatches: int,
    policy: Policy | None = None,
    loss_fn: LossFn = cross_entropy,
    batch_transform: Callable[[dict], dict] | None = None,
    health: HealthPolicy | None = None,
    plan: Any = None,
    grad_compression: str | CommsConfig | None = None,
):
    """Gradient accumulation over leading-dim microbatches.

    Batch tensors are shaped ``(n_microbatches, micro, ...)``; each
    microbatch runs forward and backward at the same parameters, BatchNorm
    statistics roll forward through them, and the summed gradients are
    divided by ``n_microbatches`` before the one update.  The super-batch
    is the unit of health: one bad microbatch skips the whole step.  With a
    ``plan`` over several ranks the super-batch gradient is synced once per
    step (through the compressed wire with ``grad_compression``); each
    microbatch's BatchNorm statistics are taken over the ranks."""
    policy = policy or full_precision()
    built = [_wire_stage(plan, grad_compression, n_microbatches)]
    snap = _Snapshot()

    def forward(model: nn.Module, batch: Mapping[str, torch.Tensor]):
        """The model region of one microbatch: transform, forward, losses."""
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        return _forward(model, batch, policy, True, loss_fn)

    def build(region: Callable) -> Callable:
        def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
            sync = _stage_for(built, state, plan, grad_compression, n_microbatches)
            if health is not None:
                snap.take(state)
            state.optimizer.zero_grad(set_to_none=True)
            with _zero_step(state), _disarmed_after(sync):
                metrics = _accumulate(state, batch, n_microbatches, region, sync,
                                      plan if plan is not None else state.plan)
                mean_loss = metrics["loss_sum"] / metrics["count"].clamp_min(1.0)
                return _finish(step, state, mean_loss, metrics, health, snap, sync)

        return _regioned(step, forward, build)

    return build(forward)


def _accumulate(state: TrainState, batch: Mapping[str, torch.Tensor], n_microbatches: int,
                region: Callable, sync: "_Stage | None", plan: Any = None) -> dict:
    """Forward and backward over the microbatches through the model
    ``region``: the summed metrics, and the mean gradient in ``.grad``."""
    metrics = None
    for i in range(n_microbatches):
        mb = _seq_local({k: v[i] for k, v in batch.items()}, plan)
        if sync is not None and i == n_microbatches - 1:
            sync.arm(state, n_microbatches)  # the last backward fires the buckets
        with _statistics(sync, state.model), _dropout_stream(state, i):
            losses, logits, aux = region(state.model, mb)
        loss = losses.mean()
        _objective(loss, aux).backward()
        m = _train_metrics(loss, logits, mb["label"], state.model)
        metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
    # what the hooks did not divide (a gradient of an earlier microbatch only)
    rest = [p.grad for p in state.model.parameters()
            if p.grad is not None and (sync is None or not sync.took(p))]
    if rest:
        torch._foreach_div_(rest, float(n_microbatches))
    return metrics


# -- the data-parallel stages ----------------------------------------------------


def _dp_group(plan: Any):
    """The process group of the token group (``data`` x ``fsdp`` x
    ``seq``) this rank averages its gradients over: the default group where
    it spans the world (nothing split over ``model``, ``pipe`` or
    ``expert``)."""
    if plan.token_size == int(plan.mesh.devices.size):
        return None
    return groups_for(plan.mesh).get("tok")


@torch.no_grad()
def _sum_across_ranks(metrics: dict, group=None) -> dict:
    """The metrics summed over ``group`` (default: the process group) in
    one collective."""
    keys = sorted(metrics)
    packed = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    return dict(zip(keys, packed.unbind()))


@torch.no_grad()
def _mean_in_place(tensors: list[torch.Tensor], world: int, group=None) -> None:
    """Tensors of one dtype averaged across the ranks in place, in one
    collective (SUM, then ``/ world``: gloo has no AVG)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= world
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def _average_buffers(model: nn.Module, world: int, group=None) -> None:
    """Floating buffers (BatchNorm running statistics) averaged across
    the ranks in place, one collective a dtype."""
    by_dtype: dict = {}
    for b in model.buffers():
        if b.is_floating_point():
            by_dtype.setdefault(b.dtype, []).append(b)
    for bufs in by_dtype.values():
        _mean_in_place(bufs, world, group)


def _global(state: TrainState, loss: torch.Tensor, metrics: dict, world: int,
            average_buffers: bool, group=None) -> tuple[torch.Tensor, dict]:
    """Both stages' tail: the running buffers averaged (where they differ
    by rank), the metrics summed and the loss made the global mean, in one
    collective, over ``group`` (default: the process group)."""
    if average_buffers:
        _average_buffers(state.model, world, group)
    summed = _sum_across_ranks({**metrics, "_loss": loss}, group)
    return summed.pop("_loss") / world, summed


def _wire_stage(plan: Any, grad_compression, n_microbatches: int) -> "_Stage | None":
    """The stage a train step runs around its backward and before its
    update: the compressed wire's sync, the exact mean over a plan of
    several ranks, or None (one rank, or no plan)."""
    if grad_compression is not None:
        beside = () if plan is None else plan.split_axes + tuple(
            a for a in ("seq", "expert") if plan.axis_size(a) > 1)
        if beside:
            raise NotImplementedError(
                f"grad_compression with the {'/'.join(beside)} axis above 1 is not ported; "
                "the compressed wire beside tensor, pipeline, sequence and expert parallelism "
                "comes with the rest of ROADMAP.md, Queue 1 item 7")
        return _WireSync(plan, grad_compression, n_microbatches)
    if plan is not None and plan.token_size > 1:
        return _MeanSync(plan)
    return None


@contextlib.contextmanager
def _disarmed_after(sync: "_Stage | None") -> Iterator[None]:
    """The stage's hooks disarmed when the step ends, whether it returns or
    raises."""
    try:
        yield
    finally:
        if sync is not None:
            sync.disarm()


def _fire(ref: weakref.ref, name: str, param: nn.Parameter) -> None:
    """A parameter's post-accumulate-grad hook: hands its gradient to the
    stage (held weakly, so a dropped step leaves no stage behind)."""
    stage = ref()
    if stage is not None and stage._armed:
        stage._on_grad(name, param)


class _FiredStage:
    """What both data-parallel stages share: hooks on the trainable
    parameters that hand each final gradient to the stage while it is
    armed (module docstring), rebuilt when the stage meets another model.

    ``arm(state, n)`` opens a round before the backward that fires it
    (``n``: the microbatches the hook divides by); ``__call__`` (from
    ``_finish``, after the backward) takes every gradient the hooks did not
    deliver, completes the round and writes the means; ``disarm()`` ends
    it.  Called without ``arm``, the stage takes every gradient after the
    backward, the non-overlapped order."""

    _armed = False

    def __init__(self):
        self._model = None
        self._handles: list = []
        self._live = False

    def _hook(self, model: nn.Module) -> None:
        """Hooks on ``model``'s trainable parameters, in place of the last
        model's."""
        for h in self._handles:
            h.remove()
        self._params = trainable_parameters(model)
        ref = weakref.ref(self)
        self._handles = [p.register_post_accumulate_grad_hook(functools.partial(_fire, ref, name))
                         for name, p in self._params.items()]
        weakref.finalize(self, _remove_all, self._handles)
        self._model = model

    def _start(self, state: TrainState) -> None:
        if self._model is not state.model:
            self._build(state)
        self._taken: set[int] = set()
        self._divide = 1
        self._begin(state)
        self._live = True

    def arm(self, state: TrainState, n_microbatches: int = 1) -> None:
        self._start(state)
        self._divide = n_microbatches
        self._armed = True

    def disarm(self) -> None:
        self._armed = self._live = False

    def took(self, p: torch.Tensor) -> bool:
        """Whether this round's hooks took (and divided) ``p``'s gradient."""
        return self._live and id(p) in self._taken

    @torch.no_grad()
    def _on_grad(self, name: str, p: nn.Parameter) -> None:
        if self._divide > 1:
            torch._foreach_div_([p.grad], float(self._divide))  # as _accumulate divides
        self._take(name, p)

    def _take(self, name: str, p: nn.Parameter) -> None:
        self._taken.add(id(p))
        self._deliver(name, p)

    def _take_the_rest(self, state: TrainState) -> None:
        """Every gradient the hooks did not deliver (the round opened here
        if it was not armed): the zero ones ``_finish`` gave, or all."""
        if not self._live:
            self._start(state)
        for name, p in self._params.items():
            if id(p) not in self._taken:
                self._take(name, p)


def _remove_all(handles: list) -> None:
    for h in handles:
        h.remove()


class _MeanSync(_FiredStage):
    """Uncompressed data parallelism around the backward (module
    docstring): ``(state, loss, metrics) -> (global loss, summed metrics)``
    with the mean gradient over the token group in the ``.grad``s.  Checks
    at build that the plan's mesh spans the process group; cuts the model's
    trainable parameters into buckets when it first meets the model."""

    #: what the Trainer meters on the wire: nothing (exact all-reduce)
    wire = None
    bucket_bytes = 25 * 2**20

    def __init__(self, plan: Any):
        super().__init__()
        self.world = plan.check_world()
        self.group = _dp_group(plan)

    def statistics(self, model: nn.Module):
        return cross_rank_statistics(model, self.group)

    def _build(self, state: TrainState) -> None:
        """Buckets of at most ``bucket_bytes`` of gradient of one dtype each
        (a larger tensor alone), filled in reverse registration order, the
        ZeRO-sliced leaves in buckets of their own, and whether the running
        buffers can differ by rank."""
        model = state.model
        self._hook(model)
        zero = state.zero
        if zero is not None and zero.compressed and zero.opt:
            raise ValueError("this state's owned slices are the compressed wire's; build it "
                             "with create_train_state(..., plan=plan) for the exact mean")
        self._zero = zero if zero is not None and zero.opt else None
        sliced = self._zero.opt if self._zero is not None else {}
        self._buckets: list[list[str]] = []
        self._sliced: list[bool] = []
        open_bucket: dict = {}  # (dtype, sliced) -> [bucket index, bytes]
        for name, p in reversed(self._params.items()):
            nbytes = p.numel() * p.element_size()
            key = (p.dtype, name in sliced)
            cur = open_bucket.get(key)
            if cur is None or cur[1] + nbytes > self.bucket_bytes:
                self._buckets.append([])
                self._sliced.append(key[1])
                cur = open_bucket[key] = [len(self._buckets) - 1, 0]
            self._buckets[cur[0]].append(name)
            cur[1] += nbytes
        self._bucket_of = {n: i for i, b in enumerate(self._buckets) for n in b}
        # under sync BN the running buffers are equal on every rank already
        # (and an average of equal values can move the last bit)
        self._local = rank_local_buffers(model)

    def _begin(self, state: TrainState) -> None:
        self._waiting = [len(b) for b in self._buckets]
        self._sums: list[tuple] = []  # (bucket's gradients flat, its all-reduce)

    def _deliver(self, name: str, p: nn.Parameter) -> None:
        self._waiting[self._bucket_of[name]] -= 1
        while len(self._sums) < len(self._buckets) and not self._waiting[len(self._sums)]:
            k = len(self._sums)
            if self._sliced[k]:
                self._sums.append((self._scatter(self._buckets[k]), None))
                continue
            grads = [self._params[n].grad for n in self._buckets[k]]
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._sums.append((flat, dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                                     group=self.group, async_op=True)))

    def _scatter(self, names: list[str]) -> torch.Tensor:
        """A bucket of sliced leaves: each gradient as its (F, chunk) rows,
        side by side, reduce-scattered inside the fsdp group (the values as
        they are), then the owned chunks summed across the data group."""
        zero = self._zero
        own = torch.cat([zero.opt[n].chunks(self._params[n].grad) for n in names], dim=1)
        mine = _reduce_scatter_chunks(own, group=zero.opt[names[0]].group, exact=True)
        if zero.replica_world > 1:
            dist.all_reduce(mine, op=dist.ReduceOp.SUM, group=zero.replica_group)
        return mine

    @torch.no_grad()
    def __call__(self, state: TrainState, loss: torch.Tensor,
                 metrics: dict) -> tuple[torch.Tensor, dict]:
        self._take_the_rest(state)  # each filled by _finish
        for (flat, work), names, sliced in zip(self._sums, self._buckets, self._sliced):
            if work is not None:
                work.wait()
            flat /= self.world
            if sliced:  # the owned chunks become the shards' gradients
                shards = [self._zero.shards[n] for n in names]
                for f, t, n in zip(flat.split([t.numel() for t in shards]), shards, names):
                    t.grad = f.view(t.shape)
                    self._params[n].grad = None
                continue
            grads = [self._params[n].grad for n in names]
            torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)])
        self._live, self._sums = False, []  # no bucket copy outlives the step
        return _global(state, loss, metrics, self.world, self._local, self.group)


class _WireSync(_FiredStage):
    """The compressed wire around the backward (module docstring):
    ``(state, loss, metrics) -> (global loss, summed metrics)`` with the
    synced mean in the ``.grad``s.

    The wire layout depends on the model's parameters, so it is built when
    the stage first meets the model: the layout, the check of
    ``state.comms`` against it, the ``wire`` plan (what the Trainer meters)
    and one ``comms/wire_plan`` event, or ``comms/ef_inactive`` when the
    state carries no residual."""

    def __init__(self, plan: Any, grad_compression, n_microbatches: int):
        super().__init__()
        config = CommsConfig.from_env(grad_compression)
        if config is None:
            raise ValueError(f"grad_compression={grad_compression!r} names no wire format")
        if plan is None:
            raise ValueError("grad_compression needs a plan (its mesh and data axes)")
        if plan.offload_optimizer:
            raise ValueError(
                "grad_compression does not compose with offload_optimizer: the wire's owned "
                "slices keep the optimizer state on the device, as the JAX package's "
                "compressed step does")
        self.config = resolve_fused(plan, config)
        self.plan, self.n_microbatches = plan, n_microbatches
        #: the static per-step wire accounting (``wire_plan``), set at build
        self.wire: dict | None = None

    def statistics(self, model: nn.Module):
        """BatchNorm stays shard-local, as inside JAX's ``shard_map``."""
        return contextlib.nullcontext()

    def _build(self, state: TrainState) -> None:
        self._hook(state.model)
        params = self._params
        layout = grad_layout(params, self.config, self.plan, orders=flax_orders(state.model))
        zero = state.zero
        owned = {n: sl.dim for n, sl in zero.opt.items()} if zero is not None else {}
        if {path: dim for path, _, _, dim in layout.sliced} != owned or (
                owned and not zero.compressed):
            raise ValueError(
                "the wire slices these leaves but the state does not own the same slices: "
                "build it with create_train_state(..., plan=plan, grad_compression=...)")
        self._zero = zero
        expected = {k: (1,) + tuple(v[1:])
                    for k, v in comms_template(params, self.config, self.plan).items()}
        have = {k: tuple(v.shape) for k, v in state.comms.items()}
        ef = bool(expected) and bool(have)
        if ef and have != expected:
            raise ValueError(
                f"TrainState.comms does not match this plan and config's residual layout (have "
                f"{have}, expected {expected} on each rank); re-initialize it with "
                "parallel.compression.init_comms_state(train.step.trainable_parameters(model), "
                "plan, config)")
        self._run_config = (self.config if ef or not self.config.error_feedback
                            else dataclasses.replace(self.config, error_feedback=False))
        self._ef = ef
        self.wire = wire_plan(layout, self._run_config)
        tele = get_telemetry()
        if self.config.error_feedback and not ef:
            tele.event("comms/ef_inactive",
                       reason="TrainState.comms is empty — init_comms_state() was never "
                              "applied; running compressed without error feedback")
        tele.event("comms/wire_plan", zero_stage=self.plan.zero_stage, error_feedback=ef,
                   n_microbatches=self.n_microbatches,
                   stochastic=self._run_config.stochastic_rounding, **self.wire)
        self._layout = layout

    def _rng(self, state: TrainState, device: torch.device) -> torch.Generator | None:
        """The step's stochastic-rounding stream, distinct per step and
        rank."""
        if not self._run_config.stochastic_rounding:
            return None
        return step_generator(state, device)

    def _begin(self, state: TrainState) -> None:
        device = state.updates.device
        self._round = _WireRound(self._layout, self._run_config,
                                 state.comms if self._ef else {}, device,
                                 self._rng(state, device))

    def _deliver(self, name: str, p: nn.Parameter) -> None:
        self._round.deliver(name, p.grad)

    def __call__(self, state: TrainState, loss: torch.Tensor,
                 metrics: dict) -> tuple[torch.Tensor, dict]:
        self._take_the_rest(state)  # each filled by _finish
        synced, new_comms = self._round.finish()
        self._live, self._round = False, None  # nor the bucket array
        with torch.no_grad():
            sliced = self._zero.opt if self._zero is not None else {}
            names = [n for n in self._params if n not in sliced]
            torch._foreach_copy_([self._params[n].grad for n in names],
                                 [synced[n] for n in names])
            for n in sliced:  # the owned chunk of the mean steps the shard
                self._zero.shards[n].grad = synced[n]
                self._params[n].grad = None
            for k, t in new_comms.items():
                state.comms[k].copy_(t)  # in place: a skipped step restores it
        if not _wired():
            return loss, metrics
        return _global(state, loss, metrics, dist.get_world_size(), True)


_Stage = _MeanSync | _WireSync


def merge_metrics(acc: dict | None, new: Mapping[str, Any]) -> dict:
    """Host-side accumulation of summed metrics across steps (reads the
    device values)."""
    new = {k: float(v) for k, v in new.items()}
    if acc is None:
        return new
    return {k: acc.get(k, 0.0) + v for k, v in new.items()}


def summarize_metrics(acc: Mapping[str, float], prefix: str = "") -> dict:
    """Summed metrics -> {loss, accuracy} means."""
    count = max(acc.get("count", 0.0), 1.0)
    return {
        f"{prefix}loss": acc.get("loss_sum", 0.0) / count,
        f"{prefix}accuracy": acc.get("correct", 0.0) / count,
    }
