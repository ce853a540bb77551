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
  count); torch's optimizers would skip it.
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
  mesh: a stage of the same step between its backward and its update.
  Each rank runs forward and backward on its local batch; BatchNorm takes
  its moments over the global batch ("sync", the default) or per group
  of it ("local", ``bn_groups``) through ``models.norm.
  cross_rank_statistics``, entered around the train forward alone; the
  ``.grad``s are averaged, one ``all_reduce`` (SUM, then ``/ world``: gloo
  has no AVG) a bucket of at most 25 MB of one dtype; the running
  buffers are averaged only where BatchNorm runs "local" (under "sync"
  they are equal on every rank already); metrics are summed across ranks
  and the loss is the global mean, so the health verdict, taken on the
  synced gradients, is the same on every rank.  Grad accumulation syncs
  once per super-batch.
- **The compressed wire** (``grad_compression`` with a ``ParallelPlan``,
  after the JAX ``_make_compressed_train_step``), the same kind of stage.
  Each rank runs forward and backward on its local batch (microbatches
  first, compressed once per super-batch);
  ``parallel.compression.sync_gradients`` averages the
  ``.grad``s across the ranks through the int8 or fp8 wire (K5a-K5c on the
  card) and writes the mean back into them; floating BatchNorm buffers are
  averaged (JAX's ``pmean`` of the updated statistics; BatchNorm itself
  sees only the local batch, torch-DDP semantics); metrics are summed
  across ranks; the health verdict is taken on the global mean loss and
  the synced gradients, so it is the same on every rank; the error-feedback
  residual (``TrainState.comms``) is part of what a skipped step restores.
  Without a process group (world 1) no collective runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Callable, Iterator, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from tpuframe_torch.fault.health import HealthPolicy, health_verdict
from tpuframe_torch.models.norm import cross_rank_statistics, rank_local_buffers
from tpuframe_torch.ops.cross_entropy import fused_cross_entropy
from tpuframe_torch.parallel.compression import (
    CommsConfig,
    _wired,
    check_transport,
    comms_template,
    grad_layout,
    resolve_fused,
    sync_gradients,
    wire_plan,
)
from tpuframe_torch.parallel.precision import Policy, full_precision
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


def _forward(model: nn.Module, batch: Mapping[str, torch.Tensor], policy: Policy,
             train: bool, loss_fn: LossFn) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-example losses, logits).  Parameters are cast inside the graph;
    buffers are the module's own (training BatchNorm updates them)."""
    params = policy.cast_params_for_compute(dict(model.named_parameters()))
    x = batch["input"] if "input" in batch else batch["image"]
    with _mode(model, train):
        logits = functional_call(model, params, (policy.cast_batch(x),), strict=False)
    logits = policy.cast_outputs(logits)
    return loss_fn(logits, batch["label"]), logits


def _train_metrics(loss: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """The summed train metrics: ``loss_sum``, ``correct``, ``count``."""
    hard = labels.argmax(-1) if labels.ndim == logits.ndim else labels
    n = float(hard.numel())
    return {
        "loss_sum": loss.detach().float() * n,
        "correct": (logits.detach().argmax(-1) == hard).sum().float(),
        "count": torch.full((), n, dtype=torch.float32, device=logits.device),
    }


def _sentinel_tensors(state: TrainState) -> list[torch.Tensor]:
    """What a skipped step must leave untouched: parameters, float buffers
    (BatchNorm running statistics), the optimizer's state tensors, the
    count of applied updates (the schedule's count) and the compressed
    wire's error-feedback residuals."""
    out = [state.updates] + [p.data for p in state.model.parameters()]
    out += [b for b in state.model.buffers() if b.is_floating_point()]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    out += list(state.comms.values())
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
    bad, new_health, hmetrics = health_verdict(loss, grads, state.health, state.step, health)
    state.apply_gradients()
    snap.restore_where(bad)
    state.health = new_health
    metrics = {k: torch.where(bad, torch.zeros_like(v), v) for k, v in metrics.items()}
    metrics.update(hmetrics)
    return state, metrics


@torch.no_grad()
def _fill_missing_grads(model: nn.Module) -> None:
    """A zero gradient for every parameter that autograd left without one.

    optax updates every leaf on every step, a leaf outside the loss with a
    zero gradient: its moments decay, its weight decay applies and the
    shared count advances.  torch's optimizers skip a parameter whose
    ``.grad`` is None, so a parameter that sat out a step would keep its
    moments and its own count would lag."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _statistics(sync: "_Stage | None", model: nn.Module):
    """The scope of a train forward: BatchNorm over the ranks under the
    uncompressed data-parallel stage, else as it is."""
    return sync.statistics(model) if sync is not None else contextlib.nullcontext()


def _finish(step: Callable, state: TrainState, loss: torch.Tensor, metrics: dict,
            health: HealthPolicy | None, snap: _Snapshot,
            sync: "_Stage | None") -> tuple[TrainState, dict]:
    """Every train step's tail after the backward: a zero gradient where
    autograd left none, the data-parallel stage when there is one (the
    compressed wire's plan then on ``step.wire``), then the update, under
    the sentinel when armed."""
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
    sync = _wire_stage(plan, grad_compression, 1)
    snap = _Snapshot()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        if health is not None:
            snap.take(state)  # before the forward: BatchNorm moves its buffers
        state.optimizer.zero_grad(set_to_none=True)
        with _statistics(sync, state.model), _dropout_stream(state):
            losses, logits = _forward(state.model, batch, policy, True, loss_fn)
        loss = losses.mean()
        loss.backward()
        metrics = _train_metrics(loss, logits, batch["label"])
        return _finish(step, state, loss.detach(), metrics, health, snap, sync)

    step.wire = None  # the compressed wire's plan, from the first call on
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
    group the metrics are summed across the ranks."""
    policy = policy or full_precision()
    summed = plan is not None

    @torch.no_grad()
    def step(state: TrainState, batch: Mapping[str, torch.Tensor]) -> dict:
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        losses, logits = _forward(state.model, batch, policy, False, loss_fn)
        labels = batch["label"]
        hard = labels.argmax(-1) if labels.ndim == logits.ndim else labels
        weight = batch.get("weight")
        weight = torch.ones_like(losses) if weight is None else weight.to(torch.float32)
        if weight.ndim < losses.ndim:  # per-example mask over per-token losses
            weight = weight.reshape(weight.shape + (1,) * (losses.ndim - weight.ndim))
        metrics = {
            "loss_sum": (losses * weight).sum(),
            "correct": ((logits.argmax(-1) == hard).float() * weight).sum(),
            "count": weight.sum(),
        }
        return _sum_across_ranks(metrics) if summed and _wired() else metrics

    return step


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
    output dtype.  Runs under ``torch.inference_mode``."""
    policy = policy or full_precision()

    @torch.inference_mode()
    def predict(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if input_transform is not None:
            x = input_transform(x)
        params = policy.cast_params_for_compute(
            {n: p.detach() for n, p in model.named_parameters()})
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
    sync = _wire_stage(plan, grad_compression, n_microbatches)
    snap = _Snapshot()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if health is not None:
            snap.take(state)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = _accumulate(state, batch, n_microbatches, policy, loss_fn, batch_transform,
                              sync)
        mean_loss = metrics["loss_sum"] / metrics["count"].clamp_min(1.0)
        return _finish(step, state, mean_loss, metrics, health, snap, sync)

    step.wire = None  # the compressed wire's plan, from the first call on
    return step


def _accumulate(state: TrainState, batch: Mapping[str, torch.Tensor], n_microbatches: int,
                policy: Policy, loss_fn: LossFn, batch_transform, sync: "_Stage | None") -> dict:
    """Forward and backward over the microbatches: the summed metrics, and
    the mean gradient in ``.grad``."""
    metrics = None
    for i in range(n_microbatches):
        mb = {k: v[i] for k, v in batch.items()}
        if batch_transform is not None:
            mb = batch_transform(mb)
        with _statistics(sync, state.model), _dropout_stream(state, i):
            losses, logits = _forward(state.model, mb, policy, True, loss_fn)
        loss = losses.mean()
        loss.backward()
        m = _train_metrics(loss, logits, mb["label"])
        metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
    params = [p for p in state.model.parameters() if p.grad is not None]
    torch._foreach_div_([p.grad for p in params], float(n_microbatches))
    return metrics


# -- the data-parallel stages ----------------------------------------------------


@torch.no_grad()
def _sum_across_ranks(metrics: dict) -> dict:
    """The metrics summed over the process group in one collective."""
    keys = sorted(metrics)
    packed = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(packed, op=dist.ReduceOp.SUM)
    return dict(zip(keys, packed.unbind()))


@torch.no_grad()
def _mean_in_place(tensors: list[torch.Tensor], world: int) -> None:
    """Tensors of one dtype averaged across the ranks in place, in one
    collective (SUM, then ``/ world``: gloo has no AVG)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def _average_buffers(model: nn.Module, world: int) -> None:
    """Floating buffers (BatchNorm running statistics) averaged across
    the ranks in place, one collective a dtype."""
    by_dtype: dict = {}
    for b in model.buffers():
        if b.is_floating_point():
            by_dtype.setdefault(b.dtype, []).append(b)
    for bufs in by_dtype.values():
        _mean_in_place(bufs, world)


def _global(state: TrainState, loss: torch.Tensor, metrics: dict, world: int,
            average_buffers: bool) -> tuple[torch.Tensor, dict]:
    """Both stages' tail: the running buffers averaged (where they differ
    by rank), the metrics summed and the loss made the global mean, in one
    collective."""
    if average_buffers:
        _average_buffers(state.model, world)
    summed = _sum_across_ranks({**metrics, "_loss": loss})
    return summed.pop("_loss") / world, summed


def _wire_stage(plan: Any, grad_compression, n_microbatches: int) -> "_Stage | None":
    """The stage a train step runs between its backward and its update:
    the compressed wire's sync, the exact mean over a plan of several
    ranks, or None (one rank, or no plan)."""
    if grad_compression is not None:
        return _WireSync(plan, grad_compression, n_microbatches)
    if plan is not None and plan.dp_size > 1:
        return _MeanSync(plan)
    return None


class _MeanSync:
    """Uncompressed data parallelism between the backward and the update
    (module docstring): ``(state, loss, metrics) -> (global loss, summed
    metrics)`` with the mean gradient in the ``.grad``s.  Checks at build
    that the plan's ``dp_size`` is the process group's world size; cuts
    the model's parameters into buckets at its first call (and again for
    another model)."""

    #: what the Trainer meters on the wire: nothing (exact all-reduce)
    wire = None
    bucket_bytes = 25 * 2**20

    def __init__(self, plan: Any):
        self.world = plan.check_world()
        self._model = None

    def statistics(self, model: nn.Module):
        return cross_rank_statistics(model)

    def _build(self, model: nn.Module) -> None:
        """The parameters by dtype, in order, cut into runs of at most
        ``bucket_bytes`` of gradient each (a larger tensor alone), and
        whether the running buffers can differ by rank."""
        self._buckets, size = [], 0
        for p in sorted(model.parameters(), key=lambda p: str(p.dtype)):
            nbytes = p.numel() * p.element_size()
            if (not self._buckets or self._buckets[-1][0].dtype != p.dtype
                    or size + nbytes > self.bucket_bytes):
                self._buckets.append([])
                size = 0
            self._buckets[-1].append(p)
            size += nbytes
        # under sync BN the running buffers are equal on every rank already
        # (and an average of equal values can move the last bit)
        self._local = rank_local_buffers(model)
        self._model = model

    @torch.no_grad()
    def __call__(self, state: TrainState, loss: torch.Tensor,
                 metrics: dict) -> tuple[torch.Tensor, dict]:
        if self._model is not state.model:
            self._build(state.model)
        for bucket in self._buckets:
            _mean_in_place([p.grad for p in bucket], self.world)  # every one filled by _finish
        return _global(state, loss, metrics, self.world, self._local)


class _WireSync:
    """The compressed wire between the backward and the update (module
    docstring): ``(state, loss, metrics) -> (global loss, summed metrics)``
    with the synced mean in the ``.grad``s.

    The wire layout depends on the model's parameters, so it is built at
    the first call: the layout, the check of ``state.comms`` against it,
    the ``wire`` plan (what the Trainer meters) and one ``comms/wire_plan``
    event, or ``comms/ef_inactive`` when the state carries no residual."""

    def __init__(self, plan: Any, grad_compression, n_microbatches: int):
        config = CommsConfig.from_env(grad_compression)
        if config is None:
            raise ValueError(f"grad_compression={grad_compression!r} names no wire format")
        if plan is None:
            raise ValueError("grad_compression needs a plan (its mesh and data axes)")
        self.config = resolve_fused(plan, config)
        check_transport(grad_layout({}, self.config, plan), self.config)
        self.plan, self.n_microbatches = plan, n_microbatches
        #: the static per-step wire accounting (``wire_plan``), set at build
        self.wire: dict | None = None
        self._layout = None

    def statistics(self, model: nn.Module):
        """BatchNorm stays shard-local, as inside JAX's ``shard_map``."""
        return contextlib.nullcontext()

    def _build(self, state: TrainState) -> None:
        params = dict(state.model.named_parameters())
        layout = grad_layout(params, self.config, self.plan)
        expected = {k: (1,) + tuple(v[1:])
                    for k, v in comms_template(params, self.config, self.plan).items()}
        have = {k: tuple(v.shape) for k, v in state.comms.items()}
        ef = bool(expected) and bool(have)
        if ef and have != expected:
            raise ValueError(
                f"TrainState.comms does not match this plan and config's residual layout (have "
                f"{have}, expected {expected} on each rank); re-initialize it with "
                "parallel.compression.init_comms_state(params, plan, config)")
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

    def __call__(self, state: TrainState, loss: torch.Tensor,
                 metrics: dict) -> tuple[torch.Tensor, dict]:
        if self._layout is None:
            self._build(state)
        named = list(state.model.named_parameters())
        grads = {n: p.grad for n, p in named}  # every one filled by _finish
        synced, new_comms = sync_gradients(grads, state.comms if self._ef else {}, self._layout,
                                           self._run_config, self._rng(state, loss.device))
        with torch.no_grad():
            torch._foreach_copy_([p.grad for _, p in named], [synced[n] for n, _ in named])
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
