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
- **Loss routing** (``step.py:33-56``).  (B,) integer labels go to the
  fused cross entropy (kernels K2a and K2b on the card); soft labels of
  the logits' rank go to a plain soft cross entropy.
- **Metrics** stay on the device, summed (``loss_sum``, ``correct``,
  ``count``); whoever logs reads them and takes the mean.
- **Health.**  With a ``HealthPolicy`` the step computes the sentinel's
  verdict on the device and applies no update on a bad step: parameters,
  BatchNorm buffers and optimizer state are copied before the step and
  selected back with ``torch.where(bad, old, new)`` in place, with no host
  sync.  The copies are one more float32 set of parameters, buffers and
  optimizer state on the card (about 0.2 GB for ResNet50 with momentum),
  each written and read once per step.  Bad steps report zero metrics.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Mapping

import torch
from torch import nn
from torch.func import functional_call

from tpuframe_torch.fault.health import HealthPolicy, health_verdict
from tpuframe_torch.ops.cross_entropy import fused_cross_entropy
from tpuframe_torch.parallel.precision import Policy, full_precision
from tpuframe_torch.train.state import TrainState

__all__ = [
    "LossFn",
    "cross_entropy",
    "make_eval_step",
    "make_grad_accum_step",
    "make_predict_fn",
    "make_train_step",
    "merge_metrics",
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
    (BatchNorm running statistics), the optimizer's state tensors and the
    count of applied updates (the schedule's count)."""
    out = [state.updates] + [p.data for p in state.model.parameters()]
    out += [b for b in state.model.buffers() if b.is_floating_point()]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
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


def make_train_step(
    policy: Policy | None = None,
    loss_fn: LossFn = cross_entropy,
    batch_transform: Callable[[dict], dict] | None = None,
    health: HealthPolicy | None = None,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], tuple[TrainState, dict]]:
    """The train step: ``(state, batch) -> (state, metrics)``, updating
    ``state`` in place.

    ``batch_transform`` runs first (the Trainer's fused normalize of uint8
    images).  The loss is the mean of ``loss_fn``'s per-example losses.
    ``health`` arms the sentinel (module docstring).  The global-norm clip
    is part of the optimizer's spec (``train.optim``), as optax chains it
    into ``tx``."""
    policy = policy or full_precision()
    snap = _Snapshot()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        if health is not None:
            snap.take(state)  # before the forward: BatchNorm moves its buffers
        state.optimizer.zero_grad(set_to_none=True)
        losses, logits = _forward(state.model, batch, policy, True, loss_fn)
        loss = losses.mean()
        loss.backward()
        metrics = _train_metrics(loss, logits, batch["label"])
        if health is None:
            return state.apply_gradients(), metrics
        return _apply_with_health(state, loss.detach(), metrics, health, snap)

    return step


def make_eval_step(
    policy: Policy | None = None,
    loss_fn: LossFn = cross_entropy,
    batch_transform: Callable[[dict], dict] | None = None,
) -> Callable[[TrainState, Mapping[str, torch.Tensor]], dict]:
    """Eval step: ``(state, batch) -> summed metrics``, in eval mode.

    ``batch["weight"]`` (0/1 per example) masks the padded rows the
    DataLoader adds to the ragged last batch."""
    policy = policy or full_precision()

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
        return {
            "loss_sum": (losses * weight).sum(),
            "correct": ((logits.argmax(-1) == hard).float() * weight).sum(),
            "count": weight.sum(),
        }

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
):
    """Gradient accumulation over leading-dim microbatches.

    Batch tensors are shaped ``(n_microbatches, micro, ...)``; each
    microbatch runs forward and backward at the same parameters, BatchNorm
    statistics roll forward through them, and the summed gradients are
    divided by ``n_microbatches`` before the one update.  The super-batch
    is the unit of health: one bad microbatch skips the whole step."""
    policy = policy or full_precision()
    snap = _Snapshot()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if health is not None:
            snap.take(state)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = None
        for i in range(n_microbatches):
            mb = {k: v[i] for k, v in batch.items()}
            if batch_transform is not None:
                mb = batch_transform(mb)
            losses, logits = _forward(state.model, mb, policy, True, loss_fn)
            loss = losses.mean()
            loss.backward()
            m = _train_metrics(loss, logits, mb["label"])
            metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
        params = [p for p in state.model.parameters() if p.grad is not None]
        torch._foreach_div_([p.grad for p in params], float(n_microbatches))
        if health is None:
            return state.apply_gradients(), metrics
        mean_loss = metrics["loss_sum"] / metrics["count"].clamp_min(1.0)
        return _apply_with_health(state, mean_loss, metrics, health, snap)

    return step


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
