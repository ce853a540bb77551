"""Trainer callbacks: the event hooks Composer's engine drives
(the port's own copy of ``tpuframe/train/callbacks.py``)
(`03_composer/01_cifar_composer_resnet.ipynb:cell-16` —
algorithms/loggers are event callbacks under the hood) plus the early-stopping
behaviour the DeepSpeed TinyImageNet example hand-rolls
(`02_deepspeed/02_tiny_imagenet_deepspeed_resnet.py:219-220,289-297`).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from tpuframe_torch.train.trainer import Trainer


class Callback:
    """Override any subset; every hook receives the live Trainer."""

    def on_fit_start(self, trainer: "Trainer") -> None: ...
    def on_epoch_start(self, trainer: "Trainer", epoch: int) -> None: ...
    def on_step_start(self, trainer: "Trainer") -> None: ...
    def on_step_end(self, trainer: "Trainer") -> None: ...
    def on_batch_end(self, trainer: "Trainer", metrics: dict) -> None: ...
    def on_epoch_end(self, trainer: "Trainer", epoch: int, metrics: dict) -> None: ...
    def on_eval_end(self, trainer: "Trainer", epoch: int, metrics: dict) -> None: ...
    def on_fit_end(self, trainer: "Trainer") -> None: ...


class EarlyStopping(Callback):
    """Stop when a monitored eval metric stops improving (patience epochs).

    Mirrors the reference's hand-rolled loop: track best val loss, increment a
    counter, break at patience (`02_tiny_imagenet_deepspeed_resnet.py:289-297`).
    """

    def __init__(
        self, monitor: str = "eval_loss", patience: int = 3, mode: str = "min",
        min_delta: float = 0.0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.stale = 0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_eval_end(self, trainer: "Trainer", epoch: int, metrics: dict) -> None:
        value = metrics.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.stale = 0
        else:
            self.stale += 1
            if self.stale >= self.patience:
                trainer.request_stop(
                    f"early stop: {self.monitor} stale for {self.stale} epochs "
                    f"(best {self.best:.5g})"
                )


class ProgressLogger(Callback):
    """Stdout progress every N batches (the reference prints every 10,
    `01_torch_distributor/02_cifar_torch_distributor_resnet.py:229-230`).
    Rank-0 only."""

    def __init__(self, every_n_batches: int = 10):
        self.every = every_n_batches

    def on_batch_end(self, trainer: "Trainer", metrics: dict) -> None:
        if not trainer.is_main:
            return
        if trainer.batches_seen % self.every == 0:
            loss = metrics.get("loss_sum", 0.0) / max(metrics.get("count", 1.0), 1.0)
            print(
                f"[tpuframe] epoch {trainer.epoch} batch {trainer.batches_seen} "
                f"loss {loss:.4f}"
            )
