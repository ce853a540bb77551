"""High-level Trainer: the port of ``tpuframe/train/trainer.py``.

Same constructor shape and public names as the JAX Trainer (Composer's
``Trainer(model, optimizers, loaders, max_duration, algorithms,
loggers).fit()``), over the port's eager steps.  It keeps the JAX Trainer's
telemetry names — spans ``train/epoch``, ``train/step``, ``train/eval``,
``train/data_wait`` and ``train/host_block``, the loader's
``span/data/assemble`` and the prefetcher's ``span/data/h2d`` — and its
epoch summary keys, so one analyzer reads logs from both sides.  Metrics
are summed on the device and read by the host once per ``log_interval``
steps; the health sentinel's verdict once per window.

Data parallelism: ``plan`` (default ``ParallelPlan(mesh=
current_runtime().mesh)``, whose ``dp_size`` is the process group's world
size) trains each process on its share of the batch.  Without
``grad_compression`` the step is JAX's GSPMD step over a data mesh: the
gradients are averaged exactly and BatchNorm takes its moments over the
global batch, or per replica group under ``bn_stats="local"``, whose
``bn_groups`` the Trainer fills from ``plan.dp_size``.  With
``grad_compression`` (``"int8"`` / ``"fp8"``; None reads
``TPUFRAME_COMMS_COMPRESSION``) the gradients cross as int8 or e4m3
buckets with error feedback (``parallel.compression``); the residuals
start at zero in ``TrainState.comms``.  Every rank runs the loop; only the
main process logs and reports.

Checkpoints go through ``ckpt.Checkpointer``: an epoch-end save every
``checkpoint_interval`` epochs, mid-epoch snapshots every
``checkpoint_interval_batches`` batches into the sibling ``<dir>_intra``
(with the loader's position), and auto-resume at ``fit()`` from the newer
of the two, as the JAX Trainer does.

What this reduced Trainer does not do yet, each raising
``NotImplementedError`` that names the slice which ports it: plans
beyond stage-0 DP (ZeRO, rules, offload, the fused transport), EMA (``ema_decay``), preemption
handling (``preemption=True``), straggler detection
(``straggler_sync_steps``, ``straggler_factor``).  ``tx`` takes
an ``OptimizerSpec`` in place of an optax transform (``ops.fused_adamw``
returns one).  ``precompile`` is accepted and does nothing: eager PyTorch
has no ahead-of-time compile step (``torch.compile`` comes with the
compile slice).  The model arrives initialized, on its device (torch
idiom); ``models.from_jax_variables`` carries JAX weights in.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from tpuframe_torch.core.runtime import current_runtime
from tpuframe_torch.data.loader import DataLoader, DevicePrefetcher
from tpuframe_torch.fault import health as _health
from tpuframe_torch.fault.health import Divergence
from tpuframe_torch.ops.normalize import normalize_images
from tpuframe_torch.parallel.compression import CommsConfig, init_comms_state
from tpuframe_torch.parallel.precision import Policy, align_model_dtype, get_policy
from tpuframe_torch.parallel.sharding import ParallelPlan
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train.algorithms import Algorithm, apply_algorithms, resolve_algorithms
from tpuframe_torch.train.callbacks import Callback
from tpuframe_torch.train.duration import Duration
from tpuframe_torch.train.optim import OptimizerSpec, make_optimizer
from tpuframe_torch.train.schedules import Schedule, resolve_schedule
from tpuframe_torch.train.state import TrainState, create_train_state
from tpuframe_torch.train.step import (
    cross_entropy,
    make_eval_step,
    make_grad_accum_step,
    make_predict_fn,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)

__all__ = ["FitResult", "Trainer"]


class FitResult:
    """Ray-style structured result: metrics, history, checkpoint, error."""

    def __init__(self):
        self.metrics: dict[str, float] = {}
        self.history: list[dict[str, float]] = []
        self.checkpoint: str | None = None
        self.error: BaseException | None = None
        self.stopped_reason: str | None = None

    def __repr__(self):
        return (f"FitResult(metrics={self.metrics}, checkpoint={self.checkpoint!r}, "
                f"error={self.error!r}, stopped={self.stopped_reason!r})")


def _later(arg: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"Trainer({arg}=...) is not ported yet; it comes with {where} (ROADMAP.md, Queue 1)")


class Trainer:
    """Train a port model on one card with algorithms, callbacks and loggers.

    Args:
      model: an initialized ``nn.Module`` taking the batch's inputs: NHWC
        images (``ResNet``) or int tokens (``TransformerLM``), both fed
        under the ``"image"`` key as the JAX Trainer feeds them.
      tx: an ``OptimizerSpec`` (e.g. ``ops.fused_adamw(3e-4)``) used as it
        is, in place of ``optimizer`` and ``lr``; not with ``grad_clip``.
      optimizer / lr: the named optimizer (``"sgd"`` is SGD with momentum
        0.9, as the JAX Trainer's) and its learning rate: a float, a
        schedule ``step -> lr`` or a DeepSpeed-shaped scheduler dict.
      train_dataloader / eval_dataloader: port DataLoaders.
      max_duration: ``"2ep"`` / ``"500ba"`` / ``"1000sp"`` / int epochs.
      algorithms / callbacks / loggers: as the JAX Trainer's.
      plan: a stage-0 ``ParallelPlan`` (default: over the runtime's mesh,
        which :func:`~tpuframe_torch.core.runtime.current_runtime` builds
        on the model's device when none is initialized); its ``dp_size``
        must be the process group's world size (``ValueError``).
      grad_compression: ``"int8"`` / ``"fp8"`` / a ``CommsConfig``: the
        compressed gradient wire (None reads ``TPUFRAME_COMMS_COMPRESSION``).
      precision: policy name or Policy; when given, the model's compute
        dtype is aligned to it, else the policy follows the model.
      loss_fn: per-example loss (default: ``train.step.cross_entropy``).
      seed: seeds the state's generator and the algorithms' draws.
      checkpointer: a ``ckpt.Checkpointer``: an epoch-end save every
        ``checkpoint_interval`` epochs (the path lands in
        ``FitResult.checkpoint``), and auto-resume at ``fit()``.
      checkpoint_interval_batches: also snapshot every N batches inside an
        epoch, with the loader's position, into ``<dir>_intra``
        (``max_to_keep=1``); None reads ``TPUFRAME_CKPT_INTERVAL_BATCHES``.
        Needs a loader with ``state_dict()``.
      num_classes: for label-space algorithms (default: the dataset's).
      eval_interval / log_interval: epochs between evals (0 = never), steps
        between host reads of the metrics.
      report: ``report(epoch_summary, checkpoint)`` after every epoch.
      grad_accum: microbatches per step (None reads ``TPUFRAME_GRAD_ACCUM``).
      grad_clip: global-norm clip, optax's formula.
      normalize: ``(mean, std[, scale])``; uint8 (or 0-255 float) images
        cross to the card raw and kernel K1 normalizes them into the
        compute dtype inside the train, eval and predict steps.
      health: the training-health sentinel: None follows
        ``TPUFRAME_HEALTH`` (on unless falsy), False disables, a
        ``HealthPolicy`` sets thresholds.  A bad step applies no update;
        ``max_bad`` bad steps in a window raise ``Divergence``.
      precompile: accepted, no effect (see the module docstring).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        tx: Any = None,
        train_dataloader: DataLoader | None = None,
        eval_dataloader: DataLoader | None = None,
        *,
        optimizer: str = "adam",
        lr: float | Mapping[str, Any] | Schedule = 1e-3,
        max_duration: str | int = "1ep",
        algorithms: Sequence[Algorithm] = (),
        callbacks: Sequence[Callback] = (),
        loggers: Sequence[Any] = (),
        plan: Any = None,
        precision: str | Policy | None = None,
        loss_fn: Callable = cross_entropy,
        seed: int = 0,
        num_classes: int | None = None,
        checkpointer: Any = None,
        checkpoint_interval: int = 1,
        checkpoint_interval_batches: int | None = None,
        eval_interval: int = 1,
        log_interval: int = 10,
        report: Callable[[dict, str | None], None] | None = None,
        grad_accum: int | None = None,
        grad_clip: float | None = None,
        grad_compression: str | None = None,
        normalize: tuple | None = None,
        ema_decay: float | None = None,
        preemption: Any = None,
        straggler_sync_steps: int | None = None,
        straggler_factor: float | None = None,
        precompile: bool | None = None,
        health: Any = None,
    ):
        for arg, value, where in (
            ("ema_decay", ema_decay, "the EMA part of the training slice"),
            ("straggler_sync_steps", straggler_sync_steps, "the platform planes (track)"),
            ("straggler_factor", straggler_factor, "the platform planes (track)"),
        ):
            if value is not None:
                raise _later(arg, where)
        if preemption not in (None, False):
            raise _later("preemption", "the platform planes (fault)")
        if precision is None:
            self.policy = Policy(compute_dtype=getattr(model, "compute_dtype", torch.float32))
            self.model = model
        else:
            self.policy = get_policy(precision)
            self.model = align_model_dtype(model, self.policy)
        self.device = next(self.model.parameters()).device
        if plan is None:
            plan = ParallelPlan(mesh=current_runtime(device=self.device).mesh)
        self.plan = plan
        # per-replica BN ("local") needs the data shard count, which the
        # model cannot see: fill it from the plan, as the JAX Trainer does
        if (getattr(self.model, "bn_stats", None) == "local"
                and not getattr(self.model, "bn_groups", 1)
                and hasattr(self.model, "set_bn_groups")):
            self.model.set_bn_groups(plan.dp_size)
        self.comms_config = CommsConfig.from_env(grad_compression)
        self._comms_gauge_set = False
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader
        self.max_duration = Duration.parse(max_duration)
        self.callbacks = list(callbacks)
        self.loggers = list(loggers)
        self.loss_fn = loss_fn
        self.seed = seed
        self.checkpointer = checkpointer
        self.checkpoint_interval = checkpoint_interval
        if checkpoint_interval_batches is None:
            env_ckpt = _health._env_int("TPUFRAME_CKPT_INTERVAL_BATCHES", 0)
            checkpoint_interval_batches = env_ckpt if env_ckpt > 0 else None
        self.checkpoint_interval_batches = checkpoint_interval_batches
        self.eval_interval = eval_interval
        self.log_interval = log_interval
        self.report = report
        self.precompile_enabled = bool(precompile)
        self.health = _health.resolve_policy(health)
        self._health_flags: list = []
        if tx is None:
            self.spec = make_optimizer(optimizer, self._resolve_lr(lr),
                                       float(grad_clip) if grad_clip else None)
        elif grad_clip:
            raise ValueError(
                "grad_clip only applies when the Trainer builds the optimizer "
                "(tx=None); give your OptimizerSpec max_grad_norm instead")
        elif not isinstance(tx, OptimizerSpec):
            raise TypeError(
                f"tx takes an OptimizerSpec (e.g. ops.fused_adamw(...)), got {type(tx).__name__}")
        else:
            self.spec = tx
        if num_classes is None:
            num_classes = getattr(getattr(train_dataloader, "dataset", None), "num_classes", None)
        self.num_classes = num_classes
        self.algorithms = resolve_algorithms(algorithms, num_classes) if algorithms else []

        self.state: TrainState | None = None
        self.epoch = 0
        self.batches_seen = 0
        self.samples_seen = 0
        self._stop_reason: str | None = None
        self._train_prefetcher: DevicePrefetcher | None = None
        # a restored snapshot's loader position, applied at the next epoch
        # start (after its set_epoch rewind)
        self._pending_loader_state: dict | None = None
        self._intra_ck: Any = None  # the sibling checkpointer of the snapshots

        if grad_accum is None:
            grad_accum = max(1, _health._env_int("TPUFRAME_GRAD_ACCUM", 1))
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.grad_accum = grad_accum
        # the one place the normalize tuple is interpreted: train, eval and
        # predict read the same transform
        self.normalize = normalize
        image_transform = train_transform = eval_transform = None
        if normalize is not None:
            mean, std, *rest = normalize
            self._norm_args = (mean, std, rest[0] if rest else 1.0 / 255.0)
            image_transform = functools.partial(
                normalize_images, mean=mean, std=std, scale=self._norm_args[2],
                out_dtype=self.policy.compute_dtype)

            def train_transform(batch: dict) -> dict:
                batch["image"] = image_transform(batch["image"])
                return batch

            eval_transform = train_transform
        else:
            self._norm_args = None

        wire = dict(plan=plan, grad_compression=self.comms_config)
        if grad_accum > 1:
            self._train_step = make_grad_accum_step(
                grad_accum, self.policy, loss_fn, batch_transform=train_transform,
                health=self.health, **wire)
        else:
            self._train_step = make_train_step(
                self.policy, loss_fn, batch_transform=train_transform, health=self.health, **wire)
        self._eval_step = make_eval_step(self.policy, loss_fn, batch_transform=eval_transform,
                                         plan=plan)
        self._predict = make_predict_fn(self.policy, input_transform=image_transform)

    # -- wiring ------------------------------------------------------------
    def _resolve_lr(self, lr):
        """A float, a schedule, or a DeepSpeed-shaped scheduler dict;
        ``total_num_steps: "auto"`` resolves against ``max_duration``."""
        return resolve_schedule(
            lr, total_steps=_planned_total_steps(self.max_duration, self.train_dataloader))

    @property
    def is_main(self) -> bool:
        return current_runtime(device=self.device).is_main

    def request_stop(self, reason: str) -> None:
        """Callbacks call this to end fit() after the current epoch."""
        self._stop_reason = reason

    def _emit(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _intra_checkpointer(self):
        """The sibling checkpointer of the mid-epoch snapshots,
        ``<dir>_intra`` with ``max_to_keep=1``: apart from the epoch-end
        steps, so frequent snapshots neither evict them nor collide with
        their step numbers.  Made when snapshots are on, or when an earlier
        run left one (auto-resume must see it even with the feature off)."""
        if self._intra_ck is None and self.checkpointer is not None:
            from tpuframe_torch.ckpt import Checkpointer
            from tpuframe_torch.ckpt.meta import latest_step

            intra_dir = str(self.checkpointer.directory) + "_intra"
            if self.checkpoint_interval_batches or latest_step(intra_dir) is not None:
                self._intra_ck = Checkpointer(intra_dir, max_to_keep=1)
        return self._intra_ck

    def _health_stamp(self) -> dict | None:
        """The health record stamped into every save's meta JSON: loss
        EWMA, grad norm, bad-step count, and the ``healthy`` verdict
        rollback selects on (one host read)."""
        if self.health is None or self.state is None or not self.state.health:
            return None
        keys = list(self.state.health)
        vals = torch.stack([self.state.health[k].float() for k in keys]).cpu().tolist()
        return _health.health_stamp(dict(zip(keys, vals)), self.state.step, self.health)

    def _resume(self) -> None:
        """Auto-resume from the newer of the last epoch-end checkpoint and
        a mid-epoch snapshot: the state in place, the counters, and the
        loader position for the next epoch start."""
        source = self.checkpointer
        intra = self._intra_checkpointer()
        if intra is not None:
            main_step, intra_step = self.checkpointer.latest_step(), intra.latest_step()
            if intra_step is not None and (main_step is None or intra_step > main_step):
                source = intra
        self.state, meta = source.maybe_restore(self.state, plan=self.plan)
        if not meta:
            return
        self.epoch = int(meta.get("epoch", 0))
        self.batches_seen = int(meta.get("batches_seen", 0))
        self.samples_seen = int(meta.get("samples_seen", 0))
        self._pending_loader_state = meta.get("loader_state")
        # the loader position counts global batches: it means nothing under
        # another global batch, and a retry would replay or skip samples
        saved_gb = meta.get("global_batch")
        cur_gb = getattr(self.train_dataloader, "global_batch_size", None)
        if saved_gb and cur_gb and int(saved_gb) != int(cur_gb):
            raise ValueError(
                f"restored checkpoint was trained at global batch {saved_gb} but this "
                f"loader produces {cur_gb}: a world resize must keep the global batch "
                "to keep the checkpointed loader position meaningful")

    def _save_meta(self, epoch: int) -> dict:
        return {"epoch": epoch, "batches_seen": self.batches_seen,
                "samples_seen": self.samples_seen,
                "global_batch": self.train_dataloader.global_batch_size}

    def _maybe_snapshot(self) -> None:
        """A mid-epoch snapshot every ``checkpoint_interval_batches``
        batches, with the consumer-true loader position, so a crash resumes
        with the next batch.  The epoch's last batch is skipped: the
        epoch-end save follows it."""
        every = self.checkpoint_interval_batches
        if self.checkpointer is None or not every or self.batches_seen % every:
            return
        try:
            epoch_len = len(self.train_dataloader) or 1
        except TypeError:
            epoch_len = 1 << 62
        snap = self._train_prefetcher.state_dict()
        if snap["batches_yielded"] < epoch_len:
            self._intra_checkpointer().save(
                self.state, meta={**self._save_meta(self.epoch), "loader_state": snap},
                plan=self.plan, health=self._health_stamp())

    def _save_epoch(self, epoch_summary: dict) -> str:
        """The epoch-end save; it drops a snapshot at an earlier or equal
        step, which it supersedes."""
        path = self.checkpointer.save(self.state, metrics=epoch_summary,
                                      meta=self._save_meta(self.epoch + 1), plan=self.plan,
                                      health=self._health_stamp())
        intra = self._intra_checkpointer()
        if intra is not None:
            saved, stale = self.checkpointer.latest_step(), intra.latest_step()
            if saved is not None and stale is not None and stale <= saved:
                intra.delete(stale)
        return str(path)

    def _health_step(self, metrics: Mapping[str, Any]) -> None:
        """Buffer the step's on-device health vector; check per window."""
        if self.health is None:
            return
        stats = metrics.get("health_stats")
        if stats is None:
            return
        self._health_flags.append(stats)
        if len(self._health_flags) >= self.health.window:
            self._health_check()

    def _health_check(self) -> None:
        """Read the window's verdict (one host sync): gauges,
        ``health/bad_step`` events, and :class:`Divergence` at ``max_bad``."""
        import math

        if self.health is None or not self._health_flags:
            return
        stats = torch.stack(self._health_flags).cpu().numpy()
        n_bad = int(round(float(stats[:, 0].sum())))
        window_steps = len(stats)
        self._health_flags = []
        tele = get_telemetry()
        hs = {k: float(v) for k, v in self.state.health.items()}
        for key, name in (("loss_ewma", "health/loss_ewma"), ("grad_norm", "health/grad_norm")):
            if math.isfinite(hs.get(key, float("nan"))):
                tele.registry.gauge(name).set(hs[key])
        if not n_bad:
            return
        tele.registry.counter("health/bad_steps").inc(n_bad)
        tele.event(
            "health/bad_step",
            batch=self.batches_seen,
            bad_in_window=n_bad,
            window_steps=window_steps,
            bad_steps_total=int(hs.get("bad_steps", 0.0)),
            loss_ewma=hs["loss_ewma"] if math.isfinite(hs["loss_ewma"]) else None,
            grad_norm=hs["grad_norm"] if math.isfinite(hs["grad_norm"]) else None,
        )
        if n_bad >= self.health.max_bad:
            tele.registry.counter("health/divergences").inc()
            tele.event("health/divergence", batch=self.batches_seen, bad_in_window=n_bad,
                       window_steps=window_steps, max_bad=self.health.max_bad)
            raise Divergence(
                f"{n_bad} bad step(s) inside a {window_steps}-step health "
                f"window (max_bad={self.health.max_bad}) at batch "
                f"{self.batches_seen}: skip-step is no longer converging",
                step=self.batches_seen, bad_in_window=n_bad, window=window_steps,
                loss_ewma=hs.get("loss_ewma"), policy=self.health)

    def _meter_comms(self, tele) -> None:
        """Per-step bytes on the wire: the compressed step's wire plan is
        static, so the meter is one host add a step.  Uncompressed runs and
        a world of 1 meter nothing."""
        wire = getattr(self._train_step, "wire", None)
        if not wire or not wire.get("bytes_per_step"):
            return
        if not self._comms_gauge_set:
            tele.registry.gauge("comms/bytes_per_step").set(wire["bytes_per_step"])
            tele.registry.gauge("comms/overlap_groups").set(wire.get("overlap_groups") or 1)
            self._comms_gauge_set = True
        tele.registry.counter("comms/bytes_on_wire").inc(wire["bytes_per_step"])

    def _log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        if not self.is_main:
            return
        for lg in self.loggers:
            lg.log_metrics(dict(metrics), step=step)

    def _log_params(self, params: Mapping[str, Any]) -> None:
        if not self.is_main:
            return
        for lg in self.loggers:
            if hasattr(lg, "log_params"):
                lg.log_params(dict(params))

    # -- state -------------------------------------------------------------
    def init_state(self) -> TrainState:
        if self.state is None:
            self.state = create_train_state(self.model, self.spec, seed=self.seed)
            if self.comms_config is not None:
                # zero error-feedback residuals for the compressed wire
                self.state.comms = init_comms_state(
                    dict(self.model.named_parameters()), self.plan, self.comms_config)
        return self.state

    # -- data --------------------------------------------------------------
    def _device_batches(self, loader: DataLoader, train: bool):
        """Host pipeline: algorithms -> dict batches -> prefetched device
        tensors."""
        algs = self.algorithms if train else []
        accum = self.grad_accum if train else 1
        run_key = (self.seed * 1_000_003 + self.epoch) * 2 + int(train)
        fallback_pos = iter(range(1, 1 << 62))

        def batch_rng() -> np.random.Generator:
            """Augmentation rng keyed by (run, batch position), as in JAX."""
            pos = getattr(loader, "_batches_yielded", None)
            if pos is None:
                pos = next(fallback_pos)
            return np.random.default_rng(run_key * 1_000_003 + pos)

        def split_micro(x: np.ndarray) -> np.ndarray:
            if x.shape[0] % accum:
                raise ValueError(
                    f"batch size {x.shape[0]} not divisible by grad_accum={accum}")
            return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])

        def host_iter():
            for batch in loader:
                images, labels = np.asarray(batch[0]), np.asarray(batch[1])
                if algs:
                    images, labels = apply_algorithms(algs, images, labels, batch_rng())
                out = {"image": images, "label": labels}
                if len(batch) > 2:
                    out["weight"] = np.asarray(batch[2], np.float32)
                if accum > 1:
                    out = {k: split_micro(v) for k, v in out.items()}
                yield out

        trackable = hasattr(loader, "state_dict")
        if (train and self.checkpointer is not None and self.checkpoint_interval_batches
                and not trackable):
            raise ValueError(
                "checkpoint_interval_batches (mid-epoch snapshots) requires a "
                "train_dataloader with state_dict()/load_state_dict() (got "
                f"{type(loader).__name__}); use tpuframe_torch.data.DataLoader or disable "
                "checkpoint_interval_batches")
        pf = DevicePrefetcher(
            host_iter(),
            depth=max(1, _health._env_int("TPUFRAME_PREFETCH_DEPTH", 2)),
            device=self.device,
            track_loader=loader if train and trackable else None,
            # one dict per loader batch, so the release order stays FIFO
            recycler=loader if hasattr(loader, "release_oldest") else None,
        )
        if train:
            self._train_prefetcher = pf
        yield from pf

    # -- loop --------------------------------------------------------------
    def fit(self) -> FitResult:
        """Run to ``max_duration``; returns the FitResult."""
        result = FitResult()
        self.init_state()
        if self.checkpointer is not None:
            self._resume()
        self._log_params({
            "max_duration": str(self.max_duration),
            "optimizer": type(self.state.optimizer).__name__,
            "precision": str(self.policy.compute_dtype),
            "devices": self.plan.dp_size,
            "zero_stage": self.plan.zero_stage,
            "algorithms": ",".join(type(a).__name__ for a in self.algorithms),
        })
        self._emit("on_fit_start")
        try:
            while not self._done() and self._stop_reason is None:
                with get_telemetry().span("train/epoch", epoch=self.epoch):
                    epoch_metrics = self._run_epoch()
                eval_metrics: dict[str, float] = {}
                if (self.eval_dataloader is not None and self.eval_interval
                        and (self.epoch + 1) % self.eval_interval == 0):
                    eval_metrics = self.evaluate()
                    self._emit("on_eval_end", self.epoch, eval_metrics)
                epoch_summary = {**epoch_metrics, **eval_metrics}
                result.history.append(epoch_summary)
                result.metrics = epoch_summary
                self._log_metrics(epoch_summary, step=self.epoch)
                self._emit("on_epoch_end", self.epoch, epoch_summary)
                # every process saves: the residuals differ by rank
                if (self.checkpointer is not None
                        and (self.epoch + 1) % self.checkpoint_interval == 0):
                    result.checkpoint = self._save_epoch(epoch_summary)
                if self.report is not None and self.is_main:
                    self.report(epoch_summary, result.checkpoint)
                self.epoch += 1
        except BaseException as e:
            result.error = e
            raise
        finally:
            result.stopped_reason = self._stop_reason
            self._emit("on_fit_end")
            for lg in self.loggers:
                if hasattr(lg, "finish"):
                    lg.finish(error=result.error)
                elif hasattr(lg, "flush"):
                    lg.flush()
        return result

    def _done(self) -> bool:
        return self.max_duration.reached(
            epoch=self.epoch, batch=self.batches_seen, samples=self.samples_seen)

    def _run_epoch(self) -> dict[str, float]:
        self._emit("on_epoch_start", self.epoch)
        self.train_dataloader.set_epoch(self.epoch)
        if self._pending_loader_state is not None:
            # resume mid-epoch: skip the batches this epoch already trained
            if not hasattr(self.train_dataloader, "load_state_dict"):
                raise ValueError(
                    "resuming a mid-epoch snapshot requires a train_dataloader with "
                    f"load_state_dict() (got {type(self.train_dataloader).__name__}); restore "
                    "with a tpuframe_torch.data.DataLoader or delete the *_intra snapshot "
                    "directory")
            self.train_dataloader.load_state_dict(self._pending_loader_state)
            self._pending_loader_state = None
        acc = None
        window = None  # device-side metric sums, read once per interval
        t0 = time.perf_counter()
        tele = get_telemetry()
        data_wait = dispatch = host_block = 0.0
        h_assemble = tele.registry.histogram("span/data/assemble")
        h_h2d = tele.registry.histogram("span/data/h2d")
        assemble0, h2d0 = h_assemble.total, h_h2d.total
        epoch_end = object()

        def drain(window):
            """Read the device-side window (the only host sync)."""
            nonlocal host_block
            with tele.span("train/host_block", emit=False) as sp:
                out = {k: float(v) for k, v in window.items() if k != "health_stats"}
                if "health_stats" in window:
                    out.update(_health.unpack_health_stats(window["health_stats"].cpu()))
            host_block += sp.elapsed
            return out

        batches = iter(self._device_batches(self.train_dataloader, train=True))
        try:
            while True:
                with tele.span("train/data_wait", emit=False) as sp:
                    batch = next(batches, epoch_end)
                if batch is epoch_end:
                    break
                wait_s = sp.elapsed
                data_wait += wait_s
                if self._done() or self._stop_reason is not None:
                    break
                self._emit("on_step_start")
                with tele.span("train/step", batch=self.batches_seen,
                               data_wait_s=round(wait_s, 6)) as sp, tele.guard("train/step"):
                    self.state, metrics = self._train_step(self.state, batch)
                dispatch += sp.elapsed
                self.batches_seen += 1
                self.samples_seen += self.train_dataloader.global_batch_size
                self._meter_comms(tele)
                # may raise Divergence before the snapshot would save a doomed state
                self._health_step(metrics)
                self._maybe_snapshot()
                window = metrics if window is None else {k: window[k] + v
                                                         for k, v in metrics.items()}
                self._emit("on_step_end")
                if self.log_interval and self.batches_seen % self.log_interval == 0:
                    w = drain(window)
                    acc = merge_metrics(acc, w)
                    self._emit("on_batch_end", w)
                    self._log_metrics(summarize_metrics(w, prefix="train_batch_"),
                                      step=self.batches_seen)
                    window = None
        finally:
            batches.close()  # stops the prefetcher's thread
        if window is not None:
            w = drain(window)
            acc = merge_metrics(acc, w)
            self._emit("on_batch_end", w)
        self._health_check()
        elapsed = time.perf_counter() - t0
        summary = summarize_metrics(acc or {}, prefix="train_")
        if acc:
            summary["train_samples_per_sec"] = acc.get("count", 0.0) / max(elapsed, 1e-9)
        if self.health is not None and acc:
            summary["health_bad_steps"] = acc.get("health_bad", 0.0)
            finite_steps = acc.get("health_steps", 0.0) - acc.get("health_nonfinite", 0.0)
            if finite_steps > 0:
                summary["grad_norm"] = acc.get("grad_norm_sum", 0.0) / finite_steps
        summary["epoch_time_s"] = elapsed
        summary["data_wait_s"] = data_wait
        summary["dispatch_s"] = dispatch
        summary["host_block_s"] = host_block
        summary["assemble_s"] = h_assemble.total - assemble0
        summary["h2d_s"] = h_h2d.total - h2d0
        return summary

    def evaluate(self) -> dict[str, float]:
        """Mask-correct eval over the eval dataloader."""
        if self.eval_dataloader is None:
            raise ValueError("no eval_dataloader")
        state = self.init_state()
        self.eval_dataloader.set_epoch(0)
        acc = None
        with get_telemetry().span("train/eval", epoch=self.epoch):
            for batch in self._device_batches(self.eval_dataloader, train=False):
                acc = merge_metrics(acc, self._eval_step(state, batch))
        return summarize_metrics(acc or {}, prefix="eval_")

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Logits for a (N, H, W, C) image batch, in eval mode."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return self._predict(self.init_state().model, x).cpu().numpy()


def _planned_total_steps(duration: Duration, dataloader) -> int | None:
    """Best-effort optimizer-step count for schedule resolution."""
    if duration.unit == "ba":
        return duration.value
    if dataloader is None:
        return None
    if duration.unit == "ep":
        try:
            return duration.value * len(dataloader)
        except TypeError:
            return None
    gbs = getattr(dataloader, "global_batch_size", None)
    return max(-(-duration.value // gbs), 1) if gbs else None
