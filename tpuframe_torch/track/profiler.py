"""Profiling: programmatic ``torch.profiler`` capture + step timing.

Port of ``tpuframe/track/profiler.py`` on ``torch.profiler`` (Kineto)
where the JAX package drives ``jax.profiler``:

- :func:`trace` — context manager around any region; writes a Chrome
  trace (``<logdir>/<worker>.<ts>.pt.trace.json.gz``, TensorBoard's
  layout) with the host's ops and the card's kernels, copies and memsets.
- :func:`trace_step_window` — ``n_steps`` calls of a step under a trace,
  the card synchronized after each, as JAX blocks on each step's output.
- :class:`ProfilerCallback` — Trainer callback that captures a window of
  train steps, one-shot (logged as a zipped run artifact, rank 0 only) or
  on a cadence (``every_steps > 0``: ``capture-b<batch>`` dirs, the newest
  ``keep`` retained), armed from the env by :meth:`ProfilerCallback.
  from_env` / ``TPUFRAME_PROFILE_*``.

Every completed capture emits one ``profile/capture`` telemetry event
(dir, steps, bytes, the wall/mono anchor pair of its start, and the
number of device events the trace holds) and bumps the
``profile/captures`` counter: the breadcrumbs ``tpuframe_torch.track.
analyze`` follows to attach a parsed ``device_time`` block to the skew
report.  ``device_events: 0`` on a run with a card says the profiler saw
no device work, which the report must not pass off as an idle window.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import TYPE_CHECKING, Any

from tpuframe_torch.train.callbacks import Callback

if TYPE_CHECKING:  # pragma: no cover
    from tpuframe_torch.train.trainer import Trainer

__all__ = ["ProfilerCallback", "StepTimer", "trace", "trace_step_window"]


def _sync() -> None:
    """Wait for the card's queued work, where this process has touched one
    (JAX's ``block_until_ready``)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _start(logdir: str):
    """A started ``torch.profiler`` session whose stop writes a gzipped
    Chrome trace into ``logdir``: host ops, and the card's where there is
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir, use_gzip=True))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region to
    ``logdir``.

    The caller synchronizes on work it wants included before the region
    closes (:func:`trace_step_window` does).  The trace is stopped on the
    error path too, and a stop failure there is swallowed so it can
    neither mask the real exception nor leave the profiler running.
    """
    os.makedirs(logdir, exist_ok=True)
    prof = _start(logdir)
    try:
        yield logdir
    except BaseException:
        try:
            prof.stop()
        except Exception:
            pass
        raise
    else:
        prof.stop()


def trace_step_window(fn, n_steps: int, logdir: str, *args, **kwargs) -> str:
    """Run ``fn(*args, **kwargs)`` ``n_steps`` times under a trace, the
    card synchronized after each step so its work lands in the trace.  A
    raising step still closes the trace.  Returns ``logdir``."""
    with trace(logdir):
        for _ in range(n_steps):
            fn(*args, **kwargs)
            _sync()
    return logdir


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
    return total


class ProfilerCallback(Callback):
    """Capture ``torch.profiler`` traces of train-step windows, with an
    optional cadence.

    Args:
      logdir: where to write traces.  One-shot mode defaults to a temp
        dir (removed after the artifact is logged); cadence mode needs a
        stable home and defaults to ``<tmp>/tpuframe_profile_<pid>``.
      skip_steps: batches to skip first (warm-up, compile).
      num_steps: batches per capture window.
      every_steps: 0 (default) = one capture then done; N > 0 = a fresh
        ``num_steps``-step capture every N batches, each into its own
        ``capture-b<batch>`` subdir of ``logdir``, oldest dirs dropped
        past ``keep``.
      keep: capture dirs retained in cadence mode (default 3).
      rank0_only: capture on the main process only (default True).

    One-shot captures are zipped and handed to every logger exposing a
    ``run.log_artifact`` or ``log_artifact``, rank 0 only.  Cadence
    captures stay on disk as parseable evidence.
    """

    def __init__(
        self,
        logdir: str | None = None,
        skip_steps: int = 3,
        num_steps: int = 5,
        *,
        every_steps: int = 0,
        keep: int | None = None,
        rank0_only: bool = True,
    ):
        self.logdir = logdir
        self.skip_steps = skip_steps
        self.num_steps = max(1, int(num_steps))
        self.every_steps = max(0, int(every_steps))
        self.keep = 3 if keep is None else max(1, int(keep))
        self.rank0_only = rank0_only
        self._tmp: str | None = None
        self._active = False
        self._done = False
        self._next_start = None  # cadence: earliest batch to start at
        self._capture_dir: str | None = None
        self._anchor: tuple[float, float] | None = None  # (wall, mono)
        self._prof: Any = None
        self.trace_dir: str | None = None
        self.artifact: str | None = None
        #: completed captures, newest last: {dir, steps, bytes, partial,
        #: device_events}
        self.captures: list[dict] = []
        #: True when the fit ended inside the capture window
        self.partial = False

    @classmethod
    def from_env(cls) -> "ProfilerCallback | None":
        """The env-armed instance (``TPUFRAME_PROFILE_STEPS`` > 0 arms
        it; EVERY/KEEP/DIR refine), or None when capture is off."""
        from tpuframe_torch.track.device_time import profile_env

        env = profile_env()
        steps = env["TPUFRAME_PROFILE_STEPS"]
        if not steps:
            return None
        return cls(
            logdir=env["TPUFRAME_PROFILE_DIR"] or None,
            num_steps=steps,
            every_steps=env["TPUFRAME_PROFILE_EVERY"],
            keep=env["TPUFRAME_PROFILE_KEEP"],
        )

    @property
    def cadence(self) -> bool:
        return self.every_steps > 0

    def _base_dir(self) -> str:
        if self.logdir is None and self._tmp is None:
            if self.cadence:
                self._tmp = os.path.join(
                    tempfile.gettempdir(), f"tpuframe_profile_{os.getpid()}"
                )
            else:
                self._tmp = tempfile.mkdtemp(prefix="tpuframe_trace_")
        return self.logdir or self._tmp

    def _target(self) -> str:
        base = self._base_dir()
        if self.cadence:
            return os.path.join(base, f"capture-b{self._start_batch:08d}")
        return base

    def on_step_start(self, trainer: "Trainer") -> None:
        if self._done or self._active:
            return
        if self.rank0_only and not trainer.is_main:
            self._done = True  # never arms on this rank; stop checking
            return
        start_at = (
            self._next_start if self._next_start is not None
            else self.skip_steps
        )
        if trainer.batches_seen < start_at:
            return
        self._start_batch = trainer.batches_seen
        target = self._target()
        os.makedirs(target, exist_ok=True)
        self._anchor = (time.time(), time.monotonic())
        self._prof = _start(target)
        self._active = True
        self._capture_dir = target

    def on_step_end(self, trainer: "Trainer") -> None:
        if not self._active:
            return
        if trainer.batches_seen - self._start_batch < self.num_steps:
            return
        self._finalize(trainer, partial=False)

    def on_fit_end(self, trainer: "Trainer") -> None:
        # the fit ended mid-capture (duration reached, early stop, a step
        # that raised): close the trace and keep the partial window
        if self._active:
            self._finalize(trainer, partial=True)
            self._done = True

    def _finalize(self, trainer: "Trainer", *, partial: bool) -> None:
        from tpuframe_torch.track.device_time import count_device_events

        try:
            _sync()  # the window's queued kernels land in the trace
        except Exception:
            pass
        try:
            self._prof.stop()
        finally:
            self._active = False
            self._prof = None
        self.partial = partial
        steps = max(0, trainer.batches_seen - self._start_batch)
        cap_dir = self._capture_dir
        cap = {
            "dir": cap_dir,
            "steps": steps,
            "bytes": _dir_bytes(cap_dir) if cap_dir else 0,
            "partial": partial,
            "device_events": count_device_events(cap_dir) if cap_dir else 0,
        }
        self.captures.append(cap)
        self._emit_capture_event(cap)
        if self.cadence:
            self.trace_dir = cap_dir
            self._rotate()
            # the next window from this one's START: "every N steps"
            self._next_start = self._start_batch + max(
                self.every_steps, self.num_steps
            )
        else:
            self._done = True
            if trainer.is_main:
                self._log_artifact(trainer)
            if self._tmp is not None:
                shutil.rmtree(self._tmp, ignore_errors=True)
                self._tmp = None
                self.trace_dir = None
            else:
                self.trace_dir = self.logdir

    def _emit_capture_event(self, cap: dict) -> None:
        from tpuframe_torch.track.telemetry import get_telemetry

        tele = get_telemetry()
        tele.registry.counter("profile/captures").inc()
        wall, mono = self._anchor or (None, None)
        tele.event(
            "profile/capture",
            dir=cap["dir"],
            steps=cap["steps"],
            bytes=cap["bytes"],
            partial=cap["partial"],
            device_events=cap["device_events"],
            wall_start=wall,
            mono_start=mono,
        )

    def _rotate(self) -> None:
        """Drop capture dirs past ``keep``, oldest first."""
        from tpuframe_torch.track.device_time import list_captures

        caps = list_captures(self._base_dir())
        for stale in caps[: max(0, len(caps) - self.keep)]:
            shutil.rmtree(stale, ignore_errors=True)

    def _log_artifact(self, trainer: "Trainer") -> None:
        src = self._capture_dir or self._base_dir()
        base = os.path.join(
            tempfile.mkdtemp(prefix="tpuframe_trace_zip_"), "torch_trace"
        )
        archive = shutil.make_archive(base, "zip", src)
        for lg in trainer.loggers:
            run = getattr(lg, "run", None)
            target: Any = None
            if run is not None and hasattr(run, "log_artifact"):
                target = run
            elif hasattr(lg, "log_artifact"):
                target = lg
            if target is not None:
                self.artifact = target.log_artifact(archive, "profile")
        shutil.rmtree(os.path.dirname(archive), ignore_errors=True)


class StepTimer(Callback):
    """Lightweight per-step wall-clock sampler (host side).

    Records the host time of each dispatched step; ``summary()`` gives
    mean/p50/p95/p99 step wall time over a ring of the most recent
    ``max_samples`` steps, and every sample is also folded into the
    telemetry registry (``callback/step_time_s``).
    """

    def __init__(self, max_samples: int = 4096):
        from collections import deque

        self.max_samples = max_samples
        self.samples: "deque[float]" = deque(maxlen=max_samples)
        self.steps_seen = 0
        self._t0: float | None = None

    def on_step_start(self, trainer: "Trainer") -> None:
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer: "Trainer") -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        self.steps_seen += 1
        self._t0 = None
        from tpuframe_torch.track.telemetry import get_telemetry

        get_telemetry().registry.histogram(
            "callback/step_time_s", max_samples=self.max_samples
        ).observe(dt)

    def summary(self) -> dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "step_time_mean_s": sum(s) / n,
            "step_time_p50_s": s[n // 2],
            "step_time_p95_s": s[min(n - 1, int(n * 0.95))],
            "step_time_p99_s": s[min(n - 1, int(n * 0.99))],
            "steps_sampled": float(n),
            "steps_seen": float(self.steps_seen),
        }
