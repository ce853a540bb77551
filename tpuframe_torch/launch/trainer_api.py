"""Ray-Train-shaped API: TPUTrainer + ScalingConfig/RunConfig/Result/report.

Port of ``tpuframe/launch/trainer_api.py`` over the port's
:class:`~tpuframe_torch.launch.Distributor`: the same per-rank report
files, ``metrics_dataframe`` and checkpoint bundles copied into run
storage.  ``ScalingConfig.use_gpu`` (Ray's name; the JAX package's
``use_tpu``) must stay True: CPU workers are ``simulate_devices=1``.
Remote hosts (``ScalingConfig.hosts``) wait for the remote launcher.

Capability parity with the reference's Ray family
(`05_ray/01_fashion_mnist_pytorch_ray.ipynb`):

- ``TorchTrainer(train_func, scaling_config=ScalingConfig(num_workers, use_gpu),
  run_config=RunConfig(storage_path))`` (cell-7) -> :class:`TPUTrainer`;
- ``ray.train.report(metrics, checkpoint=Checkpoint.from_directory(d))``
  per epoch inside the worker (cell-6) -> :func:`report`;
- ``ray.train.get_context().get_world_size()/get_world_rank()`` (cell-6)
  -> :func:`get_context`;
- ``result.metrics / result.checkpoint / result.path / result.error``
  (cell-8) -> :class:`Result`;
- checkpoint reload via ``result.checkpoint.as_directory()`` (cell-9)
  -> :meth:`Checkpoint.as_directory`.

Workers report through files under the run's storage path (the driver and
workers are separate processes, same as Ray actors), so the last report per
rank survives worker exit and the driver can reconstruct history.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Mapping

from tpuframe_torch.launch.distributor import Distributor

__all__ = ["Checkpoint", "Result", "RunConfig", "ScalingConfig", "TPUTrainer", "TrainContext",
           "get_context", "report"]

_RESULT_DIR_ENV = "TPUFRAME_RESULT_DIR"


@dataclasses.dataclass
class ScalingConfig:
    """≈ ``ray.train.ScalingConfig(num_workers, use_gpu)`` (cell-7).

    ``use_gpu=False`` raises: ask for CPU workers with
    ``simulate_devices=1``.  ``hosts`` and ``remote_kwargs`` (the JAX
    package's remote placement) raise ``NotImplementedError``."""

    num_workers: int = 1
    use_gpu: bool = True
    simulate_devices: int | None = None
    hosts: list[str] | None = None
    remote_kwargs: dict | None = None

    def __post_init__(self):
        if not self.use_gpu:
            raise ValueError("ScalingConfig(use_gpu=False): CPU workers are "
                             "ScalingConfig(simulate_devices=1)")
        if self.hosts or self.remote_kwargs:
            raise NotImplementedError(
                "ScalingConfig(hosts=...): remote placement is not ported yet; it comes with "
                "the platform planes (ROADMAP.md, Queue 1 item 9)")


@dataclasses.dataclass
class RunConfig:
    """≈ ``ray.train.RunConfig(storage_path)`` (cell-7)."""

    storage_path: str = "~/tpuframe_results"
    name: str | None = None


class Checkpoint:
    """A directory-backed checkpoint bundle (≈ ``ray.train.Checkpoint``)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @contextlib.contextmanager
    def as_directory(self):
        """Yield a local directory with the checkpoint contents (cell-9)."""
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path!r})"


@dataclasses.dataclass
class Result:
    """≈ ``trainer.fit()``'s result object (cell-8)."""

    metrics: dict[str, float]
    checkpoint: Checkpoint | None
    path: str
    error: BaseException | None
    metrics_dataframe: list[dict] = dataclasses.field(default_factory=list)


class TrainContext:
    """World/rank/report plumbing visible inside a worker (cell-6)."""

    def get_world_size(self) -> int:
        return int(os.environ.get("WORLD_SIZE", "1"))

    def get_world_rank(self) -> int:
        return int(os.environ.get("RANK", "0"))

    def get_local_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK", "0"))

    def get_result_dir(self) -> str | None:
        return os.environ.get(_RESULT_DIR_ENV)


def get_context() -> TrainContext:
    return TrainContext()


def report(metrics: Mapping[str, float], checkpoint: Checkpoint | None = None) -> None:
    """Report metrics (+ optional checkpoint bundle) from a worker — the
    Ray contract at cell-6.  Rank 0's reports become the driver's Result;
    checkpoints are copied into the run storage so they outlive the worker's
    temp dirs."""
    ctx = get_context()
    result_dir = ctx.get_result_dir()
    if result_dir is None:
        return  # running outside a TPUTrainer (e.g. unit test of the fn)
    rank = ctx.get_world_rank()
    record: dict[str, Any] = {
        "time": time.time(),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "checkpoint": None,
    }
    if checkpoint is not None and rank == 0:
        seq = int(_read_seq(result_dir, rank)) + 1
        dest = os.path.join(result_dir, f"checkpoint_{seq:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
        record["checkpoint"] = dest
    with open(os.path.join(result_dir, f"rank_{rank}.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def _read_seq(result_dir: str, rank: int) -> int:
    path = os.path.join(result_dir, f"rank_{rank}.jsonl")
    try:
        with open(path) as f:
            return sum(1 for _ in f)
    except FileNotFoundError:
        return 0


class TPUTrainer:
    """Driver-side trainer handle (≈ ``ray.train.torch.TorchTrainer``).

    >>> trainer = TPUTrainer(train_func,
    ...                      train_loop_config={"lr": 1e-3},
    ...                      scaling_config=ScalingConfig(num_workers=2),
    ...                      run_config=RunConfig(storage_path="/tmp/runs"))
    >>> result = trainer.fit()
    >>> result.metrics, result.checkpoint, result.error
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Mapping[str, Any] | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
    ):
        import inspect

        self.train_loop = train_loop_per_worker
        self.config = dict(train_loop_config or {})
        # Ray's contract: a loop that declares a parameter always receives
        # the config (possibly {}), one that declares none never does.
        self._loop_takes_config = any(
            p.kind
            in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.VAR_POSITIONAL,
            )
            for p in inspect.signature(train_loop_per_worker).parameters.values()
        )
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        """Spawn workers, run the loop, collect the Ray-shaped Result.

        Worker failure lands in ``result.error`` (cell-8's ``result.error``
        check), not as a driver exception."""
        storage = os.path.expanduser(self.run_config.storage_path)
        os.makedirs(storage, exist_ok=True)
        if self.run_config.name:
            result_dir = os.path.join(storage, self.run_config.name)
            os.makedirs(result_dir, exist_ok=True)
            # A named run restarted = a fresh run: stale report history and
            # checkpoint bundles must not leak into (or mask a crash of)
            # this fit's Result — the report seq counter restarts at 0, so a
            # surviving checkpoint_000001 would get new files overlaid on old.
            # Ray would preserve the old run (fresh fit vs Trainer.restore);
            # here the prior contents are MOVED ASIDE, not deleted, so
            # pointing a name at an existing valuable run cannot destroy it.
            stale = [
                entry
                for entry in os.listdir(result_dir)
                if (entry.startswith("rank_") and entry.endswith(".jsonl"))
                or (
                    entry.startswith("checkpoint_")
                    and os.path.isdir(os.path.join(result_dir, entry))
                )
            ]
            if stale:
                prev_dir = tempfile.mkdtemp(
                    prefix=f".prev_{time.strftime('%Y%m%d_%H%M%S')}_",
                    dir=result_dir,
                )
                for entry in stale:
                    shutil.move(
                        os.path.join(result_dir, entry),
                        os.path.join(prev_dir, entry),
                    )
                # the preserved history records checkpoint paths under the
                # live result_dir (which this run will overwrite with its
                # own seq-0 bundles) — repoint them at the moved copies
                for entry in os.listdir(prev_dir):
                    if not (entry.startswith("rank_") and entry.endswith(".jsonl")):
                        continue
                    jsonl = os.path.join(prev_dir, entry)
                    live = os.path.normpath(result_dir)
                    rewritten = []
                    with open(jsonl) as f:
                        for line in f:
                            if not line.strip():
                                continue
                            try:
                                rec = json.loads(line)
                            except json.JSONDecodeError:
                                # truncated tail from a killed worker —
                                # preserve verbatim, like _read_history skips
                                rewritten.append(line.rstrip("\n"))
                                continue
                            ckpt = rec.get("checkpoint")
                            if ckpt and os.path.normpath(os.path.dirname(ckpt)) == live:
                                rec["checkpoint"] = os.path.join(
                                    prev_dir, os.path.basename(ckpt)
                                )
                            rewritten.append(json.dumps(rec))
                    with open(jsonl, "w") as f:
                        f.write("\n".join(rewritten) + "\n")
                print(
                    f"[tpuframe_torch] run name {self.run_config.name!r} already has "
                    f"{len(stale)} result entries; moved to {prev_dir} "
                    "(delete it to reclaim space)",
                    flush=True,
                )
        else:
            result_dir = tempfile.mkdtemp(
                prefix=f"run_{time.strftime('%Y%m%d_%H%M%S')}_", dir=storage
            )

        kw: dict = dict(
            num_processes=self.scaling.num_workers,
            simulate_devices=self.scaling.simulate_devices,
            env={_RESULT_DIR_ENV: result_dir},
        )
        dist = Distributor(**kw)
        error: BaseException | None = None
        try:
            if self._loop_takes_config:
                dist.run(self.train_loop, self.config)
            else:
                dist.run(self.train_loop)
        except (Exception, SystemExit) as e:
            # Worker failure — including a train loop calling sys.exit() —
            # lands in result.error, never as a driver exception.
            error = e

        history = self._read_history(result_dir, rank=0)
        metrics = history[-1]["metrics"] if history else {}
        ckpt_path = next(
            (r["checkpoint"] for r in reversed(history) if r.get("checkpoint")), None
        )
        return Result(
            metrics=metrics,
            checkpoint=Checkpoint(ckpt_path) if ckpt_path else None,
            path=result_dir,
            error=error,
            metrics_dataframe=[r["metrics"] for r in history],
        )

    @staticmethod
    def _read_history(result_dir: str, rank: int) -> list[dict]:
        path = os.path.join(result_dir, f"rank_{rank}.jsonl")
        out = []
        try:
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        # truncated tail from a worker killed mid-append:
                        # surface what was durably recorded, don't crash
                        # the driver (fit()'s contract: worker failure
                        # lands in Result.error, never a driver raise)
                        continue
        except FileNotFoundError:
            pass
        return out
