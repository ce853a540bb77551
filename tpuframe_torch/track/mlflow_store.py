"""MLflow-compatible experiment tracking on a file store.

Port of ``tpuframe/track/mlflow_store.py`` (stdlib and ``yaml``): the same
``mlruns/`` tree, file for file (``meta.yaml`` keys, nested metric keys
with the ``%`` flat fallback, MLflow's status codes), so one MLflow UI
reads runs of both packages.  Three differences:

- ``log_model`` and ``log_state_dict`` keep the JAX file names
  (``model.msgpack``, ``state.msgpack``) so registry lookups and readers of
  the layout resolve, but the bytes are ``torch.save`` bytes of the port's
  ``ckpt.save_pytree``, not flax msgpack; the ``MLmodel`` flavor's
  ``format`` says ``torch-save``.  The tree is ``{"params": {name:
  tensor}, "batch_stats": {name: buffer}}`` for a ``TrainState`` or a
  module, by parameter name, as ``ckpt.load_pytree`` reads it back.
- :func:`broadcast_run_id` sends rank 0's id over the host control plane
  in a launched run, as the JAX package does, else over the
  ``torch.distributed`` process group (gloo or NCCL), 64 bytes at most.
- An ``http(s)://`` tracking URI goes to the REST client of
  ``track.http_store``, as in JAX.
  ``MLflowLogger(system_metrics=True)`` starts a
  ``track.system_metrics.SystemMetricsMonitor`` on the run, as in JAX.

Implements the ``mlruns/`` file-store layout (experiment dirs with
``meta.yaml``, run dirs with ``params/``, ``metrics/``, ``tags/``,
``artifacts/``) natively, so runs written here open in any stock MLflow UI —
wire-compat without requiring the mlflow package (BASELINE.md: "MLflow logging
from setup/ stays intact").  Remote/Databricks tracking URIs are out of scope
for the file store; point a stock mlflow client at the same ``mlruns/`` dir
to sync runs wherever you like.

Reference behaviors reproduced:
- experiment-per-name setup: ``mlflow.set_experiment(experiment_path)``
  (`setup/00_setup.py:96-101`);
- ``log_params`` once + ``log_metric(key, value, step=epoch)`` per epoch
  (`01_torch_distributor/01_basic_torch_distributor.py:275-276`,
  `01_torch_distributor/02_cifar_torch_distributor_resnet.py:258-260`);
- state-dict and model artifacts per epoch / best
  (`04_accelerate/01_cifar_accelerate.ipynb:cell-18`);
- run-id propagation to non-zero ranks — the reference broadcasts the run-id
  as a char tensor over NCCL (`cell-18`), as :func:`broadcast_run_id` does
  here over the control plane or the process group.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Mapping

from tpuframe_torch.core import runtime as rt

__all__ = ["ExperimentTracker", "MLflowLogger", "Run", "broadcast_run_id", "set_experiment",
           "start_run"]

_INVALID = set('\\#?%:"<>|')

#: MLflow's RunStatus int enum, as persisted by its file store.
_STATUS = {"RUNNING": 1, "SCHEDULED": 2, "FINISHED": 3, "FAILED": 4, "KILLED": 5}


def _sanitize(key: str) -> str:
    """Key -> relative path.  '/' is legal in MLflow keys and maps to nested
    directories in the file store ('system/cpu' -> metrics/system/cpu);
    path-escape segments are neutralized."""
    cleaned = "".join("_" if c in _INVALID else c for c in str(key))
    parts = [p for p in cleaned.split("/") if p not in ("", ".", "..")]
    return "/".join(parts) or "_"


def _flat_key_path(base: str, rel: str) -> str:
    """Flat fallback name for a nested key.  Leading '%' keeps it disjoint
    from every sanitized key (% is in _INVALID, so no sanitized name starts
    with it)."""
    return os.path.join(base, "%" + rel.replace("/", "%2F"))


def _key_file(base: str, key: str) -> str:
    """Writable path for ``key``.  '/' keys nest into directories; when a
    nested path collides with an existing flat key (file where a directory
    is needed, or vice versa — e.g. metric 'system' logged before
    'system/cpu'), the key degrades to a flat percent-encoded file."""
    rel = _sanitize(key)
    nested = os.path.join(base, *rel.split("/"))
    flat = _flat_key_path(base, rel)
    if os.path.isfile(nested):
        return nested
    if os.path.isfile(flat):
        return flat
    try:
        os.makedirs(os.path.dirname(nested), exist_ok=True)
        if os.path.isdir(nested):
            raise IsADirectoryError(nested)
        return nested
    except (FileExistsError, NotADirectoryError, IsADirectoryError):
        os.makedirs(base, exist_ok=True)
        return flat


def _find_key_file(base: str, key: str) -> str:
    """Read-side twin of :func:`_key_file`: nested location if present,
    else the flat fallback."""
    rel = _sanitize(key)
    nested = os.path.join(base, *rel.split("/"))
    if os.path.isfile(nested):
        return nested
    return _flat_key_path(base, rel)


def _now_ms() -> int:
    return int(time.time() * 1000)


#: what ``model.msgpack`` and ``state.msgpack`` hold in the port (the JAX
#: package writes ``flax-msgpack`` there)
MODEL_FORMAT = "torch-save"


def _model_tree(state: Any) -> dict:
    """``{"params": {name: tensor}, "batch_stats": {name: buffer}}`` of a
    ``TrainState`` (its model) or a module; a mapping with ``params`` as it
    is (``batch_stats`` empty when absent); anything else as the params."""
    model = getattr(state, "model", state)
    if hasattr(model, "named_parameters"):
        return {"params": {n: p.detach() for n, p in model.named_parameters()},
                "batch_stats": {n: b for n, b in model.named_buffers()
                                if b.is_floating_point()}}
    if isinstance(state, Mapping) and "params" in state:
        return {"params": state["params"], "batch_stats": state.get("batch_stats", {}) or {}}
    return {"params": state, "batch_stats": {}}


def _write_yaml(path: str, data: Mapping[str, Any]) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dict(data), f, default_flow_style=False)


class Run:
    """One tracked run (≈ ``mlflow.start_run()`` handle).

    All writes are append-safe and idempotent-friendly; callers are expected
    to gate on rank 0 (`MLflowLogger` and the Trainer do this for you).
    """

    def __init__(self, root: str, experiment_id: str, run_id: str | None = None,
                 run_name: str | None = None):
        self.experiment_id = experiment_id
        self.run_id = run_id or uuid.uuid4().hex
        self.run_name = run_name or f"run-{self.run_id[:8]}"
        self._dir = os.path.join(root, experiment_id, self.run_id)
        self.artifact_dir = os.path.join(self._dir, "artifacts")
        for sub in ("metrics", "params", "tags", "artifacts"):
            os.makedirs(os.path.join(self._dir, sub), exist_ok=True)
        self._start = _now_ms()
        self._write_meta(status="RUNNING", end_time=None)
        self.set_tag("mlflow.runName", self.run_name)

    def _write_meta(self, status: str, end_time: int | None) -> None:
        _write_yaml(
            os.path.join(self._dir, "meta.yaml"),
            {
                "artifact_uri": "file://" + os.path.abspath(self.artifact_dir),
                "end_time": end_time,
                "entry_point_name": "",
                "experiment_id": self.experiment_id,
                "lifecycle_stage": "active",
                "run_id": self.run_id,
                "run_name": self.run_name,
                "run_uuid": self.run_id,
                "source_name": "",
                "source_type": 4,
                "source_version": "",
                "start_time": self._start,
                "status": _STATUS.get(status, status),
                "user_id": os.environ.get("USER", "tpuframe"),
            },
        )

    # -- params / metrics / tags ------------------------------------------
    def log_param(self, key: str, value: Any) -> None:
        with open(_key_file(os.path.join(self._dir, "params"), key), "w") as f:
            f.write(str(value))

    def log_params(self, params: Mapping[str, Any]) -> None:
        for k, v in params.items():
            self.log_param(k, v)

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        with open(_key_file(os.path.join(self._dir, "metrics"), key), "a") as f:
            f.write(f"{_now_ms()} {float(value)} {int(step)}\n")

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def set_tag(self, key: str, value: Any) -> None:
        with open(_key_file(os.path.join(self._dir, "tags"), key), "w") as f:
            f.write(str(value))

    # -- artifacts ---------------------------------------------------------
    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> str:
        dest_dir = self.artifact_dir
        if artifact_path:
            dest_dir = os.path.join(dest_dir, artifact_path)
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(local_path))
        shutil.copy2(local_path, dest)
        return dest

    def log_text(self, text: str, artifact_file: str) -> str:
        dest = os.path.join(self.artifact_dir, artifact_file)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w") as f:
            f.write(text)
        return dest

    def log_dict(self, data: Mapping[str, Any], artifact_file: str) -> str:
        return self.log_text(json.dumps(dict(data), indent=2, default=str), artifact_file)

    def log_state_dict(self, tree: Any, artifact_path: str = "state_dict") -> str:
        """Per-epoch state-dict artifact (≈ ``mlflow.pytorch.log_state_dict``,
        `04_accelerate/01_cifar_accelerate.ipynb:cell-18`): a nested
        mapping of tensors (or a module, as ``{"params", "batch_stats"}``)
        in ``state.msgpack``, ``torch.save`` bytes."""
        from tpuframe_torch.ckpt import save_pytree

        dest = os.path.join(self.artifact_dir, artifact_path, "state.msgpack")
        save_pytree(dest, _model_tree(tree) if hasattr(tree, "named_parameters") else tree)
        return dest

    def log_model(self, state: Any, artifact_path: str = "model",
                  meta: Mapping[str, Any] | None = None) -> str:
        """Log a servable model artifact: parameters and BatchNorm buffers
        of a ``TrainState`` or a module (or a ``{"params",
        "batch_stats"}`` mapping) in ``model.msgpack`` (``torch.save``
        bytes), and an ``MLmodel`` descriptor (≈
        ``mlflow.pytorch.log_model``,
        `01_torch_distributor/01_basic_torch_distributor.py:302-304`)."""
        from tpuframe_torch.ckpt import save_pytree

        model_dir = os.path.join(self.artifact_dir, artifact_path)
        save_pytree(os.path.join(model_dir, "model.msgpack"), _model_tree(state))
        _write_yaml(
            os.path.join(model_dir, "MLmodel"),
            {
                "artifact_path": artifact_path,
                "flavors": {
                    "tpuframe": {
                        "format": MODEL_FORMAT,
                        "data": "model.msgpack",
                        **dict(meta or {}),
                    }
                },
                "run_id": self.run_id,
                "utc_time_created": time.strftime(
                    "%Y-%m-%d %H:%M:%S", time.gmtime()
                ),
            },
        )
        return model_dir

    # -- lifecycle ---------------------------------------------------------
    def end(self, status: str = "FINISHED") -> None:
        self._write_meta(status=status, end_time=_now_ms())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.end("FAILED" if exc_type else "FINISHED")

    # -- reads (for tests / reload paths) ----------------------------------
    def get_metric_history(self, key: str) -> list[tuple[int, float, int]]:
        path = _find_key_file(os.path.join(self._dir, "metrics"), key)
        out = []
        try:
            with open(path) as f:
                for line in f:
                    ts, val, step = line.split()
                    out.append((int(ts), float(val), int(step)))
        except FileNotFoundError:
            pass
        return out

    def get_param(self, key: str) -> str | None:
        try:
            with open(_find_key_file(os.path.join(self._dir, "params"), key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def artifact_path(self, *parts: str) -> str:
        return os.path.join(self.artifact_dir, *parts)


class ExperimentTracker:
    """Experiment registry over an ``mlruns/`` root (≈ the mlflow client).

    >>> tracker = ExperimentTracker("./mlruns")
    >>> tracker.set_experiment("/Users/me/experiments/cifar")
    >>> with tracker.start_run(run_name="baseline") as run:
    ...     run.log_params({"lr": 1e-3}); run.log_metric("loss", 0.5, step=0)
    """

    def __init__(self, tracking_uri: str = "./mlruns"):
        self.root = os.path.abspath(tracking_uri.removeprefix("file://"))
        os.makedirs(self.root, exist_ok=True)
        self.experiment_id: str | None = None
        self.experiment_name: str | None = None

    def _experiments(self) -> dict[str, str]:
        """name -> experiment_id for existing experiments."""
        import yaml

        out = {}
        for entry in sorted(os.listdir(self.root)):
            meta = os.path.join(self.root, entry, "meta.yaml")
            if entry.isdigit() and os.path.exists(meta):
                with open(meta) as f:
                    data = yaml.safe_load(f) or {}
                if "name" in data and "run_id" not in data:
                    out[data["name"]] = entry
        return out

    def set_experiment(self, name: str) -> str:
        """Get-or-create an experiment by name; returns its id.  Mirrors the
        idempotent ``mlflow.set_experiment`` in `setup/00_setup.py:96-101`."""
        existing = self._experiments()
        if name in existing:
            self.experiment_id = existing[name]
        else:
            next_id = str(max((int(i) for i in existing.values()), default=-1) + 1)
            exp_dir = os.path.join(self.root, next_id)
            os.makedirs(exp_dir, exist_ok=True)
            _write_yaml(
                os.path.join(exp_dir, "meta.yaml"),
                {
                    "artifact_location": "file://" + exp_dir,
                    "creation_time": _now_ms(),
                    "experiment_id": next_id,
                    "last_update_time": _now_ms(),
                    "lifecycle_stage": "active",
                    "name": name,
                },
            )
            self.experiment_id = next_id
        self.experiment_name = name
        return self.experiment_id

    def start_run(self, run_name: str | None = None, run_id: str | None = None) -> Run:
        if self.experiment_id is None:
            self.set_experiment("Default")
        return Run(self.root, self.experiment_id, run_id=run_id, run_name=run_name)

    def runs(self, experiment_name: str | None = None) -> list[str]:
        import yaml

        exp_id = self.experiment_id
        if experiment_name is not None:
            exp_id = self._experiments().get(experiment_name)
        if exp_id is None:
            return []
        exp_dir = os.path.join(self.root, exp_id)
        return [
            e for e in sorted(os.listdir(exp_dir))
            if os.path.isdir(os.path.join(exp_dir, e))
            and os.path.exists(os.path.join(exp_dir, e, "meta.yaml"))
        ]


class MLflowLogger:
    """Trainer logger plugin (≈ Composer's ``MLFlowLogger``,
    `03_composer/01_cifar_composer_resnet.ipynb:cell-16`).

    Duck-typed to the Trainer's logger contract: ``log_params(dict)``,
    ``log_metrics(dict, step=)``, ``flush()``.  Creates the experiment/run
    lazily on first write; only the main process ever writes (non-main
    processes can still learn the run id via :func:`broadcast_run_id`).
    """

    def __init__(
        self,
        experiment_name: str = "tpuframe",
        tracking_uri: str = "./mlruns",
        run_name: str | None = None,
        system_metrics: bool = False,
    ):
        self.experiment_name = experiment_name
        self.tracking_uri = tracking_uri
        self.run_name = run_name
        self.system_metrics = system_metrics
        self._tracker: ExperimentTracker | None = None
        self._run: Run | None = None
        self._monitor = None

    @property
    def run(self) -> Run:
        if self._run is None:
            self._tracker = make_tracker(self.tracking_uri)
            self._tracker.set_experiment(self.experiment_name)
            self._run = self._tracker.start_run(run_name=self.run_name)
            if self.system_metrics:
                from tpuframe_torch.track.system_metrics import SystemMetricsMonitor

                self._monitor = SystemMetricsMonitor(self._run)
                self._monitor.start()
        return self._run

    def log_params(self, params: Mapping[str, Any]) -> None:
        self.run.log_params(params)

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0) -> None:
        self.run.log_metrics(metrics, step)

    def log_model(self, state: Any, artifact_path: str = "model") -> str:
        return self.run.log_model(state, artifact_path)

    def flush(self, status: str = "FINISHED") -> None:
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
        if self._run is not None:
            self._run.end(status)
            self._run = None

    def finish(self, error: BaseException | None = None) -> None:
        """End the run with a truthful status — a crashed fit records FAILED
        (the Trainer calls this from its finally block)."""
        self.flush("FAILED" if error is not None else "FINISHED")


# -- module-level convenience (the mlflow-style imperative API) --------------

_DEFAULT_TRACKER: ExperimentTracker | None = None


def make_tracker(tracking_uri: str):
    """The file store over ``tracking_uri``; an ``http(s)://`` URI gets
    the REST client (``track.http_store.HttpExperimentTracker``)."""
    from tpuframe_torch.track.http_store import make_tracker as _make

    return _make(tracking_uri)


def set_experiment(name: str, tracking_uri: str = "./mlruns"):
    """The file store over ``tracking_uri``, at experiment ``name``
    (``setup/00_setup.py:96-101``)."""
    global _DEFAULT_TRACKER
    _DEFAULT_TRACKER = make_tracker(tracking_uri)
    _DEFAULT_TRACKER.set_experiment(name)
    return _DEFAULT_TRACKER


def start_run(run_name: str | None = None) -> Run:
    if _DEFAULT_TRACKER is None:
        set_experiment("Default")
    return _DEFAULT_TRACKER.start_run(run_name=run_name)


def broadcast_run_id(run_id: str | None, max_len: int = 64) -> str:
    """Rank 0's run id on every process.

    The reference's char-tensor NCCL broadcast
    (`04_accelerate/01_cifar_accelerate.ipynb:cell-18`).  Primary route, as
    the JAX package's: the host control plane (``core.native.
    control_plane``), when ``WORLD_SIZE`` is the runtime's process count and
    the launcher's plane env (``TPUFRAME_CP_PORT``) is there; the id comes
    back whole.  Otherwise, or when the plane cannot be built, the id's
    bytes, zero-padded to ``max_len``, in a uint8 tensor broadcast from
    rank 0 over the default process group (on the current CUDA device under
    NCCL, on the CPU under gloo); an id longer than ``max_len`` comes back
    cut.  Call it on every process; pass the id on rank 0 and anything
    (e.g. None) elsewhere.  Without a group, or at world 1, it returns
    ``run_id`` (or "")."""
    if rt.process_count() == 1:
        return run_id or ""
    if (int(os.environ.get("WORLD_SIZE", "1")) == rt.process_count()
            and os.environ.get("TPUFRAME_CP_PORT")):
        from tpuframe_torch.core.native import control_plane

        try:
            return control_plane().broadcast_str(run_id if rt.is_main_process() else None)
        except (RuntimeError, OSError, ValueError):
            pass  # no toolchain, or the env contract does not hold: the group's route
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if rt.is_main_process() and run_id:
        raw = run_id.encode()[:max_len]
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(device)
    dist.broadcast(buf, src=0)
    out = buf.cpu().numpy()
    return bytes(out[out != 0]).decode()
