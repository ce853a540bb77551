"""Workspace: the idempotent storage-layout bootstrap.

The port's own copy of ``tpuframe/core/workspace.py`` (stdlib only).

The reference bootstraps its storage locations with ``CREATE CATALOG /
SCHEMA / VOLUME IF NOT EXISTS`` against Unity Catalog
(`setup/00_setup.py:27-54`: one volume per dataset —
cifar, tiny_imagenet, imagenet_1k, ms_coco) and exports credentials for
worker re-auth (`setup/00_setup.py:86-92`).  The equivalent here is
a filesystem contract: one workspace root (local disk, NFS, or a mounted
bucket) with a fixed layout every subsystem agrees on, created
idempotently, plus an env channel that ships tracking credentials to
worker processes.

>>> ws = Workspace("/mnt/experiments/run42")
>>> ws.dataset_dir("cifar10")        # ≈ the cifar UC volume
>>> ws.shards_dir("tiny_imagenet")   # TFS shard root ("remote")
>>> ws.checkpoints, ws.mlruns        # checkpoint root, tracking store
>>> ws.local_scratch()               # per-host cache (≈ /local_disk0)
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Mapping

__all__ = ["LAYOUT_VERSION", "PERF_ENV_DOMAINS", "PERF_ENV_VARS", "Workspace", "export_worker_env"]

#: layout version written to the root marker; bump on breaking changes
LAYOUT_VERSION = 1

#: Input-pipeline / kernel-dispatch / debug knobs that must reach every
#: worker, the JAX package's list as it is (the launcher forwards the
#: whole environment to its workers; the Pallas switches name nothing in
#: the port, whose kernels dispatch by device alone).
PERF_ENV_VARS = (
    "TPUFRAME_NATIVE_JPEG",
    "TPUFRAME_JPEG_THREADS",
    "TPUFRAME_DISABLE_PALLAS",
    "TPUFRAME_PALLAS_INTERPRET",
    "TPUFRAME_DEBUG",
    "TPUFRAME_CKPT_DIR",
    "TPUFRAME_LOADER_WORKERS",
    "TPUFRAME_LOADER_RING_BUFFERS",
    "TPUFRAME_LOADER_TRANSFER_DTYPE",
    "TPUFRAME_PREFETCH_DEPTH",
    "TPUFRAME_GRAD_ACCUM",
    "TPUFRAME_CKPT_INTERVAL_BATCHES",
)

#: value domains for the knobs above, as the JAX package declares them
#: (``apply``: "restart" for knobs read when objects are built, "live"
#: for one the running Trainer re-reads).
PERF_ENV_DOMAINS = {
    "TPUFRAME_NATIVE_JPEG": {"type": "bool", "apply": "restart"},
    "TPUFRAME_JPEG_THREADS": {
        "type": "int", "range": (1, None), "apply": "restart"},
    "TPUFRAME_DISABLE_PALLAS": {"type": "bool", "apply": "restart"},
    "TPUFRAME_PALLAS_INTERPRET": {"type": "bool", "apply": "restart"},
    "TPUFRAME_DEBUG": {"type": "bool", "apply": "restart"},
    "TPUFRAME_CKPT_DIR": {"type": "path", "apply": "restart"},
    "TPUFRAME_LOADER_WORKERS": {
        "type": "int", "range": (0, 64), "apply": "restart"},
    "TPUFRAME_LOADER_RING_BUFFERS": {
        "type": "int", "range": (2, 64), "apply": "restart"},
    "TPUFRAME_LOADER_TRANSFER_DTYPE": {
        "type": "enum", "choices": ("uint8", "float32"), "apply": "restart"},
    "TPUFRAME_PREFETCH_DEPTH": {
        "type": "int", "range": (1, 16), "apply": "restart"},
    "TPUFRAME_GRAD_ACCUM": {
        "type": "int", "range": (1, 256), "apply": "restart"},
    "TPUFRAME_CKPT_INTERVAL_BATCHES": {
        "type": "int", "range": (1, None), "apply": "live"},
}


@dataclasses.dataclass(frozen=True)
class Workspace:
    """Canonical directory layout under one root, created on first access.

    Everything is idempotent — calling any accessor twice, or from many
    processes at once, is safe (``os.makedirs(exist_ok=True)`` semantics,
    like the reference's ``IF NOT EXISTS`` SQL).
    """

    root: str

    def __post_init__(self):
        object.__setattr__(self, "root", os.path.abspath(os.fspath(self.root)))
        self._ensure(self.root)
        marker = os.path.join(self.root, ".tpuframe-workspace")
        if not os.path.exists(marker):
            tmp = f"{marker}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(f"version: {LAYOUT_VERSION}\n")
            os.replace(tmp, marker)  # atomic vs concurrent bootstrappers

    @staticmethod
    def _ensure(path: str) -> str:
        os.makedirs(path, exist_ok=True)
        return path

    # -- shared (workspace-root) locations ---------------------------------
    @property
    def checkpoints(self) -> str:
        """Checkpoint root (pass to ckpt.Checkpointer)."""
        return self._ensure(os.path.join(self.root, "checkpoints"))

    @property
    def mlruns(self) -> str:
        """File-store tracking URI (pass to MLflowLogger/set_experiment)."""
        return self._ensure(os.path.join(self.root, "mlruns"))

    def dataset_dir(self, name: str) -> str:
        """Raw-dataset cache, one dir per dataset (≈ the UC volumes,
        `setup/00_setup.py:38-53`)."""
        return self._ensure(os.path.join(self.root, "datasets", name))

    def shards_dir(self, name: str) -> str:
        """TFS shard root for ``name`` — the StreamingDataset 'remote'."""
        return self._ensure(os.path.join(self.root, "shards", name))

    def run_dir(self, run_name: str) -> str:
        """Per-run scratch for launcher APIs (Ray RunConfig.storage_path
        parity, `05_ray/01_fashion_mnist_pytorch_ray.ipynb:cell-7`)."""
        return self._ensure(os.path.join(self.root, "runs", run_name))

    # -- per-host locations -------------------------------------------------
    def local_scratch(self, subdir: str = "") -> str:
        """Fast host-local cache (≈ ``/local_disk0/mds``,
        `03a_…_mds.py:382-390`): stays on this machine even when the
        workspace root is shared storage.  Keyed by the env process rank
        (usable before the process group exists)."""
        base = os.environ.get("TPUFRAME_LOCAL_SCRATCH") or os.path.join(
            tempfile.gettempdir(), "tpuframe_scratch"
        )
        rank = os.environ.get("TPUFRAME_PROCESS_ID") or os.environ.get("RANK", "0")
        return self._ensure(os.path.join(base, f"host{rank}", subdir))


def export_worker_env(
    credentials: Mapping[str, str], overwrite: bool = True
) -> None:
    """Export credentials into this process's env so spawned workers
    inherit them — the reference's ``DATABRICKS_HOST/TOKEN`` export for
    child re-auth (`setup/00_setup.py:86-92`).  Typical keys:
    ``MLFLOW_TRACKING_TOKEN``, ``MLFLOW_TRACKING_USERNAME/PASSWORD``,
    ``TPUFRAME_CP_TOKEN``.  Values never transit the pickled payload —
    env only, like the reference."""
    for key, value in credentials.items():
        if overwrite or key not in os.environ:
            os.environ[key] = str(value)
