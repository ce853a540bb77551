"""Checkpointer for the port's ``TrainState`` on ``torch.distributed.checkpoint``.

Port of ``tpuframe/ckpt/checkpoint.py``: the same methods and semantics,
with DCP (``dcp.save``, ``dcp.load``, ``dcp.async_save``) where the JAX
package has orbax.  A step lands in ``<directory>/<step>/``, laid out as
the JAX package lays it out, so either package's stdlib readers
(``ckpt.meta``) read the other's directories:

- ``state/``: the tensors, as DCP writes them (``.metadata`` and one
  ``__<rank>_0.distcp`` a writing rank);
- ``meta/metadata``: the JSON ``{"meta", "metrics", "topology",
  "health"}``;
- ``_CHECKPOINT_METADATA``: the commit marker.

A save is staged in ``<step>.orbax-checkpoint-tmp-0/`` (the staging name
the readers already skip), its marker written once the data is on disk
(DCP syncs its files), then the directory is renamed to ``<step>``: a
digit directory without a marker is a save that died, torn, never a save
in flight.  The tensor data is each package's own; restoring a JAX
checkpoint into the port, or the reverse, is not supported.

What is saved is :meth:`TrainState.state_dict`: the model's parameters and
buffers, the optimizer's state, ``step``, ``updates``, the health
sentinel's tensors, the generator's state, and the compressed wire's
residuals ``comms`` when there are any.  A restore copies into the live
tensors in place, so they keep their device, dtype and address.

The residuals differ by rank: each rank holds its own ``(1, n_buckets,
bucket_elems)`` row.  DCP keeps one copy of a tensor that every rank saves
under one key, so each rank saves its row under its own key (``comms/<key>/
<rank>``), and the topology manifest records the global ``(world, ...)``
shape.  A restore at the same world takes each rank's own row; at another
world it folds the rows (:func:`_fold_comms`), as the JAX package does; a
checkpoint without residuals, or with another bucket layout, leaves the
live ones.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import threading
import time
import warnings
from typing import Any, Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from tpuframe_torch.ckpt.meta import (  # noqa: F401  (re-exports, as the JAX module's)
    COMMIT_MARKERS,
    _read_meta_doc,
    healthy_steps,
    is_committed,
    is_healthy,
    latest_healthy_step,
    latest_step,
    quarantine_torn_steps,
    read_health,
    read_manifest,
    rollback_to_last_healthy,
    valid_steps,
)
from tpuframe_torch.fault.health import _env_int
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "Checkpointer",
    "best_checkpoint_path",
    "load_pytree",
    "save_pytree",
    "topology_manifest",
]

_MARKER = COMMIT_MARKERS[0]
_STAGING = ".orbax-checkpoint-tmp-0"

# a world of one passes no_dist itself; DCP warns on every such call
warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or "
                        "uninitialized", category=UserWarning)


def _backoff_delay(attempt: int, *, base_s: float = 1.0, max_s: float = 60.0) -> float:
    """Full-jitter exponential backoff (attempt counts from 1):
    ``uniform(0, min(max_s, base_s * 2^(attempt-1)))``.  The port's copy of
    ``tpuframe/fault/supervisor.py`` ``backoff_delay``; the supervisor
    itself comes with the fault plane."""
    if attempt < 1:
        raise ValueError(f"attempt counts from 1, got {attempt}")
    return random.uniform(0.0, min(float(max_s), float(base_s) * (2.0 ** (attempt - 1))))


def _wired() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _wired() else 0


def _world() -> int:
    return dist.get_world_size() if _wired() else 1


def _state_data(state: Any) -> dict:
    """The saveable nested dict of a ``TrainState`` (or a mapping, passed
    through)."""
    if isinstance(state, Mapping):
        return dict(state)
    return state.state_dict()


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of a nested mapping, paths ``a/b/c``."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# -- topology manifests -------------------------------------------------------


def _plan_signature(plan: Any) -> str:
    """Stable short digest of a plan's policy and topology (the port's
    counterpart of the JAX ``ParallelPlan.signature``, over the fields the
    port's plan has)."""
    payload = {
        "mesh": sorted((str(k), int(v)) for k, v in plan.mesh.shape.items()),
        "zero_stage": plan.zero_stage,
        "data_axes": list(plan.data_axes),
        "offload": bool(plan.offload_optimizer),
    }
    if plan.comms_groups is not None and plan.comms_groups != 1:
        payload["comms_groups"] = int(plan.comms_groups)
    if plan.comms_fused:
        payload["comms_fused"] = True
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:12]


def topology_manifest(state: Any, plan: Any = None) -> dict:
    """The topology manifest of a live state: ``version`` 1, the mesh axes
    (the plan's, else one data axis over the world), ``world_size``,
    ``process_count``, the plan's signature and ZeRO stage when a plan is
    given, and per tensor leaf (paths of :meth:`TrainState.state_dict`, as
    ``model/fc.weight``) its logical shape, dtype and partition spec.  Every
    leaf is replicated (spec ``[]``) except the residuals ``comms/<key>``,
    split by rank over the data axes: their shape is the global
    ``(world, n_buckets, bucket_elems)``."""
    world = _world()
    mesh = ({str(k): int(v) for k, v in plan.mesh.shape.items()} if plan is not None
            else {"data": world})
    data_axes = list(getattr(plan, "data_axes", ("data",)))
    leaves: dict[str, dict] = {}
    for path, leaf in _leaves(_state_data(state)):
        if not torch.is_tensor(leaf):
            continue
        shape, spec = [int(d) for d in leaf.shape], []
        if path.startswith("comms/"):
            shape, spec = [world] + shape[1:], [data_axes]
        leaves[path] = {"shape": shape, "dtype": _dtype_name(leaf.dtype), "spec": spec}
    return {
        "version": 1,
        "mesh_axes": mesh,
        "world_size": world,
        "process_count": world,
        "plan_signature": _plan_signature(plan) if plan is not None else None,
        "zero_stage": getattr(plan, "zero_stage", None),
        "leaves": leaves,
    }


def _comms_restore_action(template: dict, manifest: dict | None):
    """How the saved residuals (``comms``) map onto the template, as in the
    JAX package:

    - ``(None, {})``: nothing special (no comms in the template, no
      manifest, or the same global shapes);
    - ``("reset", {})``: the checkpoint has no residual, or its bucket
      layout (trailing dims) changed: keep the template's;
    - ``("fold", saved)``: the same keys and bucket layout at another world
      size: load the saved rows and fold them onto this world.
    """
    if "comms" not in template or manifest is None:
        return None, {}
    saved = {k.split("/", 1)[1]: rec for k, rec in (manifest.get("leaves") or {}).items()
             if k.startswith("comms/")}
    world = _world()
    tmpl_shapes = {k: (world,) + tuple(int(d) for d in v.shape[1:])
                   for k, v in template["comms"].items()}
    saved_shapes = {k: tuple(rec["shape"]) for k, rec in saved.items()}
    if saved_shapes == tmpl_shapes:
        return None, {}
    if not saved:
        return "reset", {}
    if set(saved_shapes) == set(tmpl_shapes) and all(
            saved_shapes[k][1:] == tmpl_shapes[k][1:] for k in saved_shapes):
        return "fold", saved
    return "reset", {}


def _fold_comms(restored: Mapping[str, torch.Tensor], to_world: int, tele, *,
                step: int) -> dict[str, torch.Tensor]:
    """Fold residuals of global shape ``(from_world, n, e)`` onto
    ``to_world`` rows: old row i's deferred quantization error lands on the
    row that inherits its group (``np.array_split`` grouping; a grow
    spreads zeros onto the new rows), each group sum scaled by ``to_world /
    from_world`` so the mean correction the next step owes is kept (the
    JAX ``_fold_comms``, in the same numpy arithmetic).  Returns CPU
    float tensors of shape ``(to_world, n, e)``."""
    out = {}
    from_w = None
    for key, arr in restored.items():
        host = arr.detach().cpu().numpy()
        from_w = host.shape[0]
        groups = np.array_split(np.arange(from_w), to_world)
        scale = np.float32(to_world / from_w)
        folded = np.stack([host[idx].sum(axis=0) * scale if len(idx)
                           else np.zeros(host.shape[1:], host.dtype) for idx in groups])
        out[key] = torch.from_numpy(folded)
    tele.registry.counter("comms/ef_reshards").inc()
    tele.event("comms/ef_reshard", step=step, from_world=from_w, to_world=to_world,
               leaves=len(out))
    return out


def _dcp_view(data: dict) -> dict:
    """``data`` as it is handed to DCP: this rank's residual rows under
    rank-qualified keys."""
    if "comms" not in data:
        return data
    rank = str(_rank())
    return {**data, "comms": {k: {rank: v} for k, v in data["comms"].items()}}


def _write_json(path: str, doc: Any) -> None:
    with open(path, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Per-step checkpoints with retention, best tracking and resume.

    Args:
      directory: root dir; each save lands in ``<directory>/<step>/``.
      max_to_keep: keep this many newest steps (None: all); the best step
        is never pruned.
      best_metric: metric name (from the metrics passed to ``save``) that
        tracks the best step; None disables.
      best_mode: ``"min"`` (loss-like) or ``"max"`` (accuracy-like).
      async_save: write the data in a background thread (``dcp.async_save``)
        while the next steps run; the state is copied to host memory before
        ``save`` returns.  ``wait()``/``close()`` joins.  Across ranks DCP
        needs a process group with a CPU backend (gloo) for it.
    """

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int | None = 5,
                 best_metric: str | None = None, best_mode: str = "min",
                 async_save: bool = False):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._async_error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, state: Any, *, metrics: Mapping[str, float] | None = None,
             meta: Mapping[str, Any] | None = None, step: int | None = None,
             force: bool = False, plan: Any = None,
             health: Mapping[str, Any] | None = None) -> str:
        """Save ``state`` (with the metrics and meta JSON) at ``step``
        (default: its ``step``); returns the step's directory.

        Every process calls this.  The meta JSON carries the topology
        manifest (``plan=`` adds the plan's signature) and, when given, the
        health sentinel's stamp, which rollback selects on.  A committed
        step is not overwritten unless ``force``.

        OSError-class failures of the write are retried
        ``TPUFRAME_CKPT_SAVE_RETRIES`` times (default 2) with full-jitter
        backoff, each ticking ``ckpt/save_retries``.  With ``async_save`` an
        OSError surfacing later in ``wait()`` is past this window.
        """
        self.wait()  # one save in flight at a time
        data = _state_data(state)
        if step is None:
            step = int(data.get("step", 0) or 0)
        step = int(step)
        doc = {"meta": dict(meta or {}),
               "metrics": {k: float(v) for k, v in (metrics or {}).items()},
               "topology": topology_manifest(data, plan),
               "health": dict(health) if health else None}
        retries = _env_int("TPUFRAME_CKPT_SAVE_RETRIES", 2)
        tele = get_telemetry()
        # span + watchdog lease: a write wedged on a dead filesystem becomes
        # an attributed stall report under a watchdog
        with tele.span("ckpt/save", step=step), tele.guard("ckpt/save"):
            for attempt in range(retries + 1):
                try:
                    self._write(data, step, doc, force=force or attempt > 0)
                    break
                except OSError as e:
                    if attempt >= retries:
                        raise
                    delay = _backoff_delay(attempt + 1, base_s=0.25, max_s=4.0)
                    tele.registry.counter("ckpt/save_retries").inc()
                    tele.event("ckpt/save_retry", step=step, attempt=attempt + 1,
                               retries=retries, delay_s=round(delay, 3), error=repr(e)[:300])
                    time.sleep(delay)
        return os.path.join(self.directory, str(step))

    def _write(self, data: dict, step: int, doc: dict, *, force: bool) -> None:
        """One attempt: stage, write the tensors, then commit (in the
        background with ``async_save``)."""
        final = os.path.join(self.directory, str(step))
        if is_committed(final) and not force:
            raise ValueError(f"step {step} is already saved under {self.directory}; "
                             "force=True overwrites it")
        tmp = final + _STAGING
        if _rank() == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)  # a save that died before its commit
        if _world() > 1:
            dist.barrier()
        view, no_dist = _dcp_view(data), _world() == 1
        if not self.async_save:
            dcp.save(view, checkpoint_id=os.path.join(tmp, "state"), no_dist=no_dist)
            self._commit(tmp, final, doc)
            if _world() > 1:
                dist.barrier()  # every rank sees the step committed
            return
        response = dcp.async_save(view, checkpoint_id=os.path.join(tmp, "state"),
                                  no_dist=no_dist)
        staged = getattr(response, "staging_completion", None)
        if staged is not None:
            staged.result()  # the state is in host memory; the step may now change it
        upload = getattr(response, "upload_completion", response)

        def finish():
            try:
                upload.result()
                self._commit(tmp, final, doc)
            except BaseException as e:  # re-raised by wait()
                self._async_error = e

        self._pending = threading.Thread(target=finish, name=f"ckpt-commit-{step}", daemon=True)
        self._pending.start()

    def _commit(self, tmp: str, final: str, doc: dict) -> None:
        """On rank 0, once every rank's data is written: the meta JSON, the
        commit marker, then the rename into place; then retention."""
        if _rank() != 0:
            return
        os.makedirs(os.path.join(tmp, "meta"), exist_ok=True)
        _write_json(os.path.join(tmp, "meta", "metadata"), doc)
        _write_json(os.path.join(tmp, _MARKER), {"step": os.path.basename(final),
                                                 "commit_time_s": time.time()})
        _fsync_dir(tmp)
        old = None
        if os.path.exists(final):  # force: the old step goes once the new one is in place
            old = final + ".replaced"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        if old is not None:
            shutil.rmtree(old)
        self._prune()

    def _prune(self) -> None:
        """Keep the ``max_to_keep`` newest committed steps and the best."""
        if self.max_to_keep is None:
            return
        steps = valid_steps(self.directory)
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep > 0 else set()
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, state: Any, step: int | None = None, *, plan: Any = None,
                healthy_only: bool = False) -> tuple[Any, dict]:
        """Restore ``step`` (default: the newest committed, or with
        ``healthy_only`` the newest whose health stamp is absent or
        healthy) into ``state``; returns ``(state, meta)``.

        A ``TrainState`` is restored in place: every tensor lands in the
        live one, on its device with its dtype.  A mapping template is
        left as it is; a new dict is returned.  ``plan`` is accepted for
        the JAX signature: the port's plans replicate every leaf but the
        residuals, whose world size the manifest gives."""
        del plan
        self.wait()
        if step is None:
            step = self.latest_healthy_step() if healthy_only else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no {'healthy ' if healthy_only else ''}checkpoints "
                                    f"under {self.directory}")
        step = int(step)
        tele = get_telemetry()
        template = _state_data(state)
        if isinstance(state, Mapping):  # a new dict; the caller's tensors stay as they are
            template = _clone_tree(template)
        manifest = read_manifest(self.directory, step)
        action, saved = _comms_restore_action(template, manifest)
        request = {k: v for k, v in template.items() if k != "comms"}
        rank = str(_rank())
        if action is None and "comms" in template:
            request["comms"] = {k: {rank: v} for k, v in template["comms"].items()}
        elif action == "fold":
            request["comms"] = {
                k: {str(r): torch.empty((1,) + tuple(rec["shape"][1:]),
                                        dtype=getattr(torch, rec["dtype"]))
                    for r in range(rec["shape"][0])}
                for k, rec in saved.items()}
        elif action == "reset":
            tele.event("comms/ef_reset", step=step,
                       reason="checkpoint has no matching EF residual (pre-compression "
                              "history, or bucket layout changed)")
        with tele.span("ckpt/restore", step=step, reshard=action == "fold"), \
                tele.guard("ckpt/restore"):
            dcp.load(request, checkpoint_id=os.path.join(self.directory, str(step), "state"),
                     no_dist=_world() == 1)
        if "comms" in template:
            if action is None:
                request["comms"] = template["comms"]  # loaded in place
            elif action == "fold":
                full = {k: torch.cat([rows[str(r)] for r in range(len(rows))])
                        for k, rows in request["comms"].items()}
                folded = _fold_comms(full, _world(), tele, step=step)
                request["comms"] = {k: folded[k][int(rank):int(rank) + 1] for k in folded}
            else:
                request["comms"] = template["comms"]
        doc = _read_meta_doc(self.directory, step) or {}
        meta = dict(doc.get("meta") or {})
        if isinstance(state, Mapping):
            return request, meta
        return state.load_state_dict(request), meta

    def maybe_restore(self, state: Any, step: int | None = None, *,
                      plan: Any = None) -> tuple[Any, dict | None]:
        """Restore if any committed step exists, else pass through
        (auto-resume).  A directory holding only torn saves passes through
        too: a fresh start beats a crash loop on corrupt state."""
        if self.latest_step() is None:
            return state, None
        return self.restore(state, step, plan=plan)

    # -- queries -----------------------------------------------------------
    def latest_step(self) -> int | None:
        """Newest committed step (torn and in-flight saves do not count)."""
        return latest_step(self.directory)

    def best_step(self) -> int | None:
        """The committed step with the best ``best_metric`` (None when best
        tracking is off or no committed step has the metric)."""
        if not self.best_metric:
            return None
        scored = []
        for s in valid_steps(self.directory):
            v = self.metrics_for(s).get(self.best_metric)
            if v is not None:
                scored.append((v, s))
        if not scored:
            return None
        pick = min if self.best_mode == "min" else max
        return pick(scored, key=lambda vs: vs[0])[1]

    def all_steps(self) -> list[int]:
        """Committed steps only (the validity contract of ``latest_step``)."""
        return valid_steps(self.directory)

    def delete(self, step: int) -> None:
        """Remove one step's checkpoint (rank 0); a missing step is a
        no-op, any other failure propagates."""
        if _rank() == 0:
            try:
                shutil.rmtree(os.path.join(self.directory, str(int(step))))
            except FileNotFoundError:
                pass

    def latest_healthy_step(self) -> int | None:
        """Newest committed step whose health stamp is absent or healthy
        (the divergence-rollback target)."""
        return latest_healthy_step(self.directory)

    def manifest_for(self, step: int | None = None) -> dict | None:
        """The topology manifest of ``step`` (default latest committed)."""
        return read_manifest(self.directory, step)

    def health_for(self, step: int | None = None) -> dict | None:
        """The health stamp of ``step`` (default latest committed); None
        for a save without one."""
        return read_health(self.directory, step)

    def metrics_for(self, step: int) -> dict:
        """The metrics JSON saved with ``step``."""
        doc = _read_meta_doc(self.directory, step) or {}
        return dict(doc.get("metrics") or {})

    def wait(self) -> None:
        """Join an async save in flight; its error, if any, raises here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.join()
        error, self._async_error = self._async_error, None
        if error is not None:
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _clone_tree(tree: Mapping) -> dict:
    return {k: _clone_tree(v) if isinstance(v, Mapping)
            else v.clone() if torch.is_tensor(v) else v for k, v in tree.items()}


# -- single-file trees (the lightweight torch.save analogue) -------------------


def save_pytree(path: str | os.PathLike, tree: Any) -> str:
    """One-file save of a nested dict of tensors, copied to the host (the
    reference's ``torch.save(state_dict, path)`` for small artifacts).
    Rank-0 discipline is the caller's."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(t):
        if isinstance(t, Mapping):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu() if torch.is_tensor(t) else t

    with open(path, "wb") as f:
        torch.save(host(tree), f)
    return path


def load_pytree(path: str | os.PathLike, template: Any) -> Any:
    """Inverse of :func:`save_pytree`; ``template`` gives the structure,
    and each tensor lands on its template's device with its dtype."""
    with open(os.fspath(path), "rb") as f:
        data = torch.load(f, map_location="cpu", weights_only=True)

    def like(t, d):
        if isinstance(t, Mapping):
            return {k: like(t[k], d[k]) for k in t}
        return d.to(device=t.device, dtype=t.dtype) if torch.is_tensor(t) else d

    return like(template, data)


def best_checkpoint_path(ckpt: Checkpointer) -> str | None:
    """Path of the best checkpoint (None when best tracking is off/empty)."""
    step = ckpt.best_step()
    return None if step is None else os.path.join(ckpt.directory, str(step))
