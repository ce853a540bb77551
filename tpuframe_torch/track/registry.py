"""Model registry: named models, versions, aliases, latest-lookup, reload.

Port of ``tpuframe/track/registry.py``: the file registry, its layout
(``<tracking_uri>/models/<name>/version-<n>/``, ``meta.yaml``,
``aliases.yaml``) and ``models:/`` URIs as the JAX package writes and
reads them.  :func:`load_model` reads ``model.msgpack`` with the port's
``ckpt.load_pytree`` (``torch.save`` bytes, ``track.mlflow_store``).
:class:`HttpModelRegistry` is the JAX package's REST client of a stock
MLflow server's registry, over ``track.http_store``.

The reference registers Composer-trained models into Unity Catalog via
``MLFlowLogger(model_registry_uri='databricks-uc')`` and reloads them by
name (`03_composer/01_cifar_composer_resnet.ipynb:cell-16`).
The equivalent over the file store:

- **File registry** (:class:`ModelRegistry`): lives under
  ``<tracking_uri>/models/<name>/version-<n>/`` next to the mlruns file
  store.  ``register_model(run, "cifar-resnet")`` snapshots the run's
  logged model artifact (``Run.log_model``) into a new version — the
  registry is self-contained and survives run garbage-collection, like
  MLflow's registry store.  Aliases (``@champion``) and ``latest``
  resolve to versions; ``load()`` returns the model pytree.

``models:/name/3`` and ``models:/name@alias`` URIs resolve via
:func:`load_model`, mirroring mlflow's URI convention.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Any, Mapping

import yaml

from tpuframe_torch.track.mlflow_store import Run, _model_tree, _now_ms, _write_yaml

__all__ = ["HttpModelRegistry", "ModelRegistry", "ModelVersion", "load_model",
           "parse_models_uri"]

_MODELS_DIR = "models"
_VERSION_PREFIX = "version-"
_NAME_RE = re.compile(r"^[A-Za-z0-9][\w.\- ]*$")


@dataclass(frozen=True)
class ModelVersion:
    """One registered version: where it came from and where it lives."""

    name: str
    version: int
    run_id: str | None
    source: str  # artifact dir the version was registered from
    path: str  # registry-owned snapshot dir (file registry) or source URI
    created_ms: int
    aliases: tuple[str, ...] = ()


class ModelRegistry:
    """Named-model registry over the mlruns file store.

    >>> reg = ModelRegistry("./mlruns")
    >>> v1 = reg.register_model(run, "cifar-resnet")       # after log_model
    >>> reg.set_alias("cifar-resnet", "champion", v1.version)
    >>> tree = reg.load("cifar-resnet", "@champion", template=state)
    """

    def __init__(self, tracking_uri: str = "./mlruns"):
        self.root = os.path.abspath(str(tracking_uri).removeprefix("file://"))
        self.models_root = os.path.join(self.root, _MODELS_DIR)

    # -- write ---------------------------------------------------------------
    def register_model(
        self,
        run: Run | str,
        name: str,
        artifact_path: str = "model",
        *,
        tags: Mapping[str, Any] | None = None,
    ) -> ModelVersion:
        """Snapshot ``run``'s logged model artifact as the next version of
        ``name`` (creating the registered model on first use, like
        ``mlflow.register_model``).  ``run`` is a file-store :class:`Run`
        (post ``log_model``) or a model artifact directory path."""
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid model name {name!r}")
        if isinstance(run, str):
            source, run_id = run, None
        else:
            source, run_id = run.artifact_path(artifact_path), run.run_id
        if not os.path.isdir(source):
            raise FileNotFoundError(
                f"no model artifact at {source}; call run.log_model() first"
            )

        model_dir = os.path.join(self.models_root, name)
        os.makedirs(model_dir, exist_ok=True)
        meta = os.path.join(model_dir, "meta.yaml")
        if not os.path.exists(meta):
            _write_yaml(meta, {"name": name, "creation_time": _now_ms()})

        # claim the next free version atomically (mkdir is the lock)
        for _ in range(1000):
            version = self._max_version(name) + 1
            vdir = os.path.join(model_dir, f"{_VERSION_PREFIX}{version}")
            try:
                os.makedirs(vdir)
                break
            except FileExistsError:
                continue  # concurrent registrar claimed it; try the next
        else:  # pragma: no cover
            raise RuntimeError(f"could not claim a version slot for {name!r}")

        snapshot = os.path.join(vdir, "artifacts")
        shutil.copytree(source, snapshot)
        _write_yaml(
            os.path.join(vdir, "meta.yaml"),
            {
                "name": name,
                "version": version,
                "run_id": run_id,
                "source": source,
                "creation_time": _now_ms(),
                "utc_time_created": time.strftime(
                    "%Y-%m-%d %H:%M:%S", time.gmtime()
                ),
                **({"tags": dict(tags)} if tags else {}),
            },
        )
        return self.get(name, version)

    def set_alias(self, name: str, alias: str, version: int) -> None:
        """Point ``alias`` at ``version`` (reassigning steals it, like
        mlflow's set-registered-model-alias)."""
        self._require_version(name, version)
        aliases = self._aliases(name)
        aliases[str(alias)] = int(version)
        _write_yaml(os.path.join(self.models_root, name, "aliases.yaml"), aliases)

    def delete_alias(self, name: str, alias: str) -> None:
        aliases = self._aliases(name)
        aliases.pop(str(alias), None)
        _write_yaml(os.path.join(self.models_root, name, "aliases.yaml"), aliases)

    # -- read ----------------------------------------------------------------
    def list_models(self) -> list[str]:
        if not os.path.isdir(self.models_root):
            return []
        return sorted(
            e
            for e in os.listdir(self.models_root)
            if os.path.exists(os.path.join(self.models_root, e, "meta.yaml"))
        )

    def versions(self, name: str) -> list[int]:
        model_dir = os.path.join(self.models_root, name)
        if not os.path.isdir(model_dir):
            return []
        out = []
        for e in os.listdir(model_dir):
            if e.startswith(_VERSION_PREFIX) and os.path.exists(
                os.path.join(model_dir, e, "meta.yaml")
            ):
                out.append(int(e[len(_VERSION_PREFIX):]))
        return sorted(out)

    def get(self, name: str, ref: int | str = "latest") -> ModelVersion:
        """Resolve a version reference: an int, a numeric string,
        ``"latest"``, or ``"@alias"``."""
        version = self._resolve(name, ref)
        vdir = os.path.join(self.models_root, name, f"{_VERSION_PREFIX}{version}")
        with open(os.path.join(vdir, "meta.yaml")) as f:
            meta = yaml.safe_load(f)
        aliases = tuple(
            a for a, v in self._aliases(name).items() if v == version
        )
        return ModelVersion(
            name=name,
            version=version,
            run_id=meta.get("run_id"),
            source=meta.get("source", ""),
            path=os.path.join(vdir, "artifacts"),
            created_ms=int(meta.get("creation_time", 0)),
            aliases=aliases,
        )

    def latest(self, name: str) -> ModelVersion:
        return self.get(name, "latest")

    def load(self, name: str, ref: int | str = "latest", *, template: Any) -> Any:
        """Reload the registered model tree (``{"params", "batch_stats"}``
        as ``Run.log_model`` wrote it); ``template`` supplies the structure
        and each tensor's device and dtype: a ``TrainState``, a module, a
        matching dict or a bare params dict."""
        from tpuframe_torch.ckpt import load_pytree

        mv = self.get(name, ref)
        return load_pytree(os.path.join(mv.path, "model.msgpack"), _model_tree(template))

    # -- internals -----------------------------------------------------------
    def _max_version(self, name: str) -> int:
        vs = self.versions(name)
        return vs[-1] if vs else 0

    def _require_version(self, name: str, version: int) -> None:
        if version not in self.versions(name):
            raise KeyError(
                f"model {name!r} has no version {version}; have {self.versions(name)}"
            )

    def _aliases(self, name: str) -> dict[str, int]:
        path = os.path.join(self.models_root, name, "aliases.yaml")
        try:
            with open(path) as f:
                return {str(k): int(v) for k, v in (yaml.safe_load(f) or {}).items()}
        except FileNotFoundError:
            return {}

    def _resolve(self, name: str, ref: int | str) -> int:
        versions = self.versions(name)
        if not versions:
            raise KeyError(
                f"no registered model {name!r}; have {self.list_models()}"
            )
        if isinstance(ref, int):
            self._require_version(name, ref)
            return ref
        ref = str(ref)
        if ref == "latest":
            return versions[-1]
        if ref.startswith("@"):
            aliases = self._aliases(name)
            if ref[1:] not in aliases:
                raise KeyError(
                    f"model {name!r} has no alias {ref[1:]!r}; "
                    f"have {sorted(aliases)}"
                )
            return aliases[ref[1:]]
        if ref.isdigit():
            self._require_version(name, int(ref))
            return int(ref)
        raise ValueError(f"unresolvable version reference {ref!r}")


class HttpModelRegistry:
    """The same registry surface against a stock MLflow server (REST 2.0
    registered-models / model-versions / alias endpoints).

    The server owns version numbering and artifact storage; versions
    reference the run's artifact (``runs:/<run_id>/<path>``) rather than
    snapshotting, which is MLflow's own server-side behavior.
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        from tpuframe_torch.track.http_store import _Client

        self._client = _Client(base_url, timeout_s=timeout_s)

    def register_model(
        self, run: Any, name: str, artifact_path: str = "model"
    ) -> ModelVersion:
        from tpuframe_torch.track.http_store import HttpError

        try:
            self._client.call(
                "POST", "/api/2.0/mlflow/registered-models/create", {"name": name}
            )
        except HttpError as e:
            if e.status != 400:  # RESOURCE_ALREADY_EXISTS comes back as 400
                raise
        run_id = getattr(run, "run_id", str(run))
        source = f"runs:/{run_id}/{artifact_path}"
        out = self._client.call(
            "POST",
            "/api/2.0/mlflow/model-versions/create",
            {"name": name, "source": source, "run_id": run_id},
        )["model_version"]
        return ModelVersion(
            name=name,
            version=int(out["version"]),
            run_id=run_id,
            source=source,
            path=source,
            created_ms=int(out.get("creation_timestamp", 0)),
        )

    def set_alias(self, name: str, alias: str, version: int) -> None:
        self._client.call(
            "POST",
            "/api/2.0/mlflow/registered-models/alias",
            {"name": name, "alias": alias, "version": str(version)},
        )

    def get(self, name: str, ref: int | str = "latest") -> ModelVersion:
        ref = str(ref)
        if ref.startswith("@"):
            out = self._client.call(
                "GET",
                "/api/2.0/mlflow/registered-models/alias"
                f"?name={name}&alias={ref[1:]}",
            )["model_version"]
        elif ref == "latest":
            out = self._client.call(
                "POST",
                "/api/2.0/mlflow/registered-models/get-latest-versions",
                {"name": name},
            )["model_versions"][0]
        else:
            out = self._client.call(
                "GET",
                f"/api/2.0/mlflow/model-versions/get?name={name}&version={ref}",
            )["model_version"]
        return ModelVersion(
            name=name,
            version=int(out["version"]),
            run_id=out.get("run_id"),
            source=out.get("source", ""),
            path=out.get("source", ""),
            created_ms=int(out.get("creation_timestamp", 0)),
            aliases=tuple(out.get("aliases", ())),
        )

    def latest(self, name: str) -> ModelVersion:
        return self.get(name, "latest")


def parse_models_uri(uri: str) -> tuple[str, int | str]:
    """``models:/name/3`` -> ("name", 3); ``models:/name@alias`` ->
    ("name", "@alias"); ``models:/name`` -> ("name", "latest")."""
    if not uri.startswith("models:/"):
        raise ValueError(f"not a models:/ URI: {uri!r}")
    rest = uri[len("models:/"):]
    if "@" in rest:
        name, alias = rest.rsplit("@", 1)
        return name, f"@{alias}"
    if "/" in rest:
        name, version = rest.rsplit("/", 1)
        return name, int(version)
    return rest, "latest"


def load_model(uri: str, *, template: Any, tracking_uri: str = "./mlruns") -> Any:
    """Reload by registry URI — the mlflow ``models:/`` convention
    (`03_composer/01_cifar_composer_resnet.ipynb:cell-17`)."""
    name, ref = parse_models_uri(uri)
    return ModelRegistry(tracking_uri).load(name, ref, template=template)
