"""Layered configuration tree with ``"auto"`` deferred resolution.

The port's own copy of ``tpuframe/core/config.py`` (stdlib and ``yaml``
only; the port imports nothing of the JAX package): the same layering,
the same ``TPUFRAME_*`` env overlay, dotted paths and ``resolve_auto``.

The reference stacks four config layers (SURVEY.md §5 "Config / flag system"):
a user YAML file (``UPDATE_local_config.yaml:1-8``), globals
exported by `%run` of `setup/00_setup.py:15-23`, per-example
literal dicts, and env vars re-exported into child processes
(`01_torch_distributor/02_cifar_torch_distributor_resnet.py:184-189`).
DeepSpeed configs additionally use the string ``"auto"`` for values resolved at
engine-init time (`02_deepspeed/deepspeed_config.py:16`).

The package collapses all of that into one structure: :class:`Config` — a nested
attribute-access mapping with deep merge, YAML round-trip, environment-variable
overlay, and explicit ``"auto"`` resolution hooks.  No Spark, no ``%run``
globals: everything is an explicit object.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Callable, Iterator, Mapping

import yaml

__all__ = ["AUTO", "Config", "load_config"]

#: Sentinel value meaning "resolve me later from runtime context".
AUTO = "auto"

_ENV_SEP = "__"  # TPUFRAME_TRAIN__BATCH_SIZE=128 -> train.batch_size = 128


def _wrap(value: Any) -> Any:
    """Recursively convert plain mappings into Config nodes."""
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


class Config(dict):
    """Nested dict with attribute access, deep merge and dotted-path access.

    >>> cfg = Config({"train": {"batch_size": 128}})
    >>> cfg.train.batch_size
    128
    >>> cfg.get_path("train.batch_size")
    128
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Config has no key {key!r}; available: {sorted(self.keys())}"
            ) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    # -- construction -----------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str | os.PathLike) -> "Config":
        """Load a YAML file into a Config (empty file -> empty Config)."""
        with open(path) as f:
            data = yaml.safe_load(f)
        if data is None:
            data = {}
        if not isinstance(data, Mapping):
            raise TypeError(f"top level of {path} must be a mapping, got {type(data)}")
        return cls(data)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls(json.loads(text))

    # -- merge / overlay --------------------------------------------------
    def merged(self, *overlays: Mapping[str, Any]) -> "Config":
        """Return a new Config: self deep-merged with overlays (later wins)."""
        out = copy.deepcopy(self)
        for overlay in overlays:
            _deep_merge(out, overlay)
        return out

    def overlay_env(self, prefix: str = "TPUFRAME_") -> "Config":
        """Overlay env vars: ``TPUFRAME_TRAIN__BATCH_SIZE=128`` -> train.batch_size.

        Values are parsed with ``yaml.safe_load`` so numbers/bools/null come
        through typed.  Mirrors the reference's env-var config channel into
        child processes (SURVEY.md §5), but typed and scoped by prefix.
        """
        overlay: dict[str, Any] = {}
        for name, raw in os.environ.items():
            if not name.startswith(prefix):
                continue
            dotted = name[len(prefix):].lower().replace(_ENV_SEP, ".")
            try:
                value = yaml.safe_load(raw)
            except yaml.YAMLError:
                value = raw
            _set_dotted(overlay, dotted, value)
        return self.merged(overlay)

    # -- dotted path access ----------------------------------------------
    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            elif (
                isinstance(node, (list, tuple))
                and part.isdigit()
                and int(part) < len(node)
            ):
                node = node[int(part)]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
                continue
            nxt = node.get(part)
            if not isinstance(nxt, (Config, list)):
                nxt = Config()
                node[part] = nxt
            node = node[part]
        if isinstance(node, list):
            node[int(parts[-1])] = _wrap(value)
        else:
            node[parts[-1]] = value

    def flat(self) -> dict[str, Any]:
        """Flatten into ``{"a.b.c": value}`` (for logging params, MLflow-style)."""
        out: dict[str, Any] = {}
        for dotted, value in _walk(self):
            out[dotted] = value
        return out

    # -- auto resolution --------------------------------------------------
    def auto_paths(self) -> list[str]:
        """Dotted paths whose value is the ``"auto"`` sentinel."""
        return [dotted for dotted, value in _walk(self) if value == AUTO]

    def resolve_auto(
        self,
        resolvers: Mapping[str, Callable[["Config"], Any]],
        strict: bool = True,
    ) -> "Config":
        """Return a new Config with every ``"auto"`` leaf replaced.

        ``resolvers`` maps dotted paths (exact or ``fnmatch``-style ``*``
        patterns) to callables receiving the full config.  With ``strict``,
        unresolved ``"auto"`` leaves raise — configs never reach the train
        step half-resolved (unlike the reference, where "auto" only means
        something if DeepSpeed is actually engaged, which it never is:
        `02_deepspeed/01_cifar_deepspeed_resnet.py:108`).
        """
        from fnmatch import fnmatchcase

        out = copy.deepcopy(self)
        unresolved = []
        for dotted in out.auto_paths():
            resolver = resolvers.get(dotted)
            if resolver is None:
                for pattern, candidate in resolvers.items():
                    if fnmatchcase(dotted, pattern):
                        resolver = candidate
                        break
            if resolver is None:
                unresolved.append(dotted)
                continue
            out.set_path(dotted, resolver(out))
        if unresolved and strict:
            raise ValueError(f"unresolved 'auto' config values at: {unresolved}")
        return out

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return _unwrap(self)

    def to_yaml(self, path: str | os.PathLike | None = None) -> str:
        text = yaml.safe_dump(self.to_dict(), sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _deep_merge(dst: Config, src: Mapping[str, Any]) -> None:
    for key, value in src.items():
        if (
            key in dst
            and isinstance(dst[key], Mapping)
            and isinstance(value, Mapping)
        ):
            _deep_merge(dst[key], value)
        else:
            dst[key] = value


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for i, part in enumerate(parts[:-1]):
        node = node.setdefault(part, {})
        if not isinstance(node, dict):
            raise ValueError(
                f"config path conflict at {'.'.join(parts[: i + 1])!r}: "
                f"cannot set {dotted!r} because a scalar already lives there"
            )
    node[parts[-1]] = value


def _walk(node: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(node, Mapping):
        items: Iterator[tuple[Any, Any]] = iter(node.items())
    elif isinstance(node, (list, tuple)):
        items = iter(enumerate(node))
    else:
        yield prefix.rstrip("."), node
        return
    for key, value in items:
        dotted = f"{prefix}{key}"
        if isinstance(value, (Mapping, list, tuple)):
            yield from _walk(value, f"{dotted}.")
        else:
            yield dotted, value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return value


def load_config(
    path: str | os.PathLike | None = None,
    overrides: Mapping[str, Any] | None = None,
    env_prefix: str = "TPUFRAME_",
) -> Config:
    """Standard layering: defaults file -> overrides dict -> environment.

    The reference's layering, minus Spark (`setup/00_setup.py:15-23` reads
    `local_config.yaml` then exports globals; examples then override inline).
    """
    cfg = Config.from_yaml(path) if path is not None else Config()
    if overrides:
        cfg = cfg.merged(overrides)
    if env_prefix:
        cfg = cfg.overlay_env(env_prefix)
    return cfg
