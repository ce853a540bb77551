"""Weights between the JAX package's trees, torchvision, and the port.

The port's own copy of ``tpuframe/models/interop.py`` (numpy only), plus
:func:`from_jax_variables`, which carries a JAX ``{"params",
"batch_stats"}`` tree into the ``state_dict`` of the matching port model:
the ResNet (module names torchvision's, so that ``state_dict`` is a
torchvision one), the ``TransformerLM`` or the ``ViT`` (module names the
JAX tree's).

Layout conversions:

- Conv: torch OIHW <-> JAX HWIO
- Linear: torch (out, in) <-> JAX (in, out)
- BatchNorm: weight/bias <-> scale/bias (params); running_mean/var <->
  mean/var (batch_stats)
- Embedding: ``weight`` <-> ``embedding``; LayerNorm ``scale``/``bias``
  keep their names
- ViT: ``patch_embed`` kernel HWIO <-> weight OIHW; ``pos_embed`` and
  ``cls_token`` (parameters of the model itself) as they are
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "export_torch_resnet",
    "export_torch_transformer",
    "from_jax_variables",
    "import_torch_resnet",
    "import_torch_transformer",
]


def import_torch_resnet(state_dict: Mapping[str, Any]) -> dict:
    """Convert a torchvision-format ResNet state_dict to the JAX tree.

    Values may be tensors or numpy arrays.  Returns ``{"params": ...,
    "batch_stats": ...}`` in the layout of ``tpuframe.models.ResNet*``.
    """
    params: dict = {}
    batch_stats: dict = {}

    def to_np(v: Any) -> np.ndarray:
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def put(tree: dict, path: list[str], leaf: np.ndarray) -> None:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        value = to_np(value)
        parts = key.split(".")
        # torchvision names: conv1.weight, bn1.weight, layer1.0.conv2.weight,
        # layer1.0.downsample.{0,1}.weight, fc.{weight,bias}
        if parts[0].startswith("layer"):
            stage, block_idx = parts[0], parts[1]
            module = f"{stage}_{block_idx}"
            rest = parts[2:]
            if rest[0] == "downsample":
                sub = "downsample_conv" if rest[1] == "0" else "downsample_bn"
                rest = [sub] + rest[2:]
            path = [module] + rest
        else:
            path = parts

        *mods, attr = path
        leaf_name, is_stat, array = _convert_leaf(mods[-1], attr, value)
        if is_stat:
            put(batch_stats, mods + [leaf_name], array)
        else:
            put(params, mods + [leaf_name], array)

    return {"params": params, "batch_stats": batch_stats}


def export_torch_resnet(variables: Mapping[str, Any]) -> dict:
    """Convert a JAX ResNet tree to a torchvision-format state_dict of
    numpy arrays.  Exact inverse of :func:`import_torch_resnet`, up to the
    dropped ``num_batches_tracked`` counters."""
    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}

    def torch_module_name(mod: str) -> str:
        # layer{i}_{j} -> layer{i}.{j}; downsample_{conv,bn} -> downsample.{0,1}
        m = re.fullmatch(r"(layer\d+)_(\d+)", mod)
        return f"{m.group(1)}.{m.group(2)}" if m else mod

    def walk(tree: Mapping[str, Any], prefix: list[str], stats: bool) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [name], stats)
                continue
            arr = np.asarray(value)
            mods = [torch_module_name(m) for m in prefix]
            if mods and mods[-1] == "downsample_conv":
                mods[-1] = "downsample.0"
            elif mods and mods[-1] == "downsample_bn":
                mods[-1] = "downsample.1"
            module = ".".join(mods)
            is_bn = bool(re.search(r"bn|downsample\.1", module))
            if stats:
                attr = {"mean": "running_mean", "var": "running_var"}[name]
            elif is_bn:
                attr = {"scale": "weight", "bias": "bias"}[name]
            elif name == "kernel":
                attr = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            else:
                attr = name
            out[f"{module}.{attr}"] = arr

    walk(params, [], stats=False)
    walk(batch_stats, [], stats=True)
    return out


def export_torch_transformer(variables: Mapping[str, Any]) -> dict:
    """A JAX ``TransformerLM`` or ``ViT`` tree (``{"params": ...}``) as the
    port model's ``state_dict`` of numpy arrays: ``Dense`` kernels (in, out)
    transposed into ``weight`` (out, in), the ``Conv`` kernel HWIO into
    ``weight`` OIHW, ``Embed`` tables into ``weight``, everything else
    (biases, LayerNorm ``scale``/``bias``, ``pos_embed`` and ``cls_token``
    arrays) as it is."""
    out: dict[str, np.ndarray] = {}

    def walk(tree: Mapping[str, Any], prefix: list[str]) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [name])
                continue
            arr = np.asarray(value)
            attr = {"kernel": "weight", "embedding": "weight"}.get(name, name)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[".".join(prefix + [attr])] = arr

    walk(variables.get("params", variables), [])
    return out


def import_torch_transformer(state_dict: Mapping[str, Any]) -> dict:
    """The port ``TransformerLM``'s or ``ViT``'s ``state_dict`` as the JAX
    tree ``{"params": ...}``; inverse of :func:`export_torch_transformer`."""
    params: dict = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        *mods, attr = key.split(".")
        if attr == "weight":
            attr = "embedding" if mods[-1] in ("embed", "pos_embed") else "kernel"
            if attr == "kernel":
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[attr] = arr
    return {"params": params}


def from_jax_variables(variables_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX tree (numpy leaves) as the matching port model's
    ``state_dict`` of CPU tensors: a ``TransformerLM`` tree (it has an
    ``embed`` table) or a ``ViT`` tree (it has a ``patch_embed``) by
    :func:`export_torch_transformer`; a ResNet's
    ``{"params", "batch_stats"}`` with torchvision names and a zero
    ``num_batches_tracked`` beside every BatchNorm.  Load it with
    ``model.load_state_dict(...)``."""
    params = variables_np.get("params", {})
    if "embed" in params or "patch_embed" in params:
        return {k: torch.from_numpy(np.ascontiguousarray(np.array(v)))
                for k, v in export_torch_transformer(variables_np).items()}
    state = {
        k: torch.from_numpy(np.ascontiguousarray(np.array(v)))
        for k, v in export_torch_resnet(variables_np).items()
    }
    for k in [k for k in state if k.endswith(".running_var")]:
        state[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def _convert_leaf(module: str, attr: str, value: np.ndarray):
    """Map one torch leaf to (JAX name, goes to batch_stats, converted array)."""
    is_bn = bool(re.search(r"bn|downsample_bn", module))
    if is_bn:
        mapping = {
            "weight": ("scale", False),
            "bias": ("bias", False),
            "running_mean": ("mean", True),
            "running_var": ("var", True),
        }
        name, is_stat = mapping[attr]
        return name, is_stat, value
    if value.ndim == 4:  # conv kernel OIHW -> HWIO
        return "kernel", False, value.transpose(2, 3, 1, 0)
    if value.ndim == 2:  # linear (out, in) -> (in, out)
        return "kernel", False, value.T
    return attr if attr != "weight" else "kernel", False, value
