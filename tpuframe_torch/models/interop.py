"""Weights between the JAX package's trees, torchvision, and the port.

The port's own copy of ``tpuframe/models/interop.py`` (numpy only), plus
:func:`from_jax_variables`, which carries a JAX ``{"params",
"batch_stats"}`` tree into the ``state_dict`` of the matching port model:
the ResNet (module names torchvision's, so that ``state_dict`` is a
torchvision one), the ``TransformerLM`` or the ``ViT`` (module names the
JAX tree's), ``MnistNet`` (the reference ``Net``'s names) and
``TransferClassifier`` (its backbone's names under ``backbone.``, the head
under ``head.``).

Layout conversions:

- Conv: torch OIHW <-> JAX HWIO
- Linear: torch (out, in) <-> JAX (in, out)
- BatchNorm: weight/bias <-> scale/bias (params); running_mean/var <->
  mean/var (batch_stats)
- Embedding: ``weight`` <-> ``embedding``; LayerNorm ``scale``/``bias``
  keep their names
- ViT: ``patch_embed`` kernel HWIO <-> weight OIHW; ``pos_embed`` and
  ``cls_token`` (parameters of the model itself) as they are
- MoE (``block{i}/moe``): the ``router`` Dense kernel (D, E) <-> the
  router's (E, D) weight; ``w_in`` (E, D, H) and ``w_out`` (E, H, D) keep
  the flax layout in the port, so they carry across as they are and
  ``parallel.sharding.flax_orders`` lists no order for them (a plan's
  ``moe_rules`` spec names their dims directly)
- MnistNet: flax flattens the (4, 4, 20) maps NHWC before ``fc1``, the
  port NCHW (the reference ``Net``'s ``view(-1, 320)``), so ``fc1``'s 320
  input rows are permuted from (h, w, c) to (c, h, w) order
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "export_torch_mnist",
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


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """A flax kernel in the torch weight's layout: a Dense (in, out) ->
    (out, in), a layer-stacked Dense (L, in, out) -> (L, out, in), a Conv
    HWIO -> OIHW."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.transpose(0, 2, 1) if arr.ndim == 3 else arr.T


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
                arr = _kernel_to_torch(arr)
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
                arr = (arr.transpose(2, 3, 1, 0) if arr.ndim == 4
                       else arr.transpose(0, 2, 1) if arr.ndim == 3 else arr.T)
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[attr] = arr
    return {"params": params}


_MNIST_LAYERS = {"conv1", "conv2", "fc1", "fc2"}


def export_torch_mnist(variables: Mapping[str, Any]) -> dict:
    """A JAX ``MnistNet`` tree as the port's (and the reference ``Net``'s)
    ``state_dict`` of numpy arrays: conv kernels HWIO -> OIHW, dense
    kernels transposed, ``fc1``'s input rows from flax's NHWC flatten order
    to NCHW."""
    params = variables.get("params", variables)
    out: dict[str, np.ndarray] = {}
    for layer in sorted(_MNIST_LAYERS):
        kernel = np.asarray(params[layer]["kernel"])
        if kernel.ndim == 4:
            kernel = kernel.transpose(3, 2, 0, 1)
        else:
            if layer == "fc1":  # rows (h, w, c) of the (4, 4, 20) maps -> (c, h, w)
                h, w, c = 4, 4, kernel.shape[0] // 16
                kernel = kernel.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1)
            kernel = kernel.T
        out[f"{layer}.weight"] = kernel
        out[f"{layer}.bias"] = np.asarray(params[layer]["bias"])
    return out


def _tensors(arrays: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(np.array(v))) for k, v in arrays.items()}


def _resnet_state(variables_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    state = _tensors(export_torch_resnet(variables_np))
    for k in [k for k in state if k.endswith(".running_var")]:
        state[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def from_jax_variables(variables_np: Mapping[str, Any], model: Any = None
                       ) -> dict[str, torch.Tensor]:
    """The JAX tree (numpy leaves) as the matching port model's
    ``state_dict`` of CPU tensors: a ``TransformerLM`` tree (it has an
    ``embed`` table), a ``ViT`` tree (it has a ``patch_embed``) or a
    ``PipelinedTransformerLM`` tree (``embed_head`` and the layer-stacked
    ``blocks``) by :func:`export_torch_transformer`; an ``MnistNet`` tree by
    :func:`export_torch_mnist`; a ``TransferClassifier`` tree (``backbone``
    and ``head``) as its backbone's under ``backbone.`` and the head's
    ``weight`` and ``bias``; a ResNet's ``{"params", "batch_stats"}`` with
    torchvision names and a zero ``num_batches_tracked`` beside every
    BatchNorm.  Load it with ``model.load_state_dict(...)``.

    The JAX tree holds whole parameters under any plan.  ``model``, a port
    model a plan split (``create_train_state(..., plan=)``), makes each
    entry it holds a shard of this rank's shard (``Mesh.local_slice``)."""
    if model is not None and getattr(model, "tp_layout", None):
        full = from_jax_variables(variables_np)
        return {k: model.tp_mesh.local_slice(v, model.tp_layout[k]).contiguous()
                if k in model.tp_layout else v for k, v in full.items()}
    params = variables_np.get("params", {})
    if "embed" in params or "patch_embed" in params or "embed_head" in params:
        return _tensors(export_torch_transformer(variables_np))
    if set(params) == _MNIST_LAYERS:
        return _tensors(export_torch_mnist(variables_np))
    if "backbone" in params and "head" in params:
        backbone = {"params": params["backbone"],
                    "batch_stats": variables_np.get("batch_stats", {}).get("backbone", {})}
        state = {f"backbone.{k}": v for k, v in from_jax_variables(backbone).items()}
        state["head.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.array(params["head"]["kernel"]).T))
        state["head.bias"] = torch.from_numpy(np.array(params["head"]["bias"]))
        return state
    return _resnet_state(variables_np)


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
