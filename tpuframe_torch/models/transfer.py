"""Frozen-backbone transfer-learning wrappers.

Port of ``tpuframe/models/transfer.py``: a headless backbone (e.g.
``ResNet50(num_classes=0)``), then ``Dropout(0.5)`` and a fresh ``Linear``
head sized to the dataset, the reference's inline wrapper
(``01_torch_distributor/02_cifar_torch_distributor_resnet.py:141-159``).
The parameters live under ``backbone.`` and ``head.``, as the JAX tree
keeps them under ``backbone`` and ``head``.

Freezing: the JAX package labels the parameter tree with
:func:`backbone_frozen_labels` and routes the frozen leaves to
``optax.set_to_zero`` through ``optax.multi_transform``.  The port takes
the reference's own route, ``requires_grad_(False)`` on every frozen
parameter (:func:`freeze`, from the same labels): autograd computes no
gradient for them, the train steps give them no zero gradient, and the
optimizers skip them, so a frozen parameter does not move at all: no
weight decay, no moment, no count (K4's stays at 0), and no state where
the optimizer's state is made for the trainable parameters only.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.models.transformer import Dropout

__all__ = ["TransferClassifier", "backbone_frozen_labels", "freeze"]


class TransferClassifier(nn.Module):
    """Backbone (headless) + Dropout + Linear head, float32 out.

    Args:
      backbone: a module mapping the batch to (N, C) features, with C in
        its ``num_features`` (flax infers C at ``init``; a torch
        ``Linear`` needs it when it is built), e.g.
        ``ResNet50(num_classes=0)``.
      num_classes: head width.
      dropout_rate: the head's dropout (flax ``Dropout``, drawn from
        ``dropout_generator`` in train mode).
      dtype: the head's compute dtype.
      device: where the head lives; None means ``cuda``.
      seed: seeds the head's init (LeCun-normal kernel, zero bias, flax's
        ``Dense`` defaults).
    """

    def __init__(self, backbone: nn.Module, num_classes: int, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        feature_dim = getattr(backbone, "num_features", None)
        if feature_dim is None:
            raise ValueError("the backbone must give its feature width as num_features")
        self.backbone = backbone
        self.head_drop = Dropout(dropout_rate)
        self.head = nn.Linear(int(feature_dim), num_classes, device=device)
        self.compute_dtype = dtype
        self.dropout = float(dropout_rate)
        self.dropout_generator: torch.Generator | None = None
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.head.weight.normal_(0.0, float(feature_dim) ** -0.5, generator=gen)
            self.head.bias.zero_()
        self.eval()

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """The head's and the backbone's compute dtype from now on."""
        self.compute_dtype = dtype
        setter = getattr(self.backbone, "set_compute_dtype", None)
        if setter is not None:
            setter(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        gen = self.dropout_generator if self.training else None
        y = self.head_drop(feats, gen).to(self.compute_dtype)
        dt = self.compute_dtype
        y = torch.nn.functional.linear(y, self.head.weight.to(dt), self.head.bias.to(dt))
        return y.to(torch.float32)


def backbone_frozen_labels(params: Any, frozen_keys: tuple = ("backbone",)) -> Any:
    """Label a TransferClassifier's parameters: ``"frozen"`` under
    ``frozen_keys``, ``"trainable"`` elsewhere.

    ``params`` is a nested mapping (the JAX tree's layout: the same labels
    as JAX's, leaf for leaf) or a module, whose parameters are grouped by
    the first part of their names: ``{"backbone": {"conv1.weight":
    "frozen", ...}, "head": {"weight": "trainable", "bias": ...}}``."""
    if isinstance(params, nn.Module):
        tree: dict = {}
        for name, _ in params.named_parameters():
            top, _, rest = name.partition(".")
            tree.setdefault(top, {})[rest] = None
        params = tree

    def label(key, sub):
        if isinstance(sub, Mapping):
            return {k: label(key, v) for k, v in sub.items()}
        return "frozen" if key in frozen_keys else "trainable"

    return {key: label(key, sub) for key, sub in params.items()}


def freeze(model: nn.Module, labels: Mapping[str, Any] | None = None) -> nn.Module:
    """``requires_grad_(False)`` on every parameter labelled ``"frozen"``
    (default labels: :func:`backbone_frozen_labels` of ``model``), and
    ``requires_grad_(True)`` on the rest: the port's
    ``optax.multi_transform({"trainable": tx, "frozen": set_to_zero()},
    labels)``.  ``labels`` has the module form of
    :func:`backbone_frozen_labels`.  Returns the model."""
    labels = backbone_frozen_labels(model) if labels is None else labels
    for name, p in model.named_parameters():
        top, _, rest = name.partition(".")
        p.requires_grad_(labels[top][rest] != "frozen")
    return model
