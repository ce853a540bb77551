"""Small CNNs for the MNIST-class examples.

Port of ``tpuframe/models/cnn.py``: the reference's MNIST ``Net`` (two 5x5
VALID convs of 10 and 20 channels, each followed by a 2x2 max pool, then
ReLU; ``Dropout2d`` on the second conv; a 320 -> 50 -> 10 MLP with dropout;
log-softmax out, which the reference trains with ``F.nll_loss``).

What matches the flax model exactly:

- Inputs are NHWC (N, 28, 28, 1), as the JAX model takes them; the convs
  run on ``x.permute(0, 3, 1, 2)``.
- The max pool comes before the ReLU, in both blocks.
- ``conv2_drop`` drops whole feature maps (flax ``broadcast_dims=(1, 2)``:
  one draw per image and channel), ``fc_drop`` single units; both at 0.5,
  kept values scaled by 2.  The masks come from ``dropout_generator``,
  which the train steps set for each step.
- Convs and dense layers run in ``dtype`` (inputs, weights and biases cast
  to it); the log-softmax runs in float32.

What differs: the port flattens the (N, 20, 4, 4) maps in NCHW order, the
reference torch ``Net``'s ``x.view(-1, 320)``, so a state dict of the
reference loads as it is; flax flattens NHWC.  ``models.interop`` permutes
``fc1``'s 320 input rows when it carries a JAX tree across.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.models.transformer import Dropout

__all__ = ["MnistNet"]


class MnistNet(nn.Module):
    """LeNet-style MNIST classifier returning float32 log-probabilities.

    Args:
      num_classes: width of ``fc2``.
      dtype: compute dtype of the convs and dense layers.
      device: where the parameters live; None means ``cuda``, which raises
        without CUDA.
      seed: seeds the parameter init (flax's defaults: LeCun-normal
        kernels, zero biases).
    """

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(1, 10, 5, device=device)
        self.conv2 = nn.Conv2d(10, 20, 5, device=device)
        self.conv2_drop = Dropout(0.5, broadcast_dims=(2, 3))
        self.fc1 = nn.Linear(320, 50, device=device)
        self.fc_drop = Dropout(0.5)
        self.fc2 = nn.Linear(50, num_classes, device=device)
        #: the highest dropout rate in the model; the train steps hand it a
        #: fresh generator for each train forward when it is above 0
        self.dropout = 0.5
        self.dropout_generator: torch.Generator | None = None
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.fc1, self.fc2):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=gen)
                m.bias.zero_()
        self.eval()

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Run the convs and dense layers in ``dtype`` from now on."""
        self.compute_dtype = dtype

    def _layer(self, fn, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return fn(x.to(dt), m.weight.to(dt), m.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 log-probabilities."""
        gen = self.dropout_generator if self.training else None
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(F.max_pool2d(self._layer(F.conv2d, self.conv1, x), 2, 2))
        x = self.conv2_drop(self._layer(F.conv2d, self.conv2, x), gen)
        x = F.relu(F.max_pool2d(x, 2, 2))
        x = x.reshape(x.shape[0], -1)  # (N, 320) for 28x28 inputs, NCHW order
        x = F.relu(self._layer(F.linear, self.fc1, x))
        x = self.fc_drop(x, gen)
        x = self._layer(F.linear, self.fc2, x)
        return torch.log_softmax(x.to(torch.float32), dim=-1)
