"""Models: the ResNet family and its weight interop."""

from tpuframe_torch.models.interop import (
    export_torch_resnet,
    from_jax_variables,
    import_torch_resnet,
)
from tpuframe_torch.models.norm import ReplicaGroupedBatchNorm
from tpuframe_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
)

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ReplicaGroupedBatchNorm",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "export_torch_resnet",
    "from_jax_variables",
    "import_torch_resnet",
]
