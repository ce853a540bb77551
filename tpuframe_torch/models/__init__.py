"""Models: the ResNet family, the transformer LM, and their weight interop."""

from tpuframe_torch.models.interop import (
    export_torch_resnet,
    export_torch_transformer,
    from_jax_variables,
    import_torch_resnet,
    import_torch_transformer,
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
from tpuframe_torch.models.transformer import Block, SelfAttention, TransformerLM

__all__ = [
    "BasicBlock",
    "Block",
    "Bottleneck",
    "ReplicaGroupedBatchNorm",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "SelfAttention",
    "TransformerLM",
    "export_torch_resnet",
    "export_torch_transformer",
    "from_jax_variables",
    "import_torch_resnet",
    "import_torch_transformer",
]
