"""Models: the ResNet family, the transformer LM, ViT, and their weight
interop."""

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
from tpuframe_torch.models.transformer import Block, Dropout, SelfAttention, TransformerLM
from tpuframe_torch.models.vit import ViT, ViT_B16, ViT_S16, vit_tp_rules

__all__ = [
    "BasicBlock",
    "Block",
    "Bottleneck",
    "Dropout",
    "ReplicaGroupedBatchNorm",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "SelfAttention",
    "TransformerLM",
    "ViT",
    "ViT_B16",
    "ViT_S16",
    "export_torch_resnet",
    "export_torch_transformer",
    "from_jax_variables",
    "import_torch_resnet",
    "import_torch_transformer",
    "vit_tp_rules",
]
