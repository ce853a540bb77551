"""Models: the ResNet family, the transformer LM and its MoE MLP, ViT, the
MNIST CNN, the frozen-backbone wrapper, and their weight interop."""

from tpuframe_torch.models.cnn import MnistNet
from tpuframe_torch.models.interop import (
    export_torch_mnist,
    export_torch_resnet,
    export_torch_transformer,
    from_jax_variables,
    import_torch_resnet,
    import_torch_transformer,
)
from tpuframe_torch.models.moe import MoEMLP, moe_rules
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
from tpuframe_torch.models.transfer import TransferClassifier, backbone_frozen_labels, freeze
from tpuframe_torch.models.transformer import (
    Block,
    Dropout,
    SelfAttention,
    TransformerLM,
    transformer_tp_rules,
)
from tpuframe_torch.models.vit import ViT, ViT_B16, ViT_S16, vit_tp_rules

__all__ = [
    "BasicBlock",
    "Block",
    "Bottleneck",
    "Dropout",
    "MnistNet",
    "MoEMLP",
    "ReplicaGroupedBatchNorm",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "SelfAttention",
    "TransferClassifier",
    "TransformerLM",
    "ViT",
    "ViT_B16",
    "ViT_S16",
    "backbone_frozen_labels",
    "export_torch_mnist",
    "export_torch_resnet",
    "export_torch_transformer",
    "freeze",
    "from_jax_variables",
    "import_torch_resnet",
    "import_torch_transformer",
    "moe_rules",
    "transformer_tp_rules",
    "vit_tp_rules",
]
