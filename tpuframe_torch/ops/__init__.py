"""Ops with a hand-written Hopper kernel beside a plain PyTorch version."""

from tpuframe_torch.ops.blockwise_attention import (
    blockwise_attention,
    blockwise_attention_bwd_dkv,
    blockwise_attention_bwd_dq,
    blockwise_attention_bwd_reference,
    blockwise_attention_fwd,
    blockwise_attention_reference,
)
from tpuframe_torch.ops.build import launch_floor
from tpuframe_torch.ops.cross_entropy import (
    cross_entropy_bwd,
    cross_entropy_bwd_reference,
    cross_entropy_fwd,
    cross_entropy_reference,
    cross_entropy_stats_reference,
    fused_cross_entropy,
)
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.ops.fused_adamw import (
    FusedAdamW,
    fused_adamw,
    fused_adamw_multi_update_,
    fused_adamw_update,
    fused_adamw_update_,
    fused_adamw_update_reference,
)
from tpuframe_torch.ops.layer_norm import (
    FusedLayerNorm,
    fused_layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
)
from tpuframe_torch.ops.moe_gating import moe_dispatch_combine, moe_dispatch_combine_reference
from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference
from tpuframe_torch.ops.quant_wire import (
    bucket_abs_max,
    bucket_abs_max_reference,
    quant_decode,
    quant_decode_reference,
    quant_encode,
    quant_encode_reference,
)
from tpuframe_torch.ops.ring_attention import (
    attention_reference,
    ring_attention,
    ring_attention_local,
)
from tpuframe_torch.ops.ulysses import ulysses_attention, ulysses_attention_local

__all__ = [
    "FusedAdamW",
    "FusedLayerNorm",
    "attention_reference",
    "blockwise_attention",
    "blockwise_attention_bwd_dkv",
    "blockwise_attention_bwd_dq",
    "blockwise_attention_bwd_reference",
    "blockwise_attention_fwd",
    "blockwise_attention_reference",
    "bucket_abs_max",
    "bucket_abs_max_reference",
    "cross_entropy_bwd",
    "cross_entropy_bwd_reference",
    "cross_entropy_fwd",
    "cross_entropy_reference",
    "cross_entropy_stats_reference",
    "fused_adamw",
    "fused_adamw_multi_update_",
    "fused_adamw_update",
    "fused_adamw_update_",
    "fused_adamw_update_reference",
    "fused_cross_entropy",
    "fused_layer_norm",
    "launch_floor",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "layer_norm_fwd",
    "layer_norm_reference",
    "moe_dispatch_combine",
    "moe_dispatch_combine_reference",
    "normalize_images",
    "normalize_images_reference",
    "quant_decode",
    "quant_decode_reference",
    "quant_encode",
    "quant_encode_reference",
    "ring_attention",
    "ring_attention_local",
    "ulysses_attention",
    "ulysses_attention_local",
    "use_kernel",
]
