"""The hand-written kernels (CUDA on a GPU tensor, plain PyTorch on a CPU
tensor; each entry point also the ``torch.library`` op ``ievm::<name>``,
``_lib.custom_op``) and layout helpers."""

from .conv3x3 import conv3x3_s1_int8, conv3x3_s1_int8_plain
from .dwconv_int8 import depthwise_conv_int8, depthwise_conv_int8_plain
from .fused_dense import dense_gelu, dense_gelu_plain
from .fused_mbconv import fused_mbconv_block, fused_mbconv_block_plain, to_device_packed
from .gconv_int8 import (
    GroupedInt8Weight,
    grouped_conv_int8,
    grouped_conv_int8_plain,
    pack_grouped_weight,
)
from .im2col import conv_int8_im2col, extract_patches_nhwc
from .int8_matmul import (
    PackedInt8Weight,
    dynamic_qparams,
    int8_matmul_requant,
    int8_matmul_requant_dynamic,
    int8_matmul_requant_dynamic_plain,
    int8_matmul_requant_plain,
    pack_weight,
)

__all__ = [
    "GroupedInt8Weight",
    "PackedInt8Weight",
    "conv3x3_s1_int8",
    "conv3x3_s1_int8_plain",
    "conv_int8_im2col",
    "dense_gelu",
    "depthwise_conv_int8",
    "depthwise_conv_int8_plain",
    "dense_gelu_plain",
    "dynamic_qparams",
    "extract_patches_nhwc",
    "fused_mbconv_block",
    "fused_mbconv_block_plain",
    "grouped_conv_int8",
    "grouped_conv_int8_plain",
    "int8_matmul_requant",
    "int8_matmul_requant_dynamic",
    "int8_matmul_requant_dynamic_plain",
    "int8_matmul_requant_plain",
    "pack_grouped_weight",
    "pack_weight",
    "to_device_packed",
]
