"""int8 kernels (CUDA on a GPU tensor, plain PyTorch on a CPU tensor) and layout helpers."""

from .conv3x3 import conv3x3_s1_int8, conv3x3_s1_int8_plain
from .im2col import conv_int8_im2col, extract_patches_nhwc
from .int8_matmul import (
    PackedInt8Weight,
    int8_matmul_requant,
    int8_matmul_requant_plain,
    pack_weight,
)

__all__ = [
    "PackedInt8Weight",
    "conv3x3_s1_int8",
    "conv3x3_s1_int8_plain",
    "conv_int8_im2col",
    "extract_patches_nhwc",
    "int8_matmul_requant",
    "int8_matmul_requant_plain",
    "pack_weight",
]
