from .attention import flash_attention, flash_attention_reference, flash_fwd, flash_fwd_plain
from .cuda_kernels import KERNELS
from .quant import (dequantize_int8, quantize_int8_global, quantize_int8_reference,
                    quantize_int8_residual)
from .topk import MAX_K, matmul_topk, matmul_topk_reference

__all__ = [
    "KERNELS",
    "MAX_K",
    "dequantize_int8",
    "flash_attention",
    "flash_attention_reference",
    "flash_fwd",
    "flash_fwd_plain",
    "matmul_topk",
    "matmul_topk_reference",
    "quantize_int8_global",
    "quantize_int8_reference",
    "quantize_int8_residual",
]
