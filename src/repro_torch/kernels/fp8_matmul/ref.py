"""Plain PyTorch version of the unfused FP8 GEMM (counterpart of
`repro.kernels.fp8_matmul.ref.fp8_matmul_ref`).

The reference upcasts the fp8 operands to bf16 and multiplies with f32
accumulation. Every fp8 value is exact in bf16 and in f32, and the product
of two of them is exact in f32, so an f32 product of the f32-upcast
operands computes the same sums; only the summation order can differ from
the kernel. On the card this needs TF32 off for f32 matmuls
(`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default).
"""
from __future__ import annotations

import torch


def fp8_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a: (M, K) fp8, b: (K, N) fp8 -> (M, N) out_dtype: the f32
    accumulator, then one cast."""
    return (a.float() @ b.float()).to(out_dtype)
