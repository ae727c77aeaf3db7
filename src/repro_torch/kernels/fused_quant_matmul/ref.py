"""Plain PyTorch version of the fused quantize-in-epilogue FP8 GEMM.

The unfused composition the CUDA kernel is held against: an f32-accumulated
product of the fp8 operands (each product of two fp8 values is exact in f32,
so only the summation order can differ from the kernel), then the Q node
`Q(acc * (1/scale))`, then the observations the kernel's epilogue takes —
the amax of the quantized output in grid units and the saturated / flushed
counts, all masked to the logical (m, n) region.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.quantize import quantize_rne, sr_fp8_via_f16

DIMS = ("nn", "nt", "tn")


def gemm_shape(a_shape, b_shape, dims: str) -> Tuple[int, int, int]:
    """(M, N, C): logical output dims and contraction dim of a `dims` GEMM:
    nn A(M,C)@B(C,N), nt A(M,C)@B(N,C)^T, tn A(C,M)^T@B(C,N)."""
    if dims == "nn":
        (m, c), (c2, n) = a_shape, b_shape
    elif dims == "nt":
        (m, c), (n, c2) = a_shape, b_shape
    elif dims == "tn":
        (c, m), (c2, n) = a_shape, b_shape
    else:
        raise ValueError(f"unknown dims {dims!r}; expected one of {DIMS}")
    if c != c2:
        raise ValueError(f"contraction mismatch {a_shape} x {b_shape} ({dims})")
    return m, n, c


def dot_f32(a: torch.Tensor, b: torch.Tensor, dims: str) -> torch.Tensor:
    """f32-accumulated product of fp8 operands in layout `dims`."""
    af, bf = a.float(), b.float()
    if dims == "nt":
        bf = bf.t()
    elif dims == "tn":
        af = af.t()
    return af @ bf


def quantize_tile(y: torch.Tensor, rand8: Optional[torch.Tensor], fmt_name: str,
                  rounding: str, saturate: bool) -> torch.Tensor:
    fmt = get_format(fmt_name)
    if rounding == "rne":
        return quantize_rne(y, fmt, saturate=saturate)
    return sr_fp8_via_f16(y, rand8, fmt, saturate=saturate)


def fused_quant_matmul_ref(a, b, rand8, scale, *, dims: str = "nn",
                           out_format: str = "e5m2", rounding: str = "sr",
                           saturate: bool = True, logical_mn=None):
    """Returns (q (M,N) fp8, amax_grid 0-d f32, counts (2,) f32 [saturated,
    flushed]) with the observations masked to `logical_mn` (default all)."""
    fmt = get_format(out_format)
    acc = dot_f32(a, b, dims)
    inv = np.float32(1.0) / np.float32(scale)
    q = quantize_tile(acc * float(inv), rand8, out_format, rounding, saturate)
    qf = q.float()
    m, n = q.shape
    lm, ln = logical_mn if logical_mn is not None else (m, n)
    mask = torch.zeros((m, n), dtype=torch.bool, device=q.device)
    mask[:lm, :ln] = True
    mag = torch.where(mask, qf.abs(), torch.zeros_like(qf))
    amax = mag.max() if mag.numel() else torch.zeros((), device=q.device)
    sat = (qf.abs() >= fmt.max_normal) | ~torch.isfinite(qf)
    flush = qf.abs() < fmt.min_normal
    counts = torch.stack([(mask & sat).sum(), (mask & flush).sum()]).float()
    return q, amax, counts
