"""Public wrapper of the unfused FP8 GEMM (counterpart of
`repro.kernels.fp8_matmul.ops.fp8_matmul`).

`fp8_matmul(a, b, out_dtype)` computes a (M, K) @ b (K, N) from fp8
operands (either fp8 dtype each) with f32 accumulation, returned as f32 or
bf16. CPU tensors take the plain version (ref.py); CUDA tensors launch the
hand-written Hopper kernel (the plain-store epilogue of
csrc/fused_quant_matmul.cu, entry `fp8mm_launch`) or raise — there is no
fallback. `fp8_matmul.launches` counts kernel launches.

Like the reference's `_pad_to`, the wrapper zero-pads the operands to the
kernel's tile (M to 128, K to 64, N to the tile width that
`fused_quant_matmul.ops.gemm_tile` picks from the shape; zero padding is
exact for a matmul) and slices the result back.
`fp8_matmul.launches_by_tile` counts launches per tile width.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fp8_formats import FP8_DTYPES, format_of_dtype
from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_matmul import ref as _ref
from repro_torch.kernels.fused_quant_matmul.ops import (
    BK, BM, TILE_WIDTHS, _pad2, aligned, gemm_tile, operand_pads)

_FMT_ID = {"e4m3": 0, "e5m2": 1}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    bn = gemm_tile(m, n, k)
    if m % BM or n % bn or k % BK:
        raise ValueError(f"kernel dims must be multiples of ({BM}, {BK}, "
                         f"{bn}): {m, k, n}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.load("fused_quant_matmul").fp8mm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # The range names this kernel in a profiler trace (it shares its
    # symbol with the fused GEMM's).
    with torch.profiler.record_function("fp8_matmul"):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                 _FMT_ID[format_of_dtype(a.dtype).name],
                 _FMT_ID[format_of_dtype(b.dtype).name],
                 int(out_dtype == torch.bfloat16), bn,
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "fp8_matmul")
    fp8_matmul.launches += 1
    fp8_matmul.launches_by_tile[bn] += 1
    return out


def fp8_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a: (M, K) fp8, b: (K, N) fp8 -> (M, N) out_dtype (f32 or bf16)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fp8_matmul takes (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype not in FP8_DTYPES or b.dtype not in FP8_DTYPES:
        raise TypeError(f"fp8 operands required, got {a.dtype}, {b.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return _ref.fp8_matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fp8_matmul: unsupported device {a.device}")
    (m, k), n = a.shape, b.shape[1]
    pa, pb, _ = operand_pads("nn", gemm_tile(m, n, k))
    out = _launch(aligned(_pad2(a, *pa)), aligned(_pad2(b, *pb)), out_dtype)
    return out if out.shape == (m, n) else out[:m, :n].contiguous()


fp8_matmul.launches = 0
fp8_matmul.launches_by_tile = {bn: 0 for bn in TILE_WIDTHS}


def reset_launches():
    fp8_matmul.launches = 0
    for bn in fp8_matmul.launches_by_tile:
        fp8_matmul.launches_by_tile[bn] = 0
