"""Public wrapper of the unfused FP8 GEMM (counterpart of
`repro.kernels.fp8_matmul.ops.fp8_matmul`).

`fp8_matmul(a, b, out_dtype)` computes a (M, K) @ b (K, N) from fp8
operands (either fp8 dtype each) with f32 accumulation, returned as f32 or
bf16. CPU tensors take the plain version (ref.py); CUDA tensors launch the
hand-written Hopper kernel (the plain-store epilogue of
csrc/fused_quant_matmul.cu, entry `fp8mm_launch`) or raise — there is no
fallback. `fp8_matmul.launches` counts kernel launches.

Like the reference's `_pad_to`, the wrapper zero-pads the operands to the
kernel's 64x64x64 tile (zero padding is exact for a matmul) and slices the
result back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fp8_formats import FP8_DTYPES, format_of_dtype
from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_matmul import ref as _ref
from repro_torch.kernels.fused_quant_matmul.ops import TILE, _pad2, aligned

_FMT_ID = {"e4m3": 0, "e5m2": 1}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    if m % TILE or n % TILE or k % TILE:
        raise ValueError(f"kernel dims must be multiples of {TILE}: {m, k, n}")
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
                 int(out_dtype == torch.bfloat16),
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "fp8_matmul")
    fp8_matmul.launches += 1
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
    m, n = a.shape[0], b.shape[1]
    out = _launch(aligned(_pad2(a, TILE, TILE)), aligned(_pad2(b, TILE, TILE)),
                  out_dtype)
    return out if out.shape == (m, n) else out[:m, :n].contiguous()


fp8_matmul.launches = 0


def reset_launches():
    fp8_matmul.launches = 0
