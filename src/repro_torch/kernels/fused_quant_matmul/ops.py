"""Public wrapper of the fused quantize-in-epilogue FP8 GEMM.

`fused_quant_matmul(a, b, scale, ...)` computes Q((a . b) / scale) to fp8
in layout `dims` ('nn' A@B, 'nt' A@B^T, 'tn' A^T@B) and optionally the
amax of the quantized output and its saturated/flushed fractions, as
`repro.kernels.fused_quant_matmul.ops.fused_quant_matmul` does.

Dispatch: CPU tensors take the plain version (ref.py); CUDA tensors launch
the hand-written Hopper kernel (csrc/fused_quant_matmul.cu) or raise —
there is no fallback. `fused_quant_matmul.launches` counts kernel launches,
and `fused_quant_matmul.launches_by_dims` counts them per layout.

Padding contract: the kernel takes dims that are multiples of its 64x64x64
tile; the wrapper zero-pads other shapes (operands and SR bits), the
epilogue masks the amax / counts to the logical (m, n), and the padded
region is sliced off — so results are invariant to the padding.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fp8_formats import FP8_DTYPES, format_of_dtype, get_format
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_quant_matmul import ref as _ref

TILE = 64
_FMT_ID = {"e4m3": 0, "e5m2": 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _pad2(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    pr, pc = (-x.shape[0]) % r, (-x.shape[1]) % c
    if pr or pc:
        if x.dtype in FP8_DTYPES:   # F.pad has no fp8 kernel: pad the bytes
            return F.pad(x.view(torch.uint8), (0, pc, 0, pr)).view(x.dtype)
        x = F.pad(x, (0, pc, 0, pr))
    return x


def aligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data starts on a 16-byte boundary (the
    kernels' vector loads), copied only when it does not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(a, b, rand8, scale, *, dims, out_format, rounding, saturate,
            lm, ln, with_counts=True):
    """Run the CUDA kernel on tile-aligned operands; returns (out, per-tile
    amax, per-tile saturated counts, per-tile flushed counts)."""
    m, n, k = _ref.gemm_shape(a.shape, b.shape, dims)
    if m % TILE or n % TILE or k % TILE:
        raise ValueError(f"kernel dims must be multiples of {TILE}: {m, n, k}")
    dev = a.device
    out = torch.empty((m, n), dtype=get_format(out_format).dtype, device=dev)
    gm, gn = m // TILE, n // TILE
    amax = torch.empty((gm, gn), dtype=torch.float32, device=dev)
    sat = torch.empty((gm, gn), dtype=torch.float32, device=dev)
    flush = torch.empty((gm, gn), dtype=torch.float32, device=dev)
    # Element (m, k) of A and (k, n) of B through strides: no transposed copy.
    if dims == "tn":
        sam, sak = 1, m
    else:
        sam, sak = k, 1
    if dims == "nt":
        sbk, sbn = 1, k
    else:
        sbk, sbn = n, 1
    lib = _build.load("fused_quant_matmul")
    fn = lib.fqmm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # The range names the layout in a profiler trace (one kernel serves
    # all three).
    with torch.profiler.record_function(f"fused_quant_matmul.{dims}"):
        err = fn(a.data_ptr(), b.data_ptr(),
                 rand8.data_ptr() if rand8 is not None else None,
                 out.data_ptr(), amax.data_ptr(), sat.data_ptr(),
                 flush.data_ptr(), m, n, k, sam, sak, sbk, sbn,
                 _FMT_ID[format_of_dtype(a.dtype).name],
                 _FMT_ID[format_of_dtype(b.dtype).name], _FMT_ID[out_format],
                 int(rounding == "sr"), int(saturate),
                 float(np.float32(scale)), lm, ln, int(with_counts),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_quant_matmul")
    fused_quant_matmul.launches += 1
    fused_quant_matmul.launches_by_dims[dims] += 1
    return out, amax, sat, flush


def fused_quant_matmul(a: torch.Tensor, b: torch.Tensor, scale=1.0, *,
                       dims: str = "nn", out_format: str = "e5m2",
                       rounding: str = "sr", saturate: bool = True,
                       rand8: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       with_amax: bool = False, with_counts: bool = False):
    """Q((a . b) / scale) -> (M, N) fp8 in `out_format`.

    a, b: 2-D fp8 payloads (either fp8 dtype each) laid out per `dims`.
    scale: host f32 scalar. rand8: (M, N) uint8 SR bits (rounding='sr');
    drawn from `generator` when absent. with_amax=True returns (out, amax)
    with the amax of the fp8 output in grid units (callers multiply by
    their own scale for real units).
    with_counts=True (requires with_amax) returns (out, amax, health) with
    health = (2,) f32 [saturated_fraction, flushed_fraction]."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("fused_quant_matmul takes 2-D operands")
    if a.dtype not in FP8_DTYPES or b.dtype not in FP8_DTYPES:
        raise TypeError(f"fp8 operands required, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if with_counts and not with_amax:
        raise ValueError("with_counts requires with_amax")
    m, n, _ = _ref.gemm_shape(a.shape, b.shape, dims)
    if rounding == "sr":
        if rand8 is None:
            rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8,
                                  device=a.device, generator=generator)
        if rand8.shape != (m, n) or rand8.dtype != torch.uint8:
            raise ValueError(f"rand8 must be ({m}, {n}) uint8")
    elif rounding != "rne":
        raise ValueError(f"unknown rounding {rounding!r}")
    else:
        rand8 = None
    dev = a.device.type
    if dev == "cpu":
        out, amax, counts = _ref.fused_quant_matmul_ref(
            a, b, rand8, scale, dims=dims, out_format=out_format,
            rounding=rounding, saturate=saturate)
    elif dev == "cuda":
        ap = aligned(_pad2(a, TILE, TILE))
        bp = aligned(_pad2(b, TILE, TILE))
        rp = None if rand8 is None else aligned(_pad2(rand8, TILE, TILE))
        out, t_amax, t_sat, t_flush = _launch(
            ap, bp, rp, scale, dims=dims, out_format=out_format,
            rounding=rounding, saturate=saturate, lm=m, ln=n,
            with_counts=with_counts)
        if out.shape != (m, n):
            out = out[:m, :n].contiguous()
        amax = torch.amax(t_amax)
        counts = torch.stack([t_sat.sum(), t_flush.sum()]) \
            if with_counts else None
    else:
        raise ValueError(f"fused_quant_matmul: unsupported device {a.device}")
    if not with_amax:
        return out
    if with_counts:
        # A device divisor: torch turns `tensor / python_number` on CUDA into
        # a multiply by the reciprocal, which is not the reference's f32
        # division.
        return out, amax, counts / torch.tensor(float(m * n),
                                                device=counts.device)
    return out, amax


fused_quant_matmul.launches = 0
fused_quant_matmul.launches_by_dims = {d: 0 for d in _ref.DIMS}


def reset_launches():
    """Set every launch count of the GEMM kernel to 0."""
    fused_quant_matmul.launches = 0
    for d in fused_quant_matmul.launches_by_dims:
        fused_quant_matmul.launches_by_dims[d] = 0
