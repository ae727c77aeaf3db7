"""Public wrapper of the fused quantize-in-epilogue FP8 GEMM.

`fused_quant_matmul(a, b, scale, ...)` computes Q((a . b) / scale) to fp8
in layout `dims` ('nn' A@B, 'nt' A@B^T, 'tn' A^T@B) and optionally the
amax of the quantized output and its saturated/flushed fractions, as
`repro.kernels.fused_quant_matmul.ops.fused_quant_matmul` does.

Dispatch: CPU tensors take the plain version (ref.py); CUDA tensors launch
the hand-written Hopper kernel (csrc/fused_quant_matmul.cu) or raise —
there is no fallback. `fused_quant_matmul.launches` counts kernel launches,
and `fused_quant_matmul.launches_by_dims` counts them per layout.

Padding contract: the kernel takes M a multiple of 128, N a multiple of
its tile width (128 or 256, picked by `gemm_tile` from the shape alone) and
K a multiple of 64; the wrapper zero-pads other shapes (operands and SR
bits), the epilogue masks the amax / counts to the logical (m, n), and the
padded region is sliced off — so results are invariant to the padding.
`fused_quant_matmul.launches_by_tile` counts launches per tile width.
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

BM, BK = 128, 64          # the kernel's tile rows and k-step
TILE_WIDTHS = (128, 256)  # its tile widths (columns), one variant each
SMS = 132                 # streaming multiprocessors of an H100 SXM
# The kernel's variants, in the order of csrc's fqmm_variant_info:
# (epilogue, layout, tile width).
GEMM_VARIANTS = tuple((out, dims, bn)
                      for out, layouts in (("fp8", ("nn", "nt", "tn")),
                                           ("f32", ("nn",)), ("bf16", ("nn",)))
                      for dims in layouts for bn in TILE_WIDTHS)
_FMT_ID = {"e4m3": 0, "e5m2": 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def gemm_tile(m: int, n: int, k: int) -> int:
    """Tile width of the GEMM kernel for an (m, n) output and depth k.

    128x128 tiles run two to an SM, so one tile's epilogue overlaps the
    other's mainloop; 128x256 tiles run one to an SM and move fewer bytes a
    product. 256 wins only where its grid fits the SMs in one wave while
    the 128-wide grid overloads them, and k is deep enough (4096 or more)
    that the epilogue is a small share. Unchanged by the padding it implies.
    """
    rows, kp = -(-m // BM), -(-k // BK) * BK
    one_wave = rows * -(-n // 256) <= SMS < rows * -(-n // 128)
    return 256 if one_wave and kp >= 4096 else 128


def operand_pads(dims: str, bn: int):
    """(rows, cols) multiples that A, B and the (m, n) SR bits are padded
    to, for layout `dims` and tile width `bn`."""
    a = (BK, BM) if dims == "tn" else (BM, BK)
    b = (bn, BK) if dims == "nt" else (BK, bn)
    return a, b, (BM, bn)


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
    bn = gemm_tile(m, n, k)
    if m % BM or n % bn or k % BK:
        raise ValueError(f"kernel dims must be multiples of ({BM}, {bn}, "
                         f"{BK}): {m, n, k}")
    dev = a.device
    out = torch.empty((m, n), dtype=get_format(out_format).dtype, device=dev)
    gm, gn = m // BM, n // bn
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
                 float(np.float32(scale)), lm, ln, int(with_counts), bn,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_quant_matmul")
    fused_quant_matmul.launches += 1
    fused_quant_matmul.launches_by_dims[dims] += 1
    fused_quant_matmul.launches_by_tile[bn] += 1
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
    m, n, k = _ref.gemm_shape(a.shape, b.shape, dims)
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
        pa, pb, pr = operand_pads(dims, gemm_tile(m, n, k))
        ap = aligned(_pad2(a, *pa))
        bp = aligned(_pad2(b, *pb))
        rp = None if rand8 is None else aligned(_pad2(rand8, *pr))
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
        # division. Filled on the device: a host-to-device copy would make
        # the host wait for the device.
        return out, amax, counts / torch.full((), float(m * n),
                                              device=counts.device)
    return out, amax


fused_quant_matmul.launches = 0
fused_quant_matmul.launches_by_dims = {d: 0 for d in _ref.DIMS}
fused_quant_matmul.launches_by_tile = {bn: 0 for bn in TILE_WIDTHS}


def reset_launches():
    """Set every launch count of the GEMM kernel to 0."""
    fused_quant_matmul.launches = 0
    for counts in (fused_quant_matmul.launches_by_dims,
                   fused_quant_matmul.launches_by_tile):
        for key in counts:
            counts[key] = 0
