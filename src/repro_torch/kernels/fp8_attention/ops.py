"""Public wrapper of the fused FP8 flash-attention forward.

`fp8_attention_fwd(q8, k8, v8, seed, scal, ...)` is the counterpart of
`repro.kernels.fp8_attention.ops.fp8_attention_fwd`: fp8 payloads in,
bf16 output plus the scalar S / P amaxes (grid units, masked to the
attended region) out.

Dispatch: CPU tensors take the plain version (ref.py); CUDA tensors launch
the hand-written Hopper kernel (csrc/fp8_attention_fwd.cu) or raise.
`fp8_attention_fwd.launches` counts kernel launches.

Padding contract (the reference's): the head dim is zero-padded to 128 and
the kv length to a multiple of 128 (slot positions pad with -1, validity
with 0); padded columns are masked and padded head lanes contribute exact
zeros, so outputs and amaxes do not depend on the padding.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fp8_formats import FP8_DTYPES, format_of_dtype
from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_attention import ref as _ref
from repro_torch.kernels.fused_quant_matmul.ops import aligned

LANE = _ref.LANE
HEAD_DIM = 128
_FMT_ID = {"e4m3": 0, "e5m2": 1}
_MASK_ID = {"causal": 0, "full": 1, "kv": 2, "chunk": 3}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 18
             + [ctypes.c_float] * 4 + [ctypes.c_uint, ctypes.c_void_p])


def _pad_bytes(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x.view(torch.uint8), widths).view(x.dtype)


def _launch(q8, k8, v8, kvm, chunk_pos, seed, scal, *, mask_mode, window,
            q_len, s_len, fmt_s, fmt_p, rounding_s, rounding_p, saturate_s,
            saturate_p):
    b_, h_, q_rows, d = q8.shape
    hkv, s_pad = k8.shape[1], k8.shape[2]
    if d != HEAD_DIM or s_pad % LANE:
        raise ValueError(f"kernel needs D={HEAD_DIM}, S % {LANE} == 0")
    dev = q8.device
    o = torch.empty((b_, h_, q_rows, d), dtype=torch.bfloat16, device=dev)
    nq = -(-q_rows // 64)
    amax_s = torch.empty((b_, h_, nq), dtype=torch.float32, device=dev)
    amax_p = torch.empty((b_, h_, nq), dtype=torch.float32, device=dev)
    lib = _build.load("fp8_attention_fwd")
    fn = lib.attn_fwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    f_s, s_s, f_p, f_o = (float(np.float32(x)) for x in scal)
    err = fn(q8.data_ptr(), k8.data_ptr(), v8.data_ptr(),
             kvm.data_ptr() if kvm is not None else None,
             chunk_pos.data_ptr() if chunk_pos is not None else None,
             o.data_ptr(), amax_s.data_ptr(), amax_p.data_ptr(),
             b_, h_, hkv, q_rows, s_pad, q_len, s_len, _MASK_ID[mask_mode],
             window, _FMT_ID[format_of_dtype(q8.dtype).name],
             _FMT_ID[format_of_dtype(k8.dtype).name],
             _FMT_ID[format_of_dtype(v8.dtype).name], _FMT_ID[fmt_s],
             _FMT_ID[fmt_p], int(rounding_s == "sr"), int(rounding_p == "sr"),
             int(saturate_s), int(saturate_p), f_s, s_s, f_p, f_o,
             int(seed) & 0xFFFFFFFF, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fp8_attention_fwd")
    fp8_attention_fwd.launches += 1
    return o, amax_s, amax_p


def fp8_attention_fwd(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      seed, scal, *, mask_mode: str = "causal",
                      window: int = 0, kv_mask=None, chunk_pos=None,
                      fmt_s: str = "e5m2", fmt_p: str = "e5m2",
                      rounding_s: str = "sr", rounding_p: str = "sr",
                      saturate_s: bool = True, saturate_p: bool = True):
    """Fused FP8 attention forward on logical payloads.

    q8 (B,H,Q,D); k8/v8 (B,Hkv,S,D), any fp8 dtypes; seed: int (SR hash);
    scal: 4 host f32 [f_s, s_s, f_p, f_o]. kv_mask (B,S): validity for
    mask_mode='kv', int slot positions (-1 = hole) for 'chunk', which also
    takes chunk_pos (B,2) int [start, n_valid]. Returns (o (B,H,Q,D) bf16,
    amax_s, amax_p) with 0-d f32 amaxes in grid units."""
    if mask_mode not in _MASK_ID:
        raise ValueError(f"unknown mask mode {mask_mode!r}")
    for x in (q8, k8, v8):
        if x.dtype not in FP8_DTYPES or x.dim() != 4:
            raise TypeError(f"fp8 (B,H,S,D) payloads required, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != q8.device:
            raise ValueError("q8/k8/v8 on different devices")
    b_, h_, q_rows, d = q8.shape
    hkv, s_len = k8.shape[1], k8.shape[2]
    if h_ % hkv or k8.shape != v8.shape or k8.shape[0] != b_ \
            or k8.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q8.shape)} "
                         f"k{tuple(k8.shape)} v{tuple(v8.shape)}")
    if mask_mode in ("kv", "chunk") and kv_mask is None:
        raise ValueError(f"mask_mode={mask_mode!r} needs kv_mask")
    if mask_mode == "chunk" and chunk_pos is None:
        raise ValueError("mask_mode='chunk' needs chunk_pos")
    kw = dict(fmt_s=fmt_s, fmt_p=fmt_p, rounding_s=rounding_s,
              rounding_p=rounding_p, saturate_s=saturate_s,
              saturate_p=saturate_p)
    dev = q8.device.type
    if dev == "cpu":
        return _ref.fp8_attention_fwd_ref(
            q8, k8, v8, seed, scal, mask_mode=mask_mode, window=window,
            kv_mask=kv_mask, chunk_pos=chunk_pos, **kw)
    if dev != "cuda":
        raise ValueError(f"fp8_attention_fwd: unsupported device {q8.device}")
    if d > HEAD_DIM:
        raise ValueError(f"head dim {d} > {HEAD_DIM} is not supported")
    qp = aligned(_pad_bytes(q8.contiguous(), 3, HEAD_DIM))
    kp = aligned(_pad_bytes(_pad_bytes(k8.contiguous(), 3, HEAD_DIM), 2, LANE))
    vp = aligned(_pad_bytes(_pad_bytes(v8.contiguous(), 3, HEAD_DIM), 2, LANE))
    kvm = cpos = None
    pad = kp.shape[2] - s_len
    if mask_mode == "kv":
        kvm = F.pad(torch.as_tensor(kv_mask, device=q8.device).to(torch.int32),
                    (0, pad), value=0).contiguous()
    elif mask_mode == "chunk":
        # Slot positions pad with -1: 0 is a valid position.
        kvm = F.pad(torch.as_tensor(kv_mask, device=q8.device).to(torch.int32),
                    (0, pad), value=-1).contiguous()
        cpos = torch.as_tensor(chunk_pos, device=q8.device).to(
            torch.int32).contiguous()
    o, amax_s, amax_p = _launch(
        qp, kp, vp, kvm, cpos, seed, scal, mask_mode=mask_mode,
        window=window, q_len=q_rows, s_len=s_len, **kw)
    if d != HEAD_DIM:
        o = o[..., :d].contiguous()
    return o, torch.amax(amax_s), torch.amax(amax_p)


fp8_attention_fwd.launches = 0
