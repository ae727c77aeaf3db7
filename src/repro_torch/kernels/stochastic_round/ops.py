"""Public op of the stochastic-rounding kernels (counterpart of
`repro.kernels.stochastic_round.ops.stochastic_round_fp8`).

`stochastic_round_fp8(x, generator_or_seed, scale)` rounds x (f32 or bf16,
any rank) stochastically into fp8 after dividing by `scale` (a multiply by
its f32 reciprocal). The random bits come either

  * from a uint8 operand drawn from the caller's `torch.Generator`
    (`sr_quantize`, the reference's `sr_quantize_kernel`), or
  * with use_onchip_prng=True, from the kernel itself: a counter hash of
    the integer seed and each element's flat index (`sr_quantize_onchip`,
    the reference's `sr_quantize_kernel_onchip`; see ref.py).

CPU tensors take the plain versions (ref.py); CUDA tensors launch the
hand-written Hopper kernel (csrc/stochastic_round.cu) or raise — there is
no fallback. `sr_quantize.launches` and `sr_quantize_onchip.launches`
count the launches of the two variants.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_quant_matmul.ops import aligned
from repro_torch.kernels.stochastic_round import ref as _ref

_FMT_ID = {"e4m3": 0, "e5m2": 1}
_IN_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, fmt: str):
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"stochastic rounding takes f32 or bf16, got "
                        f"{x.dtype}")
    if fmt not in _FMT_ID:
        raise ValueError(f"fmt must be one of {tuple(_FMT_ID)}, got {fmt!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(x, rand8, seed: int, scale, fmt: str, saturate: bool):
    if x.numel() >= 1 << 32:
        raise ValueError("the kernel indexes at most 2^32 - 1 elements")
    x = aligned(x)
    out = torch.empty(x.shape, dtype=get_format(fmt).dtype, device=x.device)
    fn = _build.load("stochastic_round").sr_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
             None if rand8 is None else rand8.data_ptr(),
             seed & 0xFFFFFFFF, float(_ref.inv_scale(scale)), out.data_ptr(),
             x.numel(), _FMT_ID[fmt], int(saturate),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stochastic_round")
    return out


def sr_quantize(x: torch.Tensor, rand8: torch.Tensor, scale=None, *,
                fmt: str = "e5m2", saturate: bool = True) -> torch.Tensor:
    """SR(x / scale) -> fp8 with the bits of `rand8` (uint8, x's shape)."""
    _check(x, fmt)
    if rand8.shape != x.shape or rand8.dtype != torch.uint8 \
            or rand8.device != x.device:
        raise ValueError(f"rand8 must be uint8 of shape {tuple(x.shape)} on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return _ref.stochastic_round_fp8_ref(x, rand8, scale, fmt=fmt,
                                             saturate=saturate)
    out = _launch(x, aligned(rand8), 0, scale, fmt, saturate)
    sr_quantize.launches += 1
    return out


def sr_quantize_onchip(x: torch.Tensor, seed: int, scale=None, *,
                       fmt: str = "e5m2", saturate: bool = True
                       ) -> torch.Tensor:
    """SR(x / scale) -> fp8 with the kernel's own bits: the counter hash of
    (seed, flat element index)."""
    _check(x, fmt)
    if x.device.type == "cpu":
        return _ref.stochastic_round_fp8_onchip_ref(x, seed, scale, fmt=fmt,
                                                    saturate=saturate)
    out = _launch(x, None, int(seed), scale, fmt, saturate)
    sr_quantize_onchip.launches += 1
    return out


sr_quantize.launches = 0
sr_quantize_onchip.launches = 0


def stochastic_round_fp8(x: torch.Tensor,
                         generator_or_seed: Union[torch.Generator, int,
                                                  None] = None,
                         scale=None, *, fmt: str = "e5m2",
                         saturate: bool = True,
                         use_onchip_prng: bool = False) -> torch.Tensor:
    """Quantize x (f32 or bf16, any rank) into fp8 `fmt` ('e5m2' or
    'e4m3') with stochastic rounding. `generator_or_seed` is the
    torch.Generator the uint8 bits are drawn from, or, with
    use_onchip_prng=True, the integer seed of the in-kernel hash. scale:
    a number or one-element tensor (default 1)."""
    x2 = x.reshape(-1, x.shape[-1] if x.dim() else 1)
    if use_onchip_prng:
        if not isinstance(generator_or_seed, int):
            raise TypeError("use_onchip_prng=True takes an integer seed")
        out = sr_quantize_onchip(x2.contiguous(), generator_or_seed, scale,
                                 fmt=fmt, saturate=saturate)
    else:
        gen: Optional[torch.Generator] = generator_or_seed
        if not isinstance(gen, torch.Generator):
            raise TypeError("stochastic_round_fp8 draws its bits from a "
                            "torch.Generator (or pass use_onchip_prng=True "
                            "and an integer seed)")
        rand8 = torch.randint(0, 256, x2.shape, dtype=torch.uint8,
                              device=x.device, generator=gen)
        out = sr_quantize(x2.contiguous(), rand8, scale, fmt=fmt,
                          saturate=saturate)
    return out.reshape(x.shape)


def reset_launches():
    """Set the launch counts of both variants to 0."""
    sr_quantize.launches = 0
    sr_quantize_onchip.launches = 0
