"""Plain PyTorch versions of the stochastic-rounding kernels (counterpart
of `repro.kernels.stochastic_round.ref`).

`stochastic_round_fp8_ref(x, rand8, scale)` is bitwise the reference's
oracle: y = f32(x) * f32(1/scale) — a multiply by the f32 reciprocal, as
the kernel's `inv = 1.0 / scale_ref[0]` — then the exact fp16 bit-twiddle
`sr_fp8_via_f16` with the low bits of `rand8`.

`sr_hash_rand8(seed, n)` gives the bits of the on-chip variant: the
reference's kernel draws them from the TPU's PRNG, whose stream cannot be
reproduced on another device. The port's kernel hashes (seed, flat element
index) with the counter hash of the attention kernels
(`kernels.fp8_attention.ref.sr_hash_bits`, salt SALT_SR), and this function
reproduces those bits exactly. Against the reference that variant is held
by what SR promises — unbiased rounding from uniform bits — not by bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.quantize import sr_fp8_via_f16
from repro_torch.kernels.fp8_attention.ref import sr_hash_bits

SALT_SR = 0x55   # csrc/stochastic_round.cu


def inv_scale(scale) -> np.float32:
    """f32(1 / scale) for a scale given as a number or a one-element tensor
    (None is the unit scale)."""
    if scale is None:
        return np.float32(1.0)
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"scale must hold one value, got {scale.shape}")
        scale = scale.reshape(()).item()
    return np.float32(1.0) / np.float32(scale)


def stochastic_round_fp8_ref(x: torch.Tensor, rand8: torch.Tensor, scale=None,
                             *, fmt: str = "e5m2",
                             saturate: bool = True) -> torch.Tensor:
    """SR(x * (1/scale)) into fmt's storage dtype, bits from rand8 (uint8,
    x's shape; the low 8 (e5m2) or 7 (e4m3) bits are used)."""
    y = x.float() * float(inv_scale(scale))
    return sr_fp8_via_f16(y, rand8, get_format(fmt), saturate=saturate)


def sr_hash_rand8(seed: int, n: int, device) -> torch.Tensor:
    """The on-chip variant's bits: (n,) uint8, element i from the counter
    hash of (seed, i)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return sr_hash_bits(int(seed) & 0xFFFFFFFF, SALT_SR, 0, 0,
                        idx).to(torch.uint8)


def stochastic_round_fp8_onchip_ref(x: torch.Tensor, seed: int, scale=None,
                                    *, fmt: str = "e5m2",
                                    saturate: bool = True) -> torch.Tensor:
    """The on-chip variant: stochastic_round_fp8_ref with the hash bits."""
    rand8 = sr_hash_rand8(seed, x.numel(), x.device).reshape(x.shape)
    return stochastic_round_fp8_ref(x, rand8, scale, fmt=fmt,
                                    saturate=saturate)
