"""Floating-point format metadata (paper Table 1), torch storage dtypes.

Counterpart of `repro.core.fp8_formats`: the same dataclass and the same
exact values; `dtype` is the torch storage dtype (None where torch has no
native dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """Metadata for a (sign, exponent, mantissa) floating-point format."""

    name: str
    exp_bits: int
    man_bits: int
    bias: int
    # IEEE-style (all-ones exponent = inf/nan) or the "fn" variants that
    # reclaim the top exponent for finite values.
    has_inf: bool
    dtype: Optional[torch.dtype] = None

    @property
    def max_exp(self) -> int:
        raw = (1 << self.exp_bits) - 1
        return (raw - 1 if self.has_inf else raw) - self.bias

    @property
    def min_exp(self) -> int:
        return 1 - self.bias

    @property
    def max_normal(self) -> float:
        frac = 2.0 - 2.0 ** (-self.man_bits)
        if not self.has_inf:
            # fn formats: top mantissa pattern is NaN, so max frac loses one ulp.
            frac = 2.0 - 2.0 ** (1 - self.man_bits)
        return frac * 2.0 ** self.max_exp

    @property
    def min_normal(self) -> float:
        return 2.0 ** self.min_exp

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.min_exp - self.man_bits)

    @property
    def eps(self) -> float:
        return 2.0 ** (-self.man_bits)

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits


E5M2 = FloatFormat("e5m2", exp_bits=5, man_bits=2, bias=15, has_inf=True,
                   dtype=torch.float8_e5m2)
E4M3 = FloatFormat("e4m3", exp_bits=4, man_bits=3, bias=7, has_inf=False,
                   dtype=torch.float8_e4m3fn)
FP16 = FloatFormat("fp16", exp_bits=5, man_bits=10, bias=15, has_inf=True,
                   dtype=torch.float16)
BF16 = FloatFormat("bf16", exp_bits=8, man_bits=7, bias=127, has_inf=True,
                   dtype=torch.bfloat16)
FP32 = FloatFormat("fp32", exp_bits=8, man_bits=23, bias=127, has_inf=True,
                   dtype=torch.float32)

FORMATS = {f.name: f for f in (E5M2, E4M3, FP16, BF16, FP32)}
FP8_DTYPES = (torch.float8_e5m2, torch.float8_e4m3fn)


def get_format(name: str) -> FloatFormat:
    try:
        return FORMATS[name]
    except KeyError as e:
        raise ValueError(f"unknown float format {name!r}; have {sorted(FORMATS)}") from e


def format_of_dtype(dtype: torch.dtype) -> FloatFormat:
    """The fp8 format a payload dtype stores."""
    for f in (E5M2, E4M3):
        if f.dtype == dtype:
            return f
    raise ValueError(f"{dtype} is not an fp8 payload dtype")


def table1() -> dict:
    """Paper Table 1: dynamic range comparison (exact values)."""
    return {f.name: dict(bit_format=(1, f.exp_bits, f.man_bits),
                         max_normal=f.max_normal, min_normal=f.min_normal,
                         min_subnormal=f.min_subnormal)
            for f in (FP32, FP16, E5M2)}
