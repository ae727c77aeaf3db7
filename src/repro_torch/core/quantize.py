"""Quantization primitives: RNE and stochastic rounding into FP8.

Counterpart of `repro.core.quantize`, bit for bit. Two places need care:

* torch's f32->float8_e4m3fn cast saturates overflow (and inf) to +-448,
  where the reference gives NaN; the overflow rules are therefore applied
  explicitly (`quantize_rne`, `to_fp8`) and never left to the cast.
* torch on the CPU has no uint16 `add` and no uint32 `>>`, so the fp16
  bit-twiddle of stochastic rounding runs in int32 with explicit masks.

Scales are host-side float32 scalars (numpy.float32) at unit scales and
under delayed scaling: every scale product and reciprocal is one IEEE f32
operation, exactly as in the reference. A just-in-time amax scale
(`amax_scale`, `quantize(use_amax_scale=True)`) depends on the tensor, so
it stays a 0-d f32 tensor on the tensor's device through the quantize, the
GEMM and the dequantize: reading it on the host would stall each Q node on
a device->host copy.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.fp8_formats import E5M2, FloatFormat, get_format

_F16_EXP_MASK = 0x7C00
_F16_MAG_MASK = 0x7FFF
_F16_SIGN_MASK = 0x8000


def f32(x) -> np.float32:
    """A host f32 scalar (the port's scale type)."""
    return np.float32(x)


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """fp16 bit patterns as int32 in [0, 65536)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def _bits_f16(b: torch.Tensor) -> torch.Tensor:
    return (b & 0xFFFF).to(torch.int16).view(torch.float16)


def to_fp8(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """RNE cast to the storage dtype with the reference's overflow
    semantics: a value that rounds past max_normal is inf in e5m2 and NaN
    in the inf-less e4m3fn, where torch's cast would saturate to 448 (e4m3's
    RNE grid continues to 480 before 512)."""
    q = x.to(fmt.dtype)
    if not fmt.has_inf:
        over = ~(_rne_on_grid_f32(x, fmt).abs() <= fmt.max_normal) \
            & ~torch.isnan(x)
        q = torch.where(over, torch.full_like(q, float("nan")), q)
    return q


# ---------------------------------------------------------------------------
# RNE quantization
# ---------------------------------------------------------------------------

def rne_overflow_threshold(fmt: FloatFormat) -> float:
    """Smallest |x| that RNE rounds to infinity."""
    return (fmt.max_normal + 2.0 ** (fmt.max_exp + 1)) / 2.0


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for int32 e in the f32 normal range (built from bits)."""
    return ((e + 127) << 23).view(torch.float32)


def _rne_on_grid_f32(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Correctly rounded RNE of f32 onto fmt's value grid: |x| splits
    exactly into (ulp, multiple of ulp) and ties go to even on the ratio."""
    xf = x.float()
    ax = xf.abs()
    e = torch.clamp_min((ax.view(torch.int32) >> 23) - 127, fmt.min_exp)
    ulp = _pow2(e - fmt.man_bits)
    return torch.copysign(torch.round(ax / ulp) * ulp, xf)


def quantize_rne(x: torch.Tensor, fmt: FloatFormat = E5M2, *,
                 saturate: bool = True) -> torch.Tensor:
    """Round-to-nearest-even down-conversion into `fmt`'s storage dtype.
    saturate=True clamps overflow to +-max_normal; saturate=False turns it
    into +-inf (e5m2) or NaN (e4m3)."""
    if fmt.dtype is None:
        raise ValueError(f"format {fmt.name} has no storage dtype")
    if not x.is_floating_point():
        x = x.float()
    finite = torch.isfinite(x)
    if x.dtype in (torch.float16, torch.bfloat16):
        # Narrow inputs round once in the storage cast.
        rounded = x
    else:
        rounded = torch.where(finite, _rne_on_grid_f32(x, fmt), x.float())
    if saturate:
        clamped = torch.clamp(rounded, -fmt.max_normal, fmt.max_normal)
        return to_fp8(torch.where(finite, clamped, rounded), fmt)
    q = to_fp8(rounded, fmt)
    thresh = rne_overflow_threshold(fmt)
    overflow = (x.float().abs() if x.dtype == torch.float16
                else x.abs()) >= thresh
    if fmt.has_inf:
        ovf = torch.copysign(torch.full_like(x, float("inf")), x)
    else:
        ovf = torch.full_like(x, float("nan"))
    return torch.where(overflow & finite, to_fp8(ovf, fmt), q)


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SRSpec:
    """fp16-embedding constants for exact SR into one fp8 format."""
    pre_exp: int
    drop_bits: int
    max_bits: int
    ovf_bits: int


@functools.lru_cache(maxsize=None)
def sr_spec(fmt: FloatFormat) -> SRSpec:
    pre_exp = -14 - fmt.min_exp
    if fmt.man_bits > 10 or fmt.max_normal * 2.0 ** pre_exp > 65504.0:
        raise ValueError(f"format {fmt.name} does not embed in fp16")
    max_bits = int(np.float16(fmt.max_normal * 2.0 ** pre_exp)
                   .view(np.uint16))
    return SRSpec(pre_exp=pre_exp, drop_bits=10 - fmt.man_bits,
                  max_bits=max_bits,
                  ovf_bits=_F16_EXP_MASK if fmt.has_inf else 0x7E00)


def sr_fp8_from_bits(h_bits: torch.Tensor, rand: torch.Tensor,
                     fmt: FloatFormat = E5M2, *,
                     saturate: bool = True) -> torch.Tensor:
    """Exact fp8 SR on *prescaled* fp16 bit patterns (int32 in [0, 65536))
    plus random bits (low `drop_bits` used). Returns the prescaled fp16
    pattern as int32."""
    spec = sr_spec(fmt)
    mask = (1 << spec.drop_bits) - 1
    keep = 0xFFFF ^ mask
    h = h_bits.to(torch.int32) & 0xFFFF
    sign = h & _F16_SIGN_MASK
    mag = h & _F16_MAG_MASK
    finite = mag < _F16_EXP_MASK
    bumped = (mag + (rand.to(torch.int32) & mask)) & 0xFFFF
    trunc = bumped & keep
    if saturate:
        trunc = torch.clamp_max(trunc, spec.max_bits)
    else:
        trunc = torch.where(trunc > spec.max_bits,
                            torch.full_like(trunc, spec.ovf_bits), trunc)
    out_mag = torch.where(finite, trunc, (mag & keep) | (mag & 0x0200))
    return sign | out_mag


def sr_fp8_via_f16(x: torch.Tensor, rand: torch.Tensor,
                   fmt: FloatFormat = E5M2, *,
                   saturate: bool = True) -> torch.Tensor:
    """Stochastically round `x` into fmt.dtype via the exact fp16 bit-twiddle
    (prescale -> twiddle -> unscale -> storage cast)."""
    spec = sr_spec(fmt)
    if saturate:
        x = torch.where(torch.isnan(x), x,
                        torch.clamp(x, -fmt.max_normal, fmt.max_normal))
    if spec.pre_exp:
        x = x * 2.0 ** spec.pre_exp
    out = _bits_f16(sr_fp8_from_bits(_f16_bits(x), rand, fmt,
                                     saturate=saturate))
    if spec.pre_exp:
        out = out * 2.0 ** -spec.pre_exp
    return to_fp8(out, fmt)


def random_bits(shape, device, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Uniform 16-bit SR bits as int32 (the port's stand-in for
    `jax.random.bits(key, shape, uint16)`; tests feed both sides the same
    bits instead)."""
    return torch.randint(0, 1 << 16, tuple(shape), dtype=torch.int32,
                         device=device, generator=generator)


def quantize_sr(x: torch.Tensor, fmt: FloatFormat, rand: torch.Tensor, *,
                saturate: bool = True) -> torch.Tensor:
    if fmt.name not in ("e5m2", "e4m3"):
        raise ValueError(f"SR into {fmt.name} is not ported")
    return sr_fp8_via_f16(x, rand, fmt, saturate=saturate)


# ---------------------------------------------------------------------------
# Scaled quantization (QTensor)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QTensor:
    """An FP8 payload plus a per-tensor dequantization scale (host f32, or
    a 0-d f32 device tensor for a just-in-time amax scale):
    x ~= data.float() * scale."""
    data: torch.Tensor
    scale: Union[np.float32, torch.Tensor]

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype


def fp8_amax_bits(data: torch.Tensor) -> torch.Tensor:
    """amax of an FP8 payload from its bit patterns (sign cleared, the
    pattern is monotone in magnitude; NaN sorts above inf and propagates).
    Returns a 0-d f32 tensor on data's device."""
    bits = data.view(torch.uint8) & 0x7F
    return bits.max().reshape(1).view(data.dtype).float()[0]


def _cast_scalar(v: np.float32, dtype: torch.dtype) -> float:
    """A host f32 scalar rounded to `dtype` (as `jnp.astype` would), as a
    python float that torch applies exactly."""
    if dtype == torch.float32:
        return float(v)
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))


def amax_scale(x: torch.Tensor, fmt: FloatFormat, *,
               margin: float = 1.0) -> torch.Tensor:
    """Per-tensor scale mapping amax -> fmt.max_normal / margin, a 0-d f32
    tensor on x's device: the abs-max reduced in x's dtype (exact), then
    max(amax, 1e-12) * margin / max_normal in f32."""
    amax = torch.clamp_min(x.abs().amax().float(), 1e-12)
    return amax * margin / fmt.max_normal


def quantize(x: torch.Tensor, fmt: Union[str, FloatFormat] = E5M2, *,
             rounding: str = "rne",
             rand: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             scale=None, use_amax_scale: bool = False,
             saturate: bool = True) -> QTensor:
    """Quantize into a QTensor. rounding in {'rne', 'sr'}; 'sr' takes its
    random bits from `rand` (int, low bits used) or draws them from
    `generator`. An explicit `scale`, or the just-in-time `amax_scale`
    with use_amax_scale, takes the reciprocal-multiply path (x * (1/scale)
    in x's dtype; the amax scale's reciprocal computed on the device);
    otherwise the unit scale divides."""
    if isinstance(fmt, str):
        fmt = get_format(fmt)
    if not x.is_floating_point():
        x = x.float()
    if scale is None and use_amax_scale:
        scale = amax_scale(x, fmt)
    if scale is None:
        scale = f32(1.0)
        xs = x / _cast_scalar(scale, x.dtype)
    elif isinstance(scale, torch.Tensor):
        xs = x * (torch.ones_like(scale) / scale).to(x.dtype)
    else:
        scale = f32(scale)
        xs = x * _cast_scalar(f32(1.0) / scale, x.dtype)
    if rounding == "rne":
        data = quantize_rne(xs, fmt, saturate=saturate)
    elif rounding == "sr":
        if rand is None:
            rand = random_bits(x.shape, x.device, generator)
        data = quantize_sr(xs, fmt, rand, saturate=saturate)
    else:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    return QTensor(data=data, scale=scale)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if isinstance(q.scale, torch.Tensor):
        return q.data.to(dtype) * q.scale.to(dtype)
    return q.data.to(dtype) * _cast_scalar(q.scale, dtype)
