"""Per-site FP8 precision-health counters (counterpart of
`repro.obs.counters`).

Two observation flavors, one semantics:

 * `payload_health(data, fmt)` — for tensors whose FP8 payload is
   materialized (quantized operands, error cotangents): the fractions read
   from the payload's bit patterns with the sign masked off, the same
   `& 0x7F` read the amax observation takes.
 * `value_counts(q, fmt, mask)` — counts of just-quantized values, the
   plain form of what the kernels' count epilogues compute (the fused
   GEMM's, and the attention kernels' S / P and dP / dS counts, which
   never reach device memory).

Saturation fraction: |q| at the format's max normal or beyond (inf / NaN
payloads included). Flush fraction: |q| below the format's min normal
(zeros and subnormals). Both are fractions of the observed region.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.fp8_formats import FloatFormat, get_format


@functools.lru_cache(maxsize=None)
def payload_thresholds(fmt_name: str) -> Tuple[int, int]:
    """(min_normal_bits, max_normal_bits) of the |payload| (sign stripped),
    from the format's fields: min normal is exponent field 1 with a zero
    mantissa; max normal the top finite exponent field with the largest
    finite mantissa (one below all-ones in the 'fn' formats, whose
    all-ones pattern is NaN).

    Payload magnitudes order like their bit patterns, so
      bits <  lo  <=> zero or subnormal (flush)
      bits >= hi  <=> max-normal or inf/nan (saturated)
    """
    fmt = get_format(fmt_name)
    lo = 1 << fmt.man_bits
    top = (1 << fmt.exp_bits) - (2 if fmt.has_inf else 1)
    man = (1 << fmt.man_bits) - (1 if fmt.has_inf else 2)
    return lo, (top << fmt.man_bits) | man


def payload_health(data: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """(2,) f32 [sat_frac, flush_frac] from an FP8 payload's bit patterns.
    The counts go to f32, then an f32 division by a device divisor (torch
    turns a division by a python number on CUDA into a multiply by its
    reciprocal), filled on the device: a host-to-device copy would make
    the host wait for the device."""
    lo, hi = payload_thresholds(fmt_name)
    bits = data.view(torch.uint8) & 0x7F
    n = torch.full((), float(max(1, bits.numel())), dtype=torch.float32,
                   device=data.device)
    sat = (bits >= hi).sum().to(torch.float32) / n
    flush = (bits < lo).sum().to(torch.float32) / n
    return torch.stack([sat, flush])


def value_masks(q: torch.Tensor, fmt: FloatFormat
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(saturated, flushed) boolean masks of just-quantized values `q` (any
    float dtype): the one rule every value count of the port (this module's
    and the attention kernels' plain versions) applies."""
    a = q.float().abs()
    return (a >= fmt.max_normal) | ~torch.isfinite(a), a < fmt.min_normal


def value_counts(q: torch.Tensor, fmt: FloatFormat,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sat_count, flush_count) f32 0-d tensors from just-quantized values
    `q` (any float dtype); `mask` restricts them to the observed region."""
    sat, flush = value_masks(q, fmt)
    if mask is not None:
        sat = sat & mask
        flush = flush & mask
    return sat.sum().to(torch.float32), flush.sum().to(torch.float32)


def counts_to_frac(counts: torch.Tensor) -> torch.Tensor:
    """(..., 3) [sat, flush, n] count triples -> (..., 2) f32 [sat_frac,
    flush_frac] (n taken as at least 1)."""
    c = counts.to(torch.float32)
    n = torch.clamp(c[..., 2], min=1.0)
    return torch.stack([c[..., 0] / n, c[..., 1] / n], dim=-1)
