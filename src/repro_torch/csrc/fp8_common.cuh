// Shared device helpers of the port's FP8 kernels: fp8 <-> float, the two
// Q nodes of repro.core.quantize (RNE with explicit overflow rules, and the
// exact fp16 bit-twiddle stochastic rounding), the counter hash of
// repro.kernels.fp8_attention.ref.sr_hash_bits, and the bf16 mma.sync.
//
// Every fp8 byte is produced here from an on-grid f32 value by integer
// encoding — never by a hardware cast — so the overflow and NaN rules are
// the reference's (a saturating e4m3 cast would turn overflow into 448).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp8 {

enum Fmt { E4M3 = 0, E5M2 = 1 };

struct FmtSpec {
  int man;           // mantissa bits
  int min_exp;       // exponent of the smallest normal
  float max_normal;  // 448 / 57344
  float min_normal;  // 2^-6 / 2^-14
  float thresh;      // smallest |x| RNE rounds past max_normal
  int drop;          // SR: random low bits of the prescaled fp16 pattern
  uint32_t max_bits; // SR: fp16 pattern of the prescaled max_normal
  uint32_t ovf_bits; // SR: pattern past max (inf for e5m2, NaN for e4m3)
};

__device__ __forceinline__ FmtSpec spec(int fmt) {
  if (fmt == E4M3)
    return FmtSpec{3, -6, 448.f, 0.015625f, 480.f, 7, 0x3F00u, 0x7E00u};
  return FmtSpec{2, -14, 57344.f, 6.103515625e-05f, 61440.f, 8, 0x7B00u,
                 0x7C00u};
}

// NaN-propagating max (jnp.maximum semantics; fmaxf would drop the NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float to_float(uint8_t b, int fmt) {
  if (fmt == E5M2)  // e5m2 is the top byte of an IEEE fp16
    return __half2float(__ushort_as_half((unsigned short)(b << 8)));
  uint32_t s = (uint32_t)(b & 0x80) << 24;
  uint32_t e = (b >> 3) & 0xF, m = b & 7;
  if (e == 15 && m == 7) return __uint_as_float(s | 0x7FC00000u);
  if (e == 0) {
    float v = (float)m * 0.001953125f;  // m * 2^-9, exact
    return s ? -v : v;
  }
  return __uint_as_float(s | ((e + 120u) << 23) | (m << 20));
}

// Encode a finite, on-grid magnitude r <= max_normal with sign byte `sgn`.
__device__ __forceinline__ uint8_t encode(float r, uint32_t sgn, int fmt) {
  if (r == 0.f) return (uint8_t)sgn;
  uint32_t bits = __float_as_uint(r);
  int e = (int)(bits >> 23) - 127;
  if (fmt == E4M3) {
    if (e < -6) return (uint8_t)(sgn | (uint32_t)(r * 512.f));
    return (uint8_t)(sgn | ((uint32_t)(e + 7) << 3) | ((bits >> 20) & 7u));
  }
  if (e < -14) return (uint8_t)(sgn | (uint32_t)(r * 65536.f));
  return (uint8_t)(sgn | ((uint32_t)(e + 15) << 2) | ((bits >> 21) & 3u));
}

// repro.core.quantize.quantize_rne on an f32 value (single rounding onto
// the grid, ties to even; saturate clamps, else overflow -> inf / NaN).
__device__ __forceinline__ uint8_t quant_rne(float y, int fmt, bool sat) {
  const FmtSpec f = spec(fmt);
  uint32_t sgn = (__float_as_uint(y) >> 24) & 0x80u;
  if (isnan(y)) return (uint8_t)(sgn | 0x7Fu);
  if (isinf(y)) return (uint8_t)(fmt == E5M2 ? (sgn | 0x7Cu) : (sgn | 0x7Fu));
  float ax = fabsf(y);
  int e = max((int)(__float_as_uint(ax) >> 23) - 127, f.min_exp);
  float ulp = __uint_as_float((uint32_t)(e - f.man + 127) << 23);
  float r = __fmul_rn(rintf(__fdiv_rn(ax, ulp)), ulp);
  if (sat) {
    r = fminf(r, f.max_normal);
  } else if (ax >= f.thresh || r > f.max_normal) {
    // Overflow: inf (e5m2) / NaN (e4m3). Past max_normal but below the
    // threshold only e4m3 reaches (its grid continues to 480): NaN too.
    return (uint8_t)(fmt == E5M2 ? (sgn | 0x7Cu) : 0x7Fu);
  }
  return encode(r, sgn, fmt);
}

// repro.core.quantize.sr_fp8_via_f16: prescale into fp16 (e4m3: x 2^-8),
// add the low `drop` random bits to the fp16 pattern, truncate, unscale.
__device__ __forceinline__ uint8_t quant_sr(float y, uint32_t rnd, int fmt,
                                            bool sat) {
  const FmtSpec f = spec(fmt);
  if (sat && !isnan(y)) y = fminf(fmaxf(y, -f.max_normal), f.max_normal);
  if (fmt == E4M3) y = __fmul_rn(y, 0.00390625f);
  uint32_t hb = __half_as_ushort(__float2half_rn(y));
  uint32_t sgn = hb & 0x8000u, mag = hb & 0x7FFFu;
  uint32_t mask = (1u << f.drop) - 1u, keep = 0xFFFFu ^ mask;
  uint32_t trunc = ((mag + (rnd & mask)) & 0xFFFFu) & keep;
  if (sat) {
    trunc = min(trunc, f.max_bits);
  } else if (trunc > f.max_bits) {
    trunc = f.ovf_bits;
  }
  uint32_t om = mag < 0x7C00u ? trunc : ((mag & keep) | (mag & 0x0200u));
  uint32_t ob = sgn | om;
  if (fmt == E5M2) return (uint8_t)(ob >> 8);
  float v = __fmul_rn(__half2float(__ushort_as_half((unsigned short)ob)), 256.f);
  uint32_t s8 = sgn ? 0x80u : 0u;
  if (isnan(v) || isinf(v)) return (uint8_t)(s8 | 0x7Fu);
  return encode(fabsf(v), s8, E4M3);
}

__device__ __forceinline__ uint8_t quant(float y, uint32_t rnd, int fmt,
                                         bool sr, bool sat) {
  return sr ? quant_sr(y, rnd, fmt, sat) : quant_rne(y, fmt, sat);
}

// murmur3 finalizer and the attention SR bit hash (uint32 wraparound).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t salt,
                                              uint32_t bh, uint32_t row,
                                              uint32_t col) {
  const uint32_t gold = 0x9E3779B9u;
  uint32_t s = fmix32(seed + salt * gold);
  s = fmix32(s + bh * gold);
  uint32_t h = fmix32(s + row * gold);
  h = fmix32(h ^ (col * gold));
  return h & 0xFFu;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Convert 16 fp8 bytes to 16 bf16 (exact) as 8 packed words.
__device__ __forceinline__ void bytes_to_bf16(const uint4& w, int fmt,
                                              uint32_t out[8]) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = pack_bf16(to_float(p[2 * i], fmt), to_float(p[2 * i + 1], fmt));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace fp8
