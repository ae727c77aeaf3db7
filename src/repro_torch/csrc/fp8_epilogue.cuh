// Per-score epilogue helpers shared by the port's attention kernels: the
// Q nodes of fp8_common.cuh rewritten without branches (their constants
// made once on the host), the counter hash split at the row, the exact
// hardware fp8 -> f16 conversions, and ldmatrix.
#pragma once

#include <type_traits>

#include "fp8_common.cuh"

namespace fp8 {

// One Q node's constants, precomputed on the host and read from the
// kernel's parameter space, so that the per-element quantizers below run
// without a branch (quant_rne / quant_sr, bit for bit).
struct QConst {
  float pre;          // SR: prescale into fp16 (2^-8 e4m3, 1 e5m2)
  float maxn;         // max normal
  float thresh;       // RNE: smallest |x| that rounds past max normal
  float sub_mul;      // RNE: subnormal encode multiplier (2^9 / 2^16)
  uint32_t mask, keep, max_bits, ovf_bits;  // SR on the fp16 pattern
  int man, min_exp, bias, shift;  // shift: fp16 pattern -> byte (7 / 8)
  int sat, e4m3;
};

// constexpr, so that a kernel may also fold a Q node known at compile time.
__host__ __device__ constexpr QConst make_qconst(int fmt, int sat) {
  QConst c{};
  const bool e4 = fmt == E4M3;
  c.pre = e4 ? 0.00390625f : 1.f;
  c.maxn = e4 ? 448.f : 57344.f;
  c.thresh = e4 ? 480.f : 61440.f;
  c.sub_mul = e4 ? 512.f : 65536.f;
  c.mask = e4 ? 0x7Fu : 0xFFu;
  c.keep = 0xFFFFu ^ c.mask;
  c.max_bits = e4 ? 0x3F00u : 0x7B00u;
  c.ovf_bits = e4 ? 0x7E00u : 0x7C00u;
  c.man = e4 ? 3 : 2;
  c.min_exp = e4 ? -6 : -14;
  c.bias = e4 ? 7 : 15;
  c.shift = e4 ? 7 : 8;
  c.sat = sat;
  c.e4m3 = e4;
  return c;
}

// quant_sr without branches: an e4m3 byte is the fp16 pattern of the
// prescaled value shifted by 7 (normals and subnormals alike), an e5m2
// byte its top byte; inf / NaN patterns give e4m3's NaN.
__device__ __forceinline__ uint32_t quant_sr_bf(float y, uint32_t rnd,
                                                const QConst& c) {
  const float yc = fminf(fmaxf(y, -c.maxn), c.maxn);
  y = (c.sat && !isnan(y)) ? yc : y;
  y = __fmul_rn(y, c.pre);
  const uint32_t hb = __half_as_ushort(__float2half_rn(y));
  const uint32_t sgn = hb & 0x8000u, mag = hb & 0x7FFFu;
  uint32_t trunc = ((mag + (rnd & c.mask)) & 0xFFFFu) & c.keep;
  trunc = c.sat ? min(trunc, c.max_bits)
                : (trunc > c.max_bits ? c.ovf_bits : trunc);
  const uint32_t om = mag < 0x7C00u ? trunc
                                    : ((mag & c.keep) | (mag & 0x0200u));
  const uint32_t mb = (c.e4m3 && om >= 0x7C00u) ? 0x7Fu : (om >> c.shift);
  return (sgn >> 8) | mb;
}

// quant_rne without branches (the division by the power-of-two ulp is
// the exact multiplication by its inverse).
__device__ __forceinline__ uint32_t quant_rne_bf(float y, const QConst& c) {
  const uint32_t yb = __float_as_uint(y);
  const uint32_t sgn = (yb >> 24) & 0x80u;
  const float ax = fabsf(y);
  const int e = max((int)((yb >> 23) & 0xFFu) - 127, c.min_exp);
  const float ulp = __uint_as_float((uint32_t)(e - c.man + 127) << 23);
  const float inv = __uint_as_float((uint32_t)(127 - e + c.man) << 23);
  float r = __fmul_rn(rintf(__fmul_rn(ax, inv)), ulp);
  const bool ovf = !c.sat && (ax >= c.thresh || r > c.maxn);
  r = c.sat ? fminf(r, c.maxn) : r;
  const uint32_t rb = __float_as_uint(r);
  const int er = (int)(rb >> 23) - 127;
  const uint32_t nor = ((uint32_t)(er + c.bias) << c.man) |
                       ((rb >> (23 - c.man)) & ((1u << c.man) - 1u));
  const uint32_t sub = __float2uint_rz(__fmul_rn(r, c.sub_mul));
  uint32_t out = sgn | (er < c.min_exp ? sub : nor);
  const uint32_t big = c.e4m3 ? (sgn | 0x7Fu) : (sgn | 0x7Cu);
  out = ovf ? (c.e4m3 ? 0x7Fu : big) : out;
  out = isinf(y) ? big : out;
  return isnan(y) ? (sgn | 0x7Fu) : out;
}

template <bool SR>
__device__ __forceinline__ uint32_t quant_bf(float y, uint32_t rnd,
                                             const QConst& c) {
  if constexpr (SR) return quant_sr_bf(y, rnd, c);
  return quant_rne_bf(y, c);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}

// Two fp8 bytes (low byte first) -> f16x2 by the hardware conversion
// (exact: every e4m3 / e5m2 value is an f16 value).
__device__ __forceinline__ __half2 fp8x2_to_half2(uint32_t two, int fmt) {
  const unsigned short in = static_cast<unsigned short>(two & 0xFFFFu);
  uint32_t out;
  if (fmt == E4M3)
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(out) : "h"(in));
  else
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(out) : "h"(in));
  return *reinterpret_cast<__half2*>(&out);
}

// One fp8 byte as f32 (to_float by the hardware conversion).
__device__ __forceinline__ float byte_to_f32(uint32_t b, int fmt) {
  return __low2float(fp8x2_to_half2(b, fmt));
}

// The four fp8 bytes of a word (byte e -> v[e]) as f32.
__device__ __forceinline__ void word_to_f32(uint32_t w, int fmt, float v[4]) {
  const float2 lo = __half22float2(fp8x2_to_half2(w, fmt));
  const float2 hi = __half22float2(fp8x2_to_half2(w >> 16, fmt));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// The SR hash split at the row: the (seed, salt, bh, row) prefix once per
// row, the column step per element; hash_bits bit for bit.
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, uint32_t salt,
                                             uint32_t bh, uint32_t row) {
  const uint32_t gold = 0x9E3779B9u;
  uint32_t s = fmix32(seed + salt * gold);
  s = fmix32(s + bh * gold);
  return fmix32(s + row * gold);
}

__device__ __forceinline__ uint32_t hash_col(uint32_t pre, uint32_t col) {
  return fmix32(pre ^ (col * 0x9E3779B9u)) & 0xFFu;
}

// Runs f(std::bool_constant<B>) for a (uniform) flag b, such as the
// rounding flag, so that a loop's per-element quantizer is chosen once,
// outside the loop.
template <class F>
__device__ __forceinline__ void with_flag(int b, F&& f) {
  if (b)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// A Q node known at compile time: rounding, saturation and format.
template <bool SR_, bool SAT_, int FMT_>
struct QNode {
  static constexpr bool SR = SR_;
  static constexpr int SAT = SAT_, FMT = FMT_;
};

// Runs f(QNode<...>{}) for the (uniform) Q-node flags, so that a pass's
// quantizer and fp8 conversions fold to the one Q node it takes.
template <bool SR, class F>
__device__ __forceinline__ void with_qnode_sr(int sat, int fmt, F&& f) {
  if (sat) {
    if (fmt == E4M3)
      f(QNode<SR, true, E4M3>{});
    else
      f(QNode<SR, true, E5M2>{});
  } else {
    if (fmt == E4M3)
      f(QNode<SR, false, E4M3>{});
    else
      f(QNode<SR, false, E5M2>{});
  }
}

template <class F>
__device__ __forceinline__ void with_qnode(int sr, int sat, int fmt, F&& f) {
  if (sr)
    with_qnode_sr<true>(sat, fmt, f);
  else
    with_qnode_sr<false>(sat, fmt, f);
}

// a / b rounded to nearest even, as __fdiv_rn, for b > 0 (or NaN), without
// __fdiv_rn's slow-path subroutine (the probe read a decode tile's store
// pass of the attention forward at 18.8k cycles with it, 2.3k with this).
// In double: 1/b by Newton from the approximate reciprocal (relative error
// < 2^-51 after three steps), times a, rounded to float. A float quotient
// lies at least 2^-49 (relative) from every midpoint between floats, so
// the rounding is a / b's. rcp_rn is the divisor's half, for a divisor
// shared by many quotients.
__device__ __forceinline__ double rcp_rn(float b) {
  const double bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = fma(y, fma(-bd, y, 1.0), y);
  return isinf(b) ? 0.0 : y;
}

__device__ __forceinline__ float mul_rcp(float a, double y) {
  return __double2float_rn((double)a * y);
}

__device__ __forceinline__ float div_rn(float a, float b) {
  return mul_rcp(a, rcp_rn(b));
}

}  // namespace fp8
