// FP8 flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fp8_attention/kernel.py::fp8_attention_bwd_kernel
// — its stats + dQ pallas_call (body _bwd_dq_body, grid (B, H, Q/bq, 4 nk))
// and its dK/dV pallas_call (body _bwd_dkv_body, grid (B, Hkv, nk, g nq)) —
// and computes the functions of ref.bwd_q_tile / ref.bwd_tile_dkv_stripe,
// per 128-column kv block in ascending order:
//   S8  = Q_A((q8 . k8^T) * f_s);  x = valid ? S8 * s_s : -1e30
//   m   = max_j rowmax x;  l = sum_j rowsum(valid ? exp(x - m) : 0)
//   P8  = Q_A(exp(x - m) / d_safe * f_p)  P = P8 * s_p   (d_safe = l or 1)
//   dP8 = Q_E((do8 . v8^T) * f_dp)        dP = dP8 * s_dp
//   rd  = sum_j rowsum(P * dP)
//   dS8 = Q_E(P * (dP - rd) * f_ds)
//   dQ  = (sum_j dS8 . k8) * f_dq
//   dK  = (sum over (GQA member, 128-row q tile) of dS8^T . q8) * f_dk
//   dV  = (same order, P8^T . do8) * f_dv
// with the dP / dS amaxes in grid units masked to the attended region
// (row < q_len and valid). SR bits: the counter hash of (seed, salt 0x51 /
// 0x52 / 0x53 / 0x54, b*H + h, row, col), as in the forward, so S8 and P8
// are recomputed from the fp8 residuals with the forward's bits. The seed
// is read from device memory (drawn there by the caller's generator).
//
// Kernel 1 (dQ + statistics): one block per (b, h, 64-row q tile), four
// warps of 16 rows. The TPU's sequential 4*nk grid axis (phases m -> l ->
// rd -> dQ over kv stripes) becomes four in-block loops over the 128-column
// kv blocks of the tile's kv_stripe_span (taken at the 128-row q tile that
// holds this 64-row tile, the granularity the dK/dV kernel skips at). S and
// dP are mma.sync m16n8k16 products of bf16 tiles in shared memory (fp8 ->
// bf16 is exact); dS feeds the dQ product from registers. dQ accumulates
// per kv block (acc + block product) in shared memory. It writes dQ * f_dq
// and the per-row m, l, rd in f32 for kernel 2.
//
// Kernel 2 (dK/dV): one block per (b, hkv, 64 kv rows), four warps of 16
// kv rows. It loops over the GQA members in head order, then the 128-row q
// tiles that attend this kv block, recomputing S^T = K . Q^T and
// dP^T = V . dO^T (the accumulator layout is then the A-operand layout of
// dS^T and P8^T), and adds each tile's dS8^T . q8 and P8^T . do8 to f32
// accumulators in shared memory in that fixed order: no atomics, so the
// add chain is the reference's and the result does not change from run to
// run. The scale is applied once, at the end.
//
// Both files' arithmetic is built with --fmad=false and the epilogues use
// __fmul_rn / __fadd_rn / __fdiv_rn, so every product and sum is rounded
// on its own, as in the reference.
//
// What bounds it: at the training shape (B=4, H=12, Hkv=2, S=512, D=128,
// causal) each kernel moves ~1-7 MB and does ~10 GFLOP of matrix products,
// a few microseconds at the card's rates; this first version is instead
// limited by its per-element quantize / exp / hash epilogue work, by the
// repeated K/V loads of the four passes, and by the dK/dV grid's 64 blocks
// on 132 SMs. fp8 wgmma, TMA and a wider dK/dV grid are later work.
#include "fp8_common.cuh"

namespace {

constexpr int LANE = 128;  // kv columns per block (and q rows per dK tile)
constexpr int D = 128;     // head dim (the wrapper zero-pads smaller heads)
constexpr int BQ = 64;     // q rows per dQ block
constexpr int BKV = 64;    // kv rows per dK/dV block
constexpr int TQ = 128;    // q rows per dK/dV contribution
constexpr int KS = D + 8;  // bf16 row stride (bank spread)
constexpr int FS = D + 4;  // f32 row stride of the accumulators
constexpr uint32_t SALT_S = 0x51, SALT_P = 0x52, SALT_DP = 0x53,
                   SALT_DS = 0x54;

struct Args {
  const uint8_t* q;    // (B, H, Q, D)
  const uint8_t* k;    // (B, Hkv, S, D), S a multiple of 128
  const uint8_t* v;
  const uint8_t* dO;   // (B, H, Q, D)
  const uint32_t* seed;
  float* dq;           // (B, H, Q, D)
  float* m;            // (B, H, Q)
  float* l;
  float* rd;
  float* amax_dp;      // (B, H, nq)
  float* amax_ds;
  float* dk;           // (B, Hkv, S, D)
  float* dv;
  int B, H, Hkv, Q, S, q_len, s_len, causal, window;
  int q_fmt, k_fmt, v_fmt, do_fmt, fmt_s, fmt_p, fmt_e;
  int sr_s, sr_p, sr_e, sat_s, sat_p, sat_e;
  float f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds, f_dq, f_dk, f_dv;
};

__device__ __forceinline__ bool is_valid(const Args& p, int row, int col) {
  if (col >= p.s_len) return false;
  if (!p.causal) return true;
  return col <= row && (p.window == 0 || col > row - p.window);
}

// The 128-column kv blocks a 128-row q tile starting at t0 attends
// (ref.kv_stripe_span at block_kv = 128).
__device__ __forceinline__ void kv_span(const Args& p, int t0, int& jmin,
                                        int& jmax) {
  const int nk = p.S / LANE;
  jmin = 0;
  jmax = nk - 1;
  if (p.causal) {
    jmax = min((t0 + TQ - 1) / LANE, nk - 1);
    if (p.window) jmin = max(t0 - p.window + 1, 0) / LANE;
  }
}

// rows x D fp8 rows (row-major, D contiguous) -> bf16 smem rows of stride
// KS; rows at or past `limit` read as zeros.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const uint8_t* src, int rows,
                                          int row0, int limit, int fmt) {
  for (int v = threadIdx.x; v < rows * D / 16; v += blockDim.x) {
    const int r = v / (D / 16), c = (v % (D / 16)) * 16;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D + c);
    uint32_t w[8];
    fp8::bytes_to_bf16(x, fmt, w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * KS + c);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Same, transposed: dst[d * KS + r] (for a B operand whose k index is r).
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const uint8_t* src, int rows,
                                            int row0, int fmt) {
  for (int v = threadIdx.x; v < rows * D / 16; v += blockDim.x) {
    const int r = v / (D / 16), c = (v % (D / 16)) * 16;
    uint4 x = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D + c);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&x);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[(c + i) * KS + r] = __float2bfloat16_rn(fp8::to_float(b[i], fmt));
  }
}

__device__ __forceinline__ uint32_t u32_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values from two addresses packed as an mma operand register.
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* lo,
                                         const __nv_bfloat16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// acc[16][4] = A(16 rows of `a`, stride KS) . B^T, where B is 128 rows of
// `b` (stride KS) — a 16 x 128 tile of a . b^T over the head dim.
__device__ __forceinline__ void tile_abt(float acc[16][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const int c = kk + 2 * t;
    uint32_t af[4] = {u32_at(a + g * KS + c), u32_at(a + (g + 8) * KS + c),
                      u32_at(a + g * KS + c + 8),
                      u32_at(a + (g + 8) * KS + c + 8)};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const __nv_bfloat16* bn = b + (nt * 8 + g) * KS + c;
      fp8::mma_bf16(acc[nt], af, u32_at(bn), u32_at(bn + 8));
    }
  }
}

// The packed A fragments of a 16 x 128 accumulator-layout tile.
__device__ __forceinline__ void pack_a(uint32_t frag[8][4], int nt,
                                       const float v[4]) {
  const int ks = nt >> 1, hi = nt & 1;
  frag[ks][hi ? 2 : 0] = fp8::pack_bf16(v[0], v[1]);
  frag[ks][hi ? 3 : 1] = fp8::pack_bf16(v[2], v[3]);
}

__device__ __forceinline__ float warp_sum4(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float warp_max4(float x) {
  x = fp8::nanmax(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fp8::nanmax(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------------------------------
// kernel 1: statistics + dQ
// ---------------------------------------------------------------------------

struct SmemDQ {
  __nv_bfloat16 q[BQ][KS];
  __nv_bfloat16 dO[BQ][KS];
  __nv_bfloat16 k[LANE][KS];   // [kv][d]
  __nv_bfloat16 v[LANE][KS];   // [kv][d]
  __nv_bfloat16 kt[D][KS];     // [d][kv]
  float dq[BQ][FS];
  float red[2][4];
};

__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDQ& sm = *reinterpret_cast<SmemDQ*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = iq * BQ;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  const uint32_t seed = *p.seed;
  const long long qoff = (long long)(b * p.H + h) * p.Q * D;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;

  load_rows(&sm.q[0][0], p.q + qoff, BQ, row0, p.Q, p.q_fmt);
  load_rows(&sm.dO[0][0], p.dO + qoff, BQ, row0, p.Q, p.do_fmt);
  for (int i = tid; i < BQ * FS; i += 128) (&sm.dq[0][0])[i] = 0.f;

  int rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = row0 + warp * 16 + g + 8 * i;
  int jmin, jmax;
  kv_span(p, row0 / TQ * TQ, jmin, jmax);

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float dsafe[2] = {1.f, 1.f};
  float amax_dp = 0.f, amax_ds = 0.f;
  const __nv_bfloat16* qw = &sm.q[warp * 16][0];
  const __nv_bfloat16* dow = &sm.dO[warp * 16][0];

  for (int phase = 0; phase < 4; ++phase) {
    for (int j = jmin; j <= jmax; ++j) {
      __syncthreads();  // previous block's tiles fully consumed
      load_rows(&sm.k[0][0], p.k + kvoff, LANE, j * LANE, p.S, p.k_fmt);
      if (phase >= 2)
        load_rows(&sm.v[0][0], p.v + kvoff, LANE, j * LANE, p.S, p.v_fmt);
      if (phase == 3)
        load_rows_t(&sm.kt[0][0], p.k + kvoff, LANE, j * LANE, p.k_fmt);
      __syncthreads();

      float s[16][4];
      tile_abt(s, qw, &sm.k[0][0]);
      uint32_t valid[2] = {0u, 0u};  // bit nt*2 + (e & 1) per row half
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
          const int row = rows[hf];
          const bool ok = is_valid(p, row, col);
          uint32_t rnd = p.sr_s ? fp8::hash_bits(seed, SALT_S, bh, row, col) : 0u;
          float sv = fp8::to_float(
              fp8::quant(__fmul_rn(s[nt][e], p.f_s), rnd, p.fmt_s, p.sr_s,
                         p.sat_s), p.fmt_s);
          s[nt][e] = ok ? __fmul_rn(sv, p.s_s) : -1e30f;
          if (ok) valid[hf] |= 1u << (nt * 2 + (e & 1));
        }

      if (phase == 0) {
        float mx[2] = {-1e30f, -1e30f};
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fp8::nanmax(mx[e >> 1], s[nt][e]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) m[hf] = fp8::nanmax(m[hf], warp_max4(mx[hf]));
        continue;
      }

      // e = valid ? exp(x - m) : 0; from phase 2 on, P and P's value.
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const bool ok = (valid[hf] >> (nt * 2 + (e & 1))) & 1u;
          const float ev = ok ? expf(__fsub_rn(s[nt][e], m[hf])) : 0.f;
          if (phase == 1) {
            rsum[hf] = __fadd_rn(rsum[hf], ev);
          } else {
            const int col = j * LANE + nt * 8 + 2 * t + (e & 1);
            uint32_t rnd = p.sr_p ? fp8::hash_bits(seed, SALT_P, bh, rows[hf], col) : 0u;
            float pv = fp8::to_float(
                fp8::quant(__fmul_rn(__fdiv_rn(ev, dsafe[hf]), p.f_p), rnd,
                           p.fmt_p, p.sr_p, p.sat_p), p.fmt_p);
            s[nt][e] = __fmul_rn(pv, p.s_p);  // P, dequantized
          }
        }
      if (phase == 1) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[hf] = __fadd_rn(l[hf], warp_sum4(rsum[hf]));
        continue;
      }

      float dp[16][4];
      tile_abt(dp, dow, &sm.v[0][0]);
      uint32_t dsf[8][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        float dsq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, row = rows[hf];
          const int col = j * LANE + nt * 8 + 2 * t + (e & 1);
          const bool ok = (valid[hf] >> (nt * 2 + (e & 1))) & 1u;
          const bool obs = ok && row < p.q_len;
          uint32_t rnd = p.sr_e ? fp8::hash_bits(seed, SALT_DP, bh, row, col) : 0u;
          const float dpv = fp8::to_float(
              fp8::quant(__fmul_rn(dp[nt][e], p.f_dp), rnd, p.fmt_e, p.sr_e,
                         p.sat_e), p.fmt_e);
          const float dpd = __fmul_rn(dpv, p.s_dp);
          if (phase == 2) {
            rsum[hf] = __fadd_rn(rsum[hf], __fmul_rn(s[nt][e], dpd));
            if (obs) amax_dp = fp8::nanmax(amax_dp, fabsf(dpv));
          } else {
            rnd = p.sr_e ? fp8::hash_bits(seed, SALT_DS, bh, row, col) : 0u;
            const float ds = __fmul_rn(s[nt][e], __fsub_rn(dpd, rd[hf]));
            dsq[e] = fp8::to_float(
                fp8::quant(__fmul_rn(ds, p.f_ds), rnd, p.fmt_e, p.sr_e,
                           p.sat_e), p.fmt_e);
            if (obs) amax_ds = fp8::nanmax(amax_ds, fabsf(dsq[e]));
          }
        }
        if (phase == 3) pack_a(dsf, nt, dsq);
      }
      if (phase == 2) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) rd[hf] = __fadd_rn(rd[hf], warp_sum4(rsum[hf]));
        continue;
      }

      // dq += dS8 . K for this block, in two halves of the head dim.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int c = ks * 16 + 2 * t;
#pragma unroll
          for (int dt = 0; dt < 8; ++dt) {
            const __nv_bfloat16* bn = &sm.kt[(half * 8 + dt) * 8 + g][c];
            fp8::mma_bf16(part[dt], dsf[ks], u32_at(bn), u32_at(bn + 8));
          }
        }
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& a = sm.dq[warp * 16 + g + 8 * (e >> 1)]
                            [(half * 8 + dt) * 8 + 2 * t + (e & 1)];
            a = __fadd_rn(a, part[dt][e]);
          }
      }
    }
    if (phase == 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) dsafe[hf] = l[hf] > 0.f ? l[hf] : 1.f;
    }
  }

  // Write dq * f_dq and the row statistics (rows of this thread).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= p.Q) continue;
    const long long r = (long long)(b * p.H + h) * p.Q + row;
    float* dqr = p.dq + r * D;
    const int lr = warp * 16 + g + 8 * hf;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const int col = dt * 8 + 2 * t;
      dqr[col] = __fmul_rn(sm.dq[lr][col], p.f_dq);
      dqr[col + 1] = __fmul_rn(sm.dq[lr][col + 1], p.f_dq);
    }
    if (t == 0) {
      p.m[r] = m[hf];
      p.l[r] = l[hf];
      p.rd[r] = rd[hf];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax_dp = fp8::nanmax(amax_dp, __shfl_xor_sync(0xffffffffu, amax_dp, off));
    amax_ds = fp8::nanmax(amax_ds, __shfl_xor_sync(0xffffffffu, amax_ds, off));
  }
  if (lane == 0) {
    sm.red[0][warp] = amax_dp;
    sm.red[1][warp] = amax_ds;
  }
  __syncthreads();
  if (tid == 0) {
    float a = sm.red[0][0], c = sm.red[1][0];
    for (int w = 1; w < 4; ++w) {
      a = fp8::nanmax(a, sm.red[0][w]);
      c = fp8::nanmax(c, sm.red[1][w]);
    }
    const long long idx = (long long)(b * p.H + h) * gridDim.x + iq;
    p.amax_dp[idx] = a;
    p.amax_ds[idx] = c;
  }
}

// ---------------------------------------------------------------------------
// kernel 2: dK / dV
// ---------------------------------------------------------------------------

struct SmemDKV {
  __nv_bfloat16 k[BKV][KS];   // [kv][d]: A operand of S^T
  __nv_bfloat16 v[BKV][KS];   // [kv][d]: A operand of dP^T
  __nv_bfloat16 q[TQ][KS];    // [q row][d]
  __nv_bfloat16 dO[TQ][KS];
  float dk[BKV][FS];
  float dv[BKV][FS];
  float m[TQ], dsafe[TQ], rd[TQ];
};

// acc[dt] (+)= frag . rows(q or dO)[k = q row][n = d] for one half of D.
__device__ __forceinline__ void tile_ab_half(float part[8][4],
                                             const uint32_t frag[8][4],
                                             const __nv_bfloat16* src,
                                             int half) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int r = ks * 16 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int n = (half * 8 + dt) * 8 + g;
      const uint32_t b0 = pair(src + r * KS + n, src + (r + 1) * KS + n);
      const uint32_t b1 = pair(src + (r + 8) * KS + n, src + (r + 9) * KS + n);
      fp8::mma_bf16(part[dt], frag[ks], b0, b1);
    }
  }
}

__device__ __forceinline__ void add_half(float (*acc)[FS], int warp,
                                         const float part[8][4], int half) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& a = acc[warp * 16 + g + 8 * (e >> 1)]
                    [(half * 8 + dt) * 8 + 2 * t + (e & 1)];
      a = __fadd_rn(a, part[dt][e]);
    }
}

__global__ void __launch_bounds__(128) attn_bwd_dkv_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDKV& sm = *reinterpret_cast<SmemDKV*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int kv0 = kb * BKV, jblk = kv0 / LANE;
  const uint32_t seed = *p.seed;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;

  load_rows(&sm.k[0][0], p.k + kvoff, BKV, kv0, p.S, p.k_fmt);
  load_rows(&sm.v[0][0], p.v + kvoff, BKV, kv0, p.S, p.v_fmt);
  for (int i = tid; i < BKV * FS; i += 128) {
    (&sm.dk[0][0])[i] = 0.f;
    (&sm.dv[0][0])[i] = 0.f;
  }
  int cols[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) cols[i] = kv0 + warp * 16 + g + 8 * i;
  const __nv_bfloat16* kw = &sm.k[warp * 16][0];
  const __nv_bfloat16* vw = &sm.v[warp * 16][0];
  const int nt_q = (p.Q + TQ - 1) / TQ;

  for (int member = 0; member < group; ++member) {
    const int h = hk * group + member;
    const uint32_t bh = (uint32_t)(b * p.H + h);
    const long long qoff = (long long)(b * p.H + h) * p.Q * D;
    for (int tq = 0; tq < nt_q; ++tq) {
      const int t0 = tq * TQ;
      int jmin, jmax;
      kv_span(p, t0, jmin, jmax);
      if (jblk < jmin || jblk > jmax) continue;   // fully masked pair
      __syncthreads();  // previous tile's q / dO / stats consumed
      load_rows(&sm.q[0][0], p.q + qoff, TQ, t0, p.Q, p.q_fmt);
      load_rows(&sm.dO[0][0], p.dO + qoff, TQ, t0, p.Q, p.do_fmt);
      for (int r = tid; r < TQ; r += 128) {
        const int row = t0 + r;
        const long long ri = (long long)(b * p.H + h) * p.Q + row;
        const bool in = row < p.Q;
        const float lv = in ? p.l[ri] : 1.f;
        sm.m[r] = in ? p.m[ri] : 0.f;
        sm.dsafe[r] = lv > 0.f ? lv : 1.f;
        sm.rd[r] = in ? p.rd[ri] : 0.f;
      }
      __syncthreads();

      // S^T (this warp's 16 kv rows x 128 q rows) -> P (dequantized).
      float s[16][4];
      tile_abt(s, kw, &sm.q[0][0]);
      uint32_t pf[8][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        float pq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = nt * 8 + 2 * t + (e & 1), row = t0 + qr;
          const int col = cols[e >> 1];
          const bool ok = row < p.Q && is_valid(p, row, col);
          uint32_t rnd = p.sr_s ? fp8::hash_bits(seed, SALT_S, bh, row, col) : 0u;
          const float sv = fp8::to_float(
              fp8::quant(__fmul_rn(s[nt][e], p.f_s), rnd, p.fmt_s, p.sr_s,
                         p.sat_s), p.fmt_s);
          const float x = ok ? __fmul_rn(sv, p.s_s) : -1e30f;
          const float ev = ok ? expf(__fsub_rn(x, sm.m[qr])) : 0.f;
          rnd = p.sr_p ? fp8::hash_bits(seed, SALT_P, bh, row, col) : 0u;
          pq[e] = fp8::to_float(
              fp8::quant(__fmul_rn(__fdiv_rn(ev, sm.dsafe[qr]), p.f_p), rnd,
                         p.fmt_p, p.sr_p, p.sat_p), p.fmt_p);
          s[nt][e] = __fmul_rn(pq[e], p.s_p);
        }
        pack_a(pf, nt, pq);
      }
      // dV += P8^T . dO8
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[8][4];
        tile_ab_half(part, pf, &sm.dO[0][0], half);
        add_half(sm.dv, warp, part, half);
      }
      // dP^T = V . dO^T -> dS8^T
      float dp[16][4];
      tile_abt(dp, vw, &sm.dO[0][0]);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        float dsq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = nt * 8 + 2 * t + (e & 1), row = t0 + qr;
          const int col = cols[e >> 1];
          uint32_t rnd = p.sr_e ? fp8::hash_bits(seed, SALT_DP, bh, row, col) : 0u;
          const float dpd = __fmul_rn(
              fp8::to_float(fp8::quant(__fmul_rn(dp[nt][e], p.f_dp), rnd,
                                       p.fmt_e, p.sr_e, p.sat_e), p.fmt_e),
              p.s_dp);
          rnd = p.sr_e ? fp8::hash_bits(seed, SALT_DS, bh, row, col) : 0u;
          const float ds = __fmul_rn(s[nt][e], __fsub_rn(dpd, sm.rd[qr]));
          dsq[e] = fp8::to_float(
              fp8::quant(__fmul_rn(ds, p.f_ds), rnd, p.fmt_e, p.sr_e,
                         p.sat_e), p.fmt_e);
        }
        pack_a(pf, nt, dsq);
      }
      // dK += dS8^T . Q8
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[8][4];
        tile_ab_half(part, pf, &sm.q[0][0], half);
        add_half(sm.dk, warp, part, half);
      }
    }
  }

  // dK * f_dk, dV * f_dv (rows of this thread).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int lr = warp * 16 + g + 8 * hf;
    const long long r = (long long)(b * p.Hkv + hk) * p.S + kv0 + lr;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const int col = dt * 8 + 2 * t;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p.dk[r * D + col + c] = __fmul_rn(sm.dk[lr][col + c], p.f_dk);
        p.dv[r * D + col + c] = __fmul_rn(sm.dv[lr][col + c], p.f_dv);
      }
    }
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dO,
               const void* seed, void* dq, void* m, void* l, void* rd,
               void* amax_dp, void* amax_ds, void* dk, void* dv, const int* iv,
               const float* fv) {
  Args p;
  p.q = static_cast<const uint8_t*>(q);
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.dO = static_cast<const uint8_t*>(dO);
  p.seed = static_cast<const uint32_t*>(seed);
  p.dq = static_cast<float*>(dq);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.rd = static_cast<float*>(rd);
  p.amax_dp = static_cast<float*>(amax_dp);
  p.amax_ds = static_cast<float*>(amax_ds);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = iv[0]; p.H = iv[1]; p.Hkv = iv[2]; p.Q = iv[3]; p.S = iv[4];
  p.q_len = iv[5]; p.s_len = iv[6]; p.causal = iv[7]; p.window = iv[8];
  p.q_fmt = iv[9]; p.k_fmt = iv[10]; p.v_fmt = iv[11]; p.do_fmt = iv[12];
  p.fmt_s = iv[13]; p.fmt_p = iv[14]; p.fmt_e = iv[15];
  p.sr_s = iv[16]; p.sr_p = iv[17]; p.sr_e = iv[18];
  p.sat_s = iv[19]; p.sat_p = iv[20]; p.sat_e = iv[21];
  p.f_s = fv[0]; p.s_s = fv[1]; p.f_p = fv[2]; p.s_p = fv[3];
  p.f_dp = fv[4]; p.s_dp = fv[5]; p.f_ds = fv[6]; p.f_dq = fv[7];
  p.f_dk = fv[8]; p.f_dv = fv[9];
  return p;
}

}  // namespace

extern "C" int attn_bwd_dq_smem_bytes() { return static_cast<int>(sizeof(SmemDQ)); }
extern "C" int attn_bwd_dkv_smem_bytes() { return static_cast<int>(sizeof(SmemDKV)); }

// Integer arguments `iv` (22): B, H, Hkv, Q, S, q_len, s_len, causal,
// window, q/k/v/dO formats, fmt_s, fmt_p, fmt_e, sr_s, sr_p, sr_e, sat_s,
// sat_p, sat_e. Float arguments `fv` (10): f_s, s_s, f_p, s_p, f_dp, s_dp,
// f_ds, f_dq, f_dk, f_dv. Both arrays are read on the host. D must be 128
// and S a multiple of 128 (the wrapper pads). Return cudaGetLastError().

// Kernel 1: grid (ceil(Q/64), H, B). Writes dq, m, l, rd, amax_dp/ds.
extern "C" int attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dO, const void* seed, void* dq,
                                  void* m, void* l, void* rd, void* amax_dp,
                                  void* amax_ds, const int* iv,
                                  const float* fv, void* stream) {
  Args p = make_args(q, k, v, dO, seed, dq, m, l, rd, amax_dp, amax_ds,
                     nullptr, nullptr, iv, fv);
  const int smem = static_cast<int>(sizeof(SmemDQ));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Q + BQ - 1) / BQ, p.H, p.B);
  attn_bwd_dq_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2: grid (S/64, Hkv, B). Reads m, l, rd of kernel 1; writes dk, dv.
extern "C" int attn_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* seed, const void* m,
                                   const void* l, const void* rd, void* dk,
                                   void* dv, const int* iv, const float* fv,
                                   void* stream) {
  Args p = make_args(q, k, v, dO, seed, nullptr, const_cast<void*>(m),
                     const_cast<void*>(l), const_cast<void*>(rd), nullptr,
                     nullptr, dk, dv, iv, fv);
  const int smem = static_cast<int>(sizeof(SmemDKV));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.S / BKV, p.Hkv, p.B);
  attn_bwd_dkv_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
