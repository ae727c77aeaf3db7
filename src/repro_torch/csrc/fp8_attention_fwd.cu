// Streamed-KV FP8 flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fp8_attention/kernel.py::fp8_attention_fwd_kernel
//   (bodies _fwd_body, _masked_none_fwd, _fwd_body_chunk)
// and computes the same function, ref.fwd_stripe_online per 128-column
// block in ascending order:
//   S8 = Q_A((q8 . k8^T) * f_s);  x = valid ? S8 * s_s : -1e30
//   m' = max(m, rowmax x);  c = exp(m - m');  e = valid ? exp(x - m') : 0
//   E8 = Q_A(e * f_p)  (unnormalized probs);  l = l*c + rowsum e
//   acc = acc*c + E8 . v8;  m = m'
//   O = (acc * f_o) / (l > 0 ? l : 1)  -> bf16
// with the S/P amaxes in grid units masked to the attended region
// (row < q_len and valid). Masks: causal (+ sliding window), full, kv
// (per-column validity), chunk (slot positions against q positions
// start + row for rows < n_valid, -1 otherwise). GQA reads kv head
// h / (H / Hkv) directly — no repeated K/V. SR bits come from the counter
// hash of (seed, salt 0x51 / 0x52, b*H + h, row, col); the seed is read
// from device memory, where the caller's generator drew it.
//
// Structure: one block per (b, h, 64-row q tile), four warps of 16 rows.
// The TPU's sequential kv grid axis becomes a loop inside the block over
// the 128-column blocks of kv_stripe_span (blocks that are masked for every
// row of the tile are skipped — exact, as they contribute nothing). K and
// V^T of the current block sit in shared memory as bf16; S and the P.V
// partial products use mma.sync m16n8k16 with f32 accumulators, P is fed
// from registers (the S accumulator layout is the A-operand layout).
// acc*c + pv is formed after the block's P.V product, as in the reference,
// and the file is built with --fmad=false so no product-add contracts.
//
// What bounds it: at serving shapes (T = 32 query rows per request against
// a 512-slot gathered cache) each K/V byte meets 6 query heads x 32 rows —
// ~380 flops per K/V byte, near the bf16 ridge, but the per-element
// quantize/exp epilogue work dominates this simple version. Faster
// variants (fp8 wgmma, TMA, more rows per block) are later work.
#include "fp8_common.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int LANE = 128;  // kv columns per online-softmax step
constexpr int D = 128;     // head dim (the wrapper zero-pads smaller heads)
constexpr int KS = D + 8;  // bf16 row stride of Qs / Ks
constexpr int VS = LANE + 8;
constexpr uint32_t SALT_S = 0x51, SALT_P = 0x52;

enum Mask { CAUSAL = 0, FULL = 1, KV = 2, CHUNK = 3 };

struct Args {
  const uint8_t* q;   // (B, H, Q, D)
  const uint8_t* k;   // (B, Hkv, S, D), S a multiple of LANE
  const uint8_t* v;
  const int* kvm;     // (B, S) validity (kv) / slot positions (chunk)
  const int* chunk;   // (B, 2) [start, n_valid]
  __nv_bfloat16* o;   // (B, H, Q, D)
  float* amax_s;      // (B, H, nq)
  float* amax_p;
  int B, H, Hkv, Q, S, q_len, s_len, mask, window;
  int q_fmt, k_fmt, v_fmt, fmt_s, fmt_p, sr_s, sr_p, sat_s, sat_p;
  float f_s, s_s, f_p, f_o;
  const uint32_t* seed;
};

struct Smem {
  __nv_bfloat16 q[BQ][KS];
  __nv_bfloat16 k[LANE][KS];
  __nv_bfloat16 vt[D][VS];  // V^T: d-major, kv column contiguous
  int kvm[LANE];
  float red[2][4];
};

__device__ __forceinline__ bool is_valid(const Args& p, int row, int qpos,
                                         int col, int mv) {
  if (col >= p.s_len) return false;
  switch (p.mask) {
    case CAUSAL:
      return col <= row && (p.window == 0 || col > row - p.window);
    case KV:
      return mv != 0;
    case CHUNK:
      return mv >= 0 && mv <= qpos && (p.window == 0 || mv > qpos - p.window);
    default:
      return true;
  }
}

__global__ void __launch_bounds__(128) attn_fwd_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = iq * BQ;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  const int nk = p.S / LANE;
  const uint32_t seed = *p.seed;

  // Q tile -> shared bf16 (rows past Q read as zeros).
  const uint8_t* qb = p.q + ((long long)(b * p.H + h) * p.Q) * D;
  for (int v = tid; v < BQ * D / 16; v += 128) {
    int r = v / (D / 16), c = (v % (D / 16)) * 16;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < p.Q)
      x = *reinterpret_cast<const uint4*>(qb + (long long)(row0 + r) * D + c);
    uint32_t w[8];
    fp8::bytes_to_bf16(x, p.q_fmt, w);
    uint4* d = reinterpret_cast<uint4*>(&sm.q[r][c]);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }

  // This thread's two rows (g and g+8 of the warp's 16).
  int rows[2], qpos[2];
  int start = 0, n_valid = 0;
  if (p.mask == CHUNK) {
    start = p.chunk[2 * b];
    n_valid = p.chunk[2 * b + 1];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + warp * 16 + g + 8 * i;
    qpos[i] = rows[i] < n_valid ? start + rows[i] : -1;
  }

  // kv_stripe_span at LANE granularity.
  int jmin = 0, jmax = nk - 1;
  if (p.mask == CAUSAL) {
    jmax = min((row0 + BQ - 1) / LANE, nk - 1);
    if (p.window) jmin = max(row0 - p.window + 1, 0) / LANE;
  }

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float amax_s = 0.f, amax_p = 0.f;

  const uint8_t* kb = p.k + ((long long)(b * p.Hkv + hk) * p.S) * D;
  const uint8_t* vb = p.v + ((long long)(b * p.Hkv + hk) * p.S) * D;

  for (int j = jmin; j <= jmax; ++j) {
    __syncthreads();  // previous block's K / V^T fully consumed
    for (int v = tid; v < LANE * D / 16; v += 128) {
      int r = v / (D / 16), c = (v % (D / 16)) * 16;
      long long off = (long long)(j * LANE + r) * D + c;
      uint4 xk = *reinterpret_cast<const uint4*>(kb + off);
      uint32_t w[8];
      fp8::bytes_to_bf16(xk, p.k_fmt, w);
      uint4* d = reinterpret_cast<uint4*>(&sm.k[r][c]);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      uint4 xv = *reinterpret_cast<const uint4*>(vb + off);
      const uint8_t* pv = reinterpret_cast<const uint8_t*>(&xv);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        sm.vt[c + i][r] = __float2bfloat16_rn(fp8::to_float(pv[i], p.v_fmt));
    }
    if (p.mask == KV || p.mask == CHUNK) {
      sm.kvm[tid] = p.kvm[(long long)b * p.S + j * LANE + tid];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 128 columns.
    float s[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const int r = warp * 16 + g, c = kk + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sm.q[r][c]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sm.q[r + 8][c]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sm.q[r][c + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sm.q[r + 8][c + 8]);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int n = nt * 8 + g;
        fp8::mma_bf16(s[nt], a,
                      *reinterpret_cast<const uint32_t*>(&sm.k[n][c]),
                      *reinterpret_cast<const uint32_t*>(&sm.k[n][c + 8]));
      }
    }

    // Quantize S, mask, running max (element e: row hf = e >> 1, col e & 1).
    uint32_t valid_lo = 0, valid_hi = 0;  // bit (nt*2 + (e&1)) per row half
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, cl = nt * 8 + 2 * t + (e & 1);
        const int col = j * LANE + cl, row = rows[hf];
        const int mv = (p.mask == KV || p.mask == CHUNK) ? sm.kvm[cl] : 0;
        const bool ok = is_valid(p, row, qpos[hf], col, mv);
        uint32_t rnd = p.sr_s ? fp8::hash_bits(seed, SALT_S, bh, row, col) : 0u;
        uint8_t q8 = fp8::quant(__fmul_rn(s[nt][e], p.f_s), rnd, p.fmt_s,
                                p.sr_s, p.sat_s);
        float sv = fp8::to_float(q8, p.fmt_s);
        if (ok && row < p.q_len) amax_s = fp8::nanmax(amax_s, fabsf(sv));
        float x = ok ? __fmul_rn(sv, p.s_s) : -1e30f;
        s[nt][e] = x;
        if (ok) {
          if (hf) valid_hi |= 1u << (nt * 2 + (e & 1));
          else valid_lo |= 1u << (nt * 2 + (e & 1));
        }
        mx[hf] = fp8::nanmax(mx[hf], x);
      }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fp8::nanmax(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fp8::nanmax(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      float mn = fp8::nanmax(m[hf], mx[hf]);
      corr[hf] = expf(__fsub_rn(m[hf], mn));
      m[hf] = mn;
    }

    // Unnormalized probs, quantized; packed straight into A fragments.
    uint32_t pa[8][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      float pq[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, bit = nt * 2 + (e & 1);
        const bool ok = ((hf ? valid_hi : valid_lo) >> bit) & 1u;
        const int col = j * LANE + nt * 8 + 2 * t + (e & 1), row = rows[hf];
        float ev = ok ? expf(__fsub_rn(s[nt][e], m[hf])) : 0.f;
        rsum[hf] = __fadd_rn(rsum[hf], ev);
        uint32_t rnd = p.sr_p ? fp8::hash_bits(seed, SALT_P, bh, row, col) : 0u;
        uint8_t p8 = fp8::quant(__fmul_rn(ev, p.f_p), rnd, p.fmt_p, p.sr_p,
                                p.sat_p);
        pq[e] = fp8::to_float(p8, p.fmt_p);
        if (ok && row < p.q_len) amax_p = fp8::nanmax(amax_p, fabsf(pq[e]));
      }
      // tile nt covers kv cols nt*8..: k-step nt/2, low/high 8 columns.
      const int ks = nt >> 1, hi = nt & 1;
      pa[ks][hi ? 2 : 0] = fp8::pack_bf16(pq[0], pq[1]);
      pa[ks][hi ? 3 : 1] = fp8::pack_bf16(pq[2], pq[3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rsum[hf] = __fadd_rn(rsum[hf], __shfl_xor_sync(0xffffffffu, rsum[hf], 1));
      rsum[hf] = __fadd_rn(rsum[hf], __shfl_xor_sync(0xffffffffu, rsum[hf], 2));
      l[hf] = __fadd_rn(__fmul_rn(l[hf], corr[hf]), rsum[hf]);
    }

    // acc = acc * c + E8 . V, in two halves of the head dim.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float pv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int c = ks * 16 + 2 * t;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const int n = (half * 8 + dt) * 8 + g;
          fp8::mma_bf16(pv[dt], pa[ks],
                        *reinterpret_cast<const uint32_t*>(&sm.vt[n][c]),
                        *reinterpret_cast<const uint32_t*>(&sm.vt[n][c + 8]));
        }
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& a = acc[half * 8 + dt][e];
          a = __fadd_rn(__fmul_rn(a, corr[e >> 1]), pv[dt][e]);
        }
    }
  }

  // O = (acc * f_o) / d_safe -> bf16; fully masked rows give exact zeros.
  __nv_bfloat16* ob = p.o + ((long long)(b * p.H + h) * p.Q) * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= p.Q) continue;
    const float dsafe = l[hf] > 0.f ? l[hf] : 1.f;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const int col = dt * 8 + 2 * t;
      float o0 = __fdiv_rn(__fmul_rn(acc[dt][hf * 2], p.f_o), dsafe);
      float o1 = __fdiv_rn(__fmul_rn(acc[dt][hf * 2 + 1], p.f_o), dsafe);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * D + col) =
          __floats2bfloat162_rn(o0, o1);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax_s = fp8::nanmax(amax_s, __shfl_xor_sync(0xffffffffu, amax_s, off));
    amax_p = fp8::nanmax(amax_p, __shfl_xor_sync(0xffffffffu, amax_p, off));
  }
  if (lane == 0) {
    sm.red[0][warp] = amax_s;
    sm.red[1][warp] = amax_p;
  }
  __syncthreads();
  if (tid == 0) {
    float as = sm.red[0][0], ap = sm.red[1][0];
    for (int w = 1; w < 4; ++w) {
      as = fp8::nanmax(as, sm.red[0][w]);
      ap = fp8::nanmax(ap, sm.red[1][w]);
    }
    const long long idx = (long long)(b * p.H + h) * gridDim.x + iq;
    p.amax_s[idx] = as;
    p.amax_p[idx] = ap;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int attn_fwd_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch on `stream`: grid (ceil(Q/64), H, B), 128 threads, ~87 KB of
// dynamic shared memory. D must be 128 and S a multiple of 128 (the
// wrapper pads). Returns cudaGetLastError().
extern "C" int attn_fwd_launch(
    const void* q, const void* k, const void* v, const int* kvm,
    const int* chunk, void* o, float* amax_s, float* amax_p, int B, int H,
    int Hkv, int Q, int S, int q_len, int s_len, int mask, int window,
    int q_fmt, int k_fmt, int v_fmt, int fmt_s, int fmt_p, int sr_s, int sr_p,
    int sat_s, int sat_p, float f_s, float s_s, float f_p, float f_o,
    const void* seed, void* stream) {
  Args p{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
         static_cast<const uint8_t*>(v), kvm, chunk,
         static_cast<__nv_bfloat16*>(o), amax_s, amax_p, B, H, Hkv, Q, S,
         q_len, s_len, mask, window, q_fmt, k_fmt, v_fmt, fmt_s, fmt_p, sr_s,
         sr_p, sat_s, sat_p, f_s, s_s, f_p, f_o,
         static_cast<const uint32_t*>(seed)};
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
