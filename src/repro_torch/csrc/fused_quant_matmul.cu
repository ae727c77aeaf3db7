// Fused quantize-in-epilogue FP8 GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_quant_matmul/kernel.py::fused_quant_matmul_kernel
//   (bodies _body, _body_amax, _body_amax_counts)
// and computes the same function: out = Q((A . B) * (1/scale)) in fp8 for
// the layouts nn (A@B), nt (A@B^T) and tn (A^T@B), with the per-tile amax of
// the quantized output in grid units and optional saturated / flushed
// counts, all masked to the logical (lm, ln) region.
//
// Dataflow (the reference's): fp8 operand tiles are upcast to bf16 in shared
// memory (exact), multiplied with mma.sync m16n8k16 into an f32 accumulator
// (every product is exact, only the summation order differs from the
// reference), and the Q node runs on the accumulator in registers: the f32
// output never reaches device memory, one byte per element is written.
// Layouts are taken through the operand strides (element (m,k) of A at
// a[m*sam + k*sak], (k,n) of B at b[k*sbk + n*sbn]); the 16-byte global
// loads run along whichever dim is contiguous and the tile is transposed on
// its way into shared memory, so no transposed copy is ever made.
//
// The same mainloop with a plain store epilogue (OUT_F32 / OUT_BF16) is the
// unfused FP8 GEMM, replacing
//   src/repro/kernels/fp8_matmul/kernel.py::fp8_matmul_kernel
// (A @ B, fp8 x fp8 -> f32 accumulate -> f32 or bf16, no Q node): layout nn
// only, launched by fp8mm_launch. At the training shapes (M = 2048 rows)
// it is bound by operations, like the fused kernel.
//
// What bounds it: at serving shapes M = rows x chunk = 128, so each weight
// byte is used by 128 rows only — 2*128 flops per weight byte, below the
// H100's ~295 flops/byte ridge for bf16 tensor cores: the kernel is bound by
// the bytes of the weight read. This first version is simple on purpose
// (64x64x64 tiles, one shared-memory stage, bf16 mma.sync); native fp8
// wgmma, TMA loads and a multi-stage pipeline are later work.
#include "fp8_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 8;  // bf16 row stride of the shared tiles

// Epilogue of the kernel: the Q node to fp8 (kernel 1), or a plain store of
// the f32 accumulator as f32 or bf16 (the unfused GEMM).
enum Out { OUT_FP8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Args {
  const uint8_t* a;
  const uint8_t* b;
  const uint8_t* rand8;
  void* out;
  float* amax;
  float* sat;
  float* flush;
  int M, N, K;
  long long sam, sak, sbk, sbn;
  int a_fmt, b_fmt, out_fmt, sr, saturate;
  float scale;
  int lm, ln, with_counts;
};

// Load a (rows x 64) fp8 tile into `dst[row][k]` (bf16, k contiguous).
// `kmajor`: the source is contiguous along k; else along the row dim.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDS],
                                          const uint8_t* src, long long s_row,
                                          long long s_k, int fmt, int tid) {
  const bool kmajor = (s_k == 1);
#pragma unroll
  for (int v = tid; v < 256; v += 128) {
    int r = v >> 2, c = (v & 3) * 16;
    uint32_t w[8];
    if (kmajor) {  // row r, k = c..c+15
      uint4 x = *reinterpret_cast<const uint4*>(src + r * s_row + c);
      fp8::bytes_to_bf16(x, fmt, w);
      uint4* d = reinterpret_cast<uint4*>(&dst[r][c]);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {  // k = r, rows c..c+15
      uint4 x = *reinterpret_cast<const uint4*>(src + r * s_k + c);
      const uint8_t* p = reinterpret_cast<const uint8_t*>(&x);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[c + i][r] = __float2bfloat16_rn(fp8::to_float(p[i], fmt));
    }
  }
}

template <int OUT>
__global__ void __launch_bounds__(128) fqmm_kernel(Args p) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];  // n-major, k contig.
  __shared__ float red[3][4];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    load_tile(As, p.a + m0 * p.sam + k0 * p.sak, p.sam, p.sak, p.a_fmt, tid);
    load_tile(Bs, p.b + n0 * p.sbn + k0 * p.sbk, p.sbn, p.sbk, p.b_fmt, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int c = kk + 2 * t;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) fp8::mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  if constexpr (OUT != OUT_FP8) {
    // Plain store of the accumulator: two adjacent columns per fragment.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + wm * 32 + mt * 16 + g + hf * 8;
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          const long long o = (long long)row * p.N + col;
          const float y0 = acc[mt][nt][hf * 2], y1 = acc[mt][nt][hf * 2 + 1];
          if constexpr (OUT == OUT_F32)
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
                make_float2(y0, y1);
          else
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) +
                                         o) = fp8::pack_bf16(y0, y1);
        }
    return;
  }

  // Epilogue: Q node on the accumulator, fp8 bytes out, masked observations.
  uint8_t* const out8 = static_cast<uint8_t*>(p.out);
  const float inv = __fdiv_rn(1.0f, p.scale);
  const fp8::FmtSpec fo = fp8::spec(p.out_fmt);
  float amax = 0.f, nsat = 0.f, nflush = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 32 + mt * 16 + g + hf * 8;
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        const long long o = (long long)row * p.N + col;
        uint8_t q[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float y = __fmul_rn(acc[mt][nt][hf * 2 + j], inv);
          uint32_t rnd = p.sr ? p.rand8[o + j] : 0u;
          q[j] = fp8::quant(y, rnd, p.out_fmt, p.sr, p.saturate);
          if (row < p.lm && col + j < p.ln) {
            float qf = fp8::to_float(q[j], p.out_fmt);
            float aq = fabsf(qf);
            amax = fp8::nanmax(amax, aq);
            if (p.with_counts) {
              nsat += (aq >= fo.max_normal || !isfinite(qf)) ? 1.f : 0.f;
              nflush += (aq < fo.min_normal) ? 1.f : 0.f;
            }
          }
        }
        *reinterpret_cast<uint16_t*>(out8 + o) =
            (uint16_t)q[0] | ((uint16_t)q[1] << 8);
      }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fp8::nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    nsat += __shfl_xor_sync(0xffffffffu, nsat, off);
    nflush += __shfl_xor_sync(0xffffffffu, nflush, off);
  }
  if (lane == 0) {
    red[0][warp] = amax;
    red[1][warp] = nsat;
    red[2][warp] = nflush;
  }
  __syncthreads();
  if (tid == 0) {
    float a = red[0][0], s = red[1][0], f = red[2][0];
    for (int w = 1; w < 4; ++w) {
      a = fp8::nanmax(a, red[0][w]);
      s += red[1][w];
      f += red[2][w];
    }
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    p.amax[tile] = a;
    if (p.with_counts) {
      p.sat[tile] = s;
      p.flush[tile] = f;
    }
  }
}

}  // namespace

// Launch on `stream`; M, N, K multiples of 64 (the wrapper pads). Returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fqmm_launch(const void* a, const void* b, const void* rand8,
                           void* out, float* amax, float* sat, float* flush,
                           int M, int N, int K, long long sam, long long sak,
                           long long sbk, long long sbn, int a_fmt, int b_fmt,
                           int out_fmt, int sr, int saturate, float scale,
                           int lm, int ln, int with_counts, void* stream) {
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
         static_cast<const uint8_t*>(rand8), static_cast<uint8_t*>(out),
         amax, sat, flush, M, N, K, sam, sak, sbk, sbn, a_fmt, b_fmt, out_fmt,
         sr, saturate, scale, lm, ln, with_counts};
  dim3 grid(N / BN, M / BM);
  fqmm_kernel<OUT_FP8><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The unfused GEMM: out (M, N) = A (M, K) @ B (K, N), both row-major fp8,
// out f32 (out_bf16 = 0) or bf16 (out_bf16 = 1). M, N, K multiples of 64
// (the wrapper pads). Returns cudaGetLastError().
extern "C" int fp8mm_launch(const void* a, const void* b, void* out, int M,
                            int N, int K, int a_fmt, int b_fmt, int out_bf16,
                            void* stream) {
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
         nullptr, out, nullptr, nullptr, nullptr, M, N, K,
         (long long)K, 1LL, (long long)N, 1LL, a_fmt, b_fmt, 0, 0, 0, 1.f,
         M, N, 0};
  dim3 grid(N / BN, M / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    fqmm_kernel<OUT_BF16><<<grid, 128, 0, s>>>(p);
  else
    fqmm_kernel<OUT_F32><<<grid, 128, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
