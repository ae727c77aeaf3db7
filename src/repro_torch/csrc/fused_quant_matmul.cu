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
// The same kernel with a plain store epilogue (OUT_F32 / OUT_BF16) is the
// unfused FP8 GEMM, replacing
//   src/repro/kernels/fp8_matmul/kernel.py::fp8_matmul_kernel
// (A @ B, fp8 x fp8 -> f32 accumulate -> f32 or bf16, no Q node): layout nn
// only, launched by fp8mm_launch.
//
// Mainloop. A block of 256 threads (two warpgroups of 64 output rows each)
// computes a 128 x BN tile, BN = 128 or 256, by k-steps of 64:
//  - a ring of 3 fp8 stages (A 128x64 and B 64xBN bytes) is refilled by
//    cp.async at 16 bytes a thread, 3 k-steps ahead of the products;
//  - each stage is widened into a 16-bit operand tile, f16 (exact for both
//    fp8 formats: e5m2 by a byte shift, e4m3 by cvt.rn.f16x2.e4m3x2), in the
//    source's own major-ness, 128-byte swizzled: an operand contiguous
//    along k is stored K-major, one contiguous along m / n MN-major, so no
//    layout ever transposes a byte (nn: A K-major, B MN-major; nt: both
//    K-major; tn: both MN-major). The widening of k-step k+1 runs while
//    the tensor cores work on k-step k;
//  - wgmma.mma_async m64nBNk16 reads both operands from the swizzled tiles
//    (the descriptors' transpose bits say which are MN-major) into f32
//    accumulators in registers. Every product of two fp8 values is exact
//    in f32; only the order of the sums differs from the plain version.
//
// Epilogue. The accumulators are staged through shared memory (the ring and
// buffers are free by then, and the tile's SR bits are copied in beside
// them) and a run-time loop walks the tile four columns a thread, so rand8,
// the fp8 output and the f32 / bf16 output move in coalesced 4-element
// words; the Q node (__fmul_rn by 1/scale, then fp8::quant, RNE or SR from
// rand8[row * N + col]) and the NaN-propagating amax and counts masked to
// (lm, ln) are the reference's, per 128 x BN tile.
//
// Tile variants, picked by the host from the shape alone
// (kernels/fused_quant_matmul/ops.py::gemm_tile):
//  - 128x128: two f16 buffers, 114,784 bytes of shared memory, 112-118
//    registers, no spills, two blocks an SM (one block's epilogue runs
//    under the other's mainloop); the default;
//  - 128x256: three f16 buffers (one group of products stays in flight
//    while the next is issued), 221,280 bytes, 188-191 registers, no
//    spills, one block an SM; only where its grid fits one wave while
//    128x128's overloads the SMs and K >= 4096 (the 'down' forward and the
//    'up' / 'gate' dgrad of the training step).
//
// What bounds it: shared-memory traffic. A 128x128 k-step does 2.1 MFLOP
// (512 cycles of one SM's tensor cores at the f16 rate) and moves 112 KB
// through shared memory: 16 KB of fp8 into the ring and 16 KB out, 32 KB
// of f16 into the operand tiles and 48 KB of wgmma operand reads, 896
// cycles at 128 bytes a cycle. Read on an H100 SXM (700 W) with
// kernels/fused_quant_matmul/probe.py, kernel 5 at nn 2048x1536x8960
// takes 0.156 ms; leaving parts out, prologue and epilogue take 0.036, the
// refills add 0.044, the widening 0.043 and the products 0.050: widening
// and products share the bandwidth and barely overlap. Kernel 1's Q-node
// epilogue adds about 0.05 ms. Native fp8 wgmma (no widening), TMA
// multicast across a cluster (fewer L2 reads) and a persistent schedule
// (each epilogue under the next tile's mainloop) are the next steps.
#include "wgmma_tiles.cuh"

// Probe builds (kernels/fused_quant_matmul/probe.py) leave parts of the
// mainloop out to time the rest: bit 0 the widening, bit 1 the copies into
// the ring after the prologue, bit 2 the products. Their results are wrong.
#ifndef FQMM_SKIP
#define FQMM_SKIP 0
#endif

namespace {

constexpr int BM = 128, BK = 64, THREADS = 256;
static_assert(BK == fp8::TILE_K, "one swizzle row a k-step");

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

// Shared memory of a 128 x BN tile, by byte offset: HBUFS f16 operand
// buffers (A then B, each 1024-byte aligned) from 0, the fp8 ring from
// RING, the block's reduction scratch from RED. The epilogue stages the f32
// tile (row stride LDC) from 0 and the tile's SR bits from RAND, over the
// buffers and the ring.
template <int BN>
struct Tile {
  static constexpr int STAGES = 3;                 // fp8 ring slots
  static constexpr int HBUFS = BN == 256 ? 3 : 2;  // f16 operand buffers
  static constexpr int MIN_BLOCKS = BN == 256 ? 1 : 2;
  static constexpr int A8 = BM * BK, B8 = BK * BN, STAGE = A8 + B8;
  static constexpr int A16 = 2 * A8, H16 = 2 * STAGE;
  static constexpr int RING = HBUFS * H16, RED = RING + STAGES * STAGE;
  static constexpr int SMEM = RED + 3 * (THREADS / 32) * 4;
  static constexpr int LDC = BN + 8;
  static constexpr int RAND = BM * LDC * 4;
  static_assert(RAND + BM * BN <= RED, "epilogue staging overflows");
};

// ---- PTX helpers (wgmma_tiles.cuh) -----------------------------------------

using fp8::cp16;
using fp8::cp_commit;
using fp8::cp_wait;
using fp8::fence_async_smem;
using fp8::wg_fence;
using fp8::wg_commit;
using fp8::wg_wait;
using fp8::fence_acc;
using fp8::slice_desc;
using fp8::wgmma_n128;
using fp8::wgmma_n256;
using fp8::load_tile;
using fp8::widen_tile;

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// ---- the kernel ------------------------------------------------------------

template <int OUT, int TA, int TB, int BN>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS)
    fqmm_kernel(Args p) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (sbase & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = p.K / BK;

  // Operand origins, row strides (ld) and k-step advances, in bytes.
  const uint8_t* const a0 = TA ? p.a + m0 : p.a + m0 * p.sam;
  const long long a_ld = TA ? p.sak : p.sam, a_step = TA ? BK * p.sak : BK;
  const uint8_t* const b0 = TB ? p.b + n0 : p.b + n0 * p.sbn;
  const long long b_ld = TB ? p.sbk : p.sbn, b_step = TB ? BK * p.sbk : BK;

  auto load = [&](int kt, int slot) {
    const uint32_t s = sbase + T::RING + slot * T::STAGE;
    load_tile<BM, TA, THREADS>(s, a0 + kt * a_step, a_ld, tid);
    load_tile<BN, TB, THREADS>(s + T::A8, b0 + kt * b_step, b_ld, tid);
  };
  auto widen = [&](int slot, int buf) {
    const uint8_t* s = smem + T::RING + slot * T::STAGE;
    uint8_t* h = smem + buf * T::H16;
    widen_tile<BM, TA, THREADS>(h, s, p.a_fmt, tid);
    widen_tile<BN, TB, THREADS>(h + T::A16, s + T::A8, p.b_fmt, tid);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // Stage k-tile t sits in ring slot t % STAGES and in cp.async group t.
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  cp_wait<T::STAGES - 1>();
  __syncthreads();
  widen(0, 0);
  fence_async_smem();
  __syncthreads();

  // Products of k-tile kt read buffer kt % HBUFS; the widening of kt + 1
  // runs beside them, and HBUFS - 2 groups of products stay in flight
  // while the next ones are issued.
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt % T::HBUFS;
    const uint32_t ha = sbase + buf * T::H16 + wg * (64 * 128);
    const uint32_t hb = sbase + buf * T::H16 + T::A16;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      if constexpr (!(FQMM_SKIP & 4))
        wgmma<BN, TA, TB>(acc, slice_desc<TA>(ha, j), slice_desc<TB>(hb, j));
    wg_commit();
    fence_acc(acc);
    // Refill the slot of k-tile kt (widened one step ago) with kt + STAGES.
    if (!(FQMM_SKIP & 2) && kt + T::STAGES < KT)
      load(kt + T::STAGES, kt % T::STAGES);
    cp_commit();
    // Widen k-tile kt + 1 while the products run (its buffer was last read
    // by the products of kt + 1 - HBUFS, complete at the last wait).
    if (kt + 1 < KT) {
      cp_wait<T::STAGES - 1>();
      __syncthreads();
      if constexpr (!(FQMM_SKIP & 1))
        widen((kt + 1) % T::STAGES, (kt + 1) % T::HBUFS);
      fence_async_smem();
    }
    wg_wait<T::HBUFS - 2>();
    fence_acc(acc);
    __syncthreads();
  }
  wg_wait<0>();
  fence_acc(acc);
  cp_wait<0>();
  __syncthreads();  // the other warpgroup's last products read the buffers

  // The tile's SR bits, copied in while the accumulators are staged.
  if (OUT == OUT_FP8 && p.sr) {
    constexpr int ROW16 = BN / 16;
#pragma unroll
    for (int i = 0; i < BM * ROW16 / THREADS; ++i) {
      const int u = tid + i * THREADS, r = u / ROW16, c = (u % ROW16) * 16;
      cp16(sbase + T::RAND + r * BN + c,
           p.rand8 + (long long)(m0 + r) * p.N + n0 + c);
    }
    cp_commit();
  }

  // Stage the accumulators: wgmma's fragment of warp w (of the warpgroup)
  // holds rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1.
  float* const cst = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(&cst[r0 * T::LDC + c]) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&cst[(r0 + 8) * T::LDC + c]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  constexpr int C4 = BN / 4;  // 4-column words of a row
  if constexpr (OUT != OUT_FP8) {
#pragma unroll 1
    for (int i = tid; i < BM * C4; i += THREADS) {
      const int r = i / C4, c = (i % C4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(&cst[r * T::LDC + c]);
      const long long o = (long long)(m0 + r) * p.N + n0 + c;
      if constexpr (OUT == OUT_F32)
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = v;
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) =
            make_uint2(fp8::pack_bf16(v.x, v.y), fp8::pack_bf16(v.z, v.w));
    }
    return;
  }

  // Epilogue: Q node on the accumulator, fp8 bytes out, masked observations.
  // fp8 magnitude bytes order like the values, with inf and NaN above every
  // finite one, so the amax is the largest magnitude byte decoded (a NaN
  // propagates) and the counts are byte compares: saturated at or past
  // max_normal or not finite, flushed below min_normal.
  uint8_t* const out8 = static_cast<uint8_t*>(p.out);
  const float inv = __fdiv_rn(1.0f, p.scale);
  const bool e4 = p.out_fmt == fp8::E4M3;
  const uint32_t sat_byte = e4 ? 0x7Eu : 0x7Bu, flush_byte = e4 ? 0x08u : 0x04u;
  uint32_t mag = 0, nsat = 0, nflush = 0;
#pragma unroll 2
  for (int it = 0; it < BM * C4 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / C4, c = (i % C4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(&cst[r * T::LDC + c]);
    const int row = m0 + r, col = n0 + c;
    const long long o = (long long)row * p.N + col;
    const uint32_t rnd =
        p.sr ? *reinterpret_cast<const uint32_t*>(smem + T::RAND + r * BN + c)
             : 0u;
    const float y[4] = {v.x, v.y, v.z, v.w};
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t q = fp8::quant(__fmul_rn(y[j], inv),
                                    (rnd >> (8 * j)) & 0xFFu, p.out_fmt, p.sr,
                                    p.saturate);
      word |= q << (8 * j);
      if (row < p.lm && col + j < p.ln) {
        const uint32_t b = q & 0x7Fu;
        mag = max(mag, b);
        nsat += b >= sat_byte;
        nflush += b < flush_byte;
      }
    }
    *reinterpret_cast<uint32_t*>(out8 + o) = word;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mag = max(mag, __shfl_xor_sync(0xffffffffu, mag, off));
    nsat += __shfl_xor_sync(0xffffffffu, nsat, off);
    nflush += __shfl_xor_sync(0xffffffffu, nflush, off);
  }
  constexpr int WARPS = THREADS / 32;
  uint32_t* const red = reinterpret_cast<uint32_t*>(smem + T::RED);
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    red[warp] = mag;
    red[WARPS + warp] = nsat;
    red[2 * WARPS + warp] = nflush;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t a = red[0], s = red[WARPS], f = red[2 * WARPS];
    for (int w = 1; w < WARPS; ++w) {
      a = max(a, red[w]);
      s += red[WARPS + w];
      f += red[2 * WARPS + w];
    }
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    p.amax[tile] = fp8::to_float(static_cast<uint8_t>(a), p.out_fmt);
    if (p.with_counts) {
      p.sat[tile] = static_cast<float>(s);
      p.flush[tile] = static_cast<float>(f);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int OUT, int TA, int TB, int BN>
cudaError_t prepare() {
  auto* kern = fqmm_kernel<OUT, TA, TB, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int OUT, int TA, int TB, int BN>
cudaError_t launch(const Args& p, cudaStream_t s) {
  cudaError_t err = prepare<OUT, TA, TB, BN>();
  if (err != cudaSuccess) return err;
  fqmm_kernel<OUT, TA, TB, BN>
      <<<dim3(p.N / BN, p.M / BM), THREADS, Tile<BN>::SMEM, s>>>(p);
  return cudaGetLastError();
}

// One of the layouts nn (TA=0, TB=1), nt (0, 0), tn (1, 1), by tile width.
template <int OUT, int TA, int TB>
cudaError_t launch_bn(const Args& p, int bn, cudaStream_t s) {
  if (bn == 256) return launch<OUT, TA, TB, 256>(p, s);
  return launch<OUT, TA, TB, 128>(p, s);
}

template <int OUT, int TA, int TB, int BN>
cudaError_t info(int* out) {
  cudaError_t err = prepare<OUT, TA, TB, BN>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fqmm_kernel<OUT, TA, TB, BN>);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, fqmm_kernel<OUT, TA, TB, BN>, THREADS, Tile<BN>::SMEM);
  out[0] = Tile<BN>::SMEM;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = resident;
  return err;
}

bool shape_ok(int M, int N, int K, int bn) {
  return (bn == 128 || bn == 256) && M > 0 && N > 0 && K > 0 && M % BM == 0 &&
         N % bn == 0 && K % BK == 0;
}

}  // namespace

// Launch on `stream`: M a multiple of 128, N of bn (128 or 256, the tile
// width the host picked), K of 64 (the wrapper pads). The layout comes from
// the strides: exactly one of (sam, sak) and one of (sbk, sbn) is 1.
// Returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fqmm_launch(const void* a, const void* b, const void* rand8,
                           void* out, float* amax, float* sat, float* flush,
                           int M, int N, int K, long long sam, long long sak,
                           long long sbk, long long sbn, int a_fmt, int b_fmt,
                           int out_fmt, int sr, int saturate, float scale,
                           int lm, int ln, int with_counts, int bn,
                           void* stream) {
  if (!shape_ok(M, N, K, bn) || (sam == 1) == (sak == 1) ||
      (sbk == 1) == (sbn == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
         static_cast<const uint8_t*>(rand8), static_cast<uint8_t*>(out),
         amax, sat, flush, M, N, K, sam, sak, sbk, sbn, a_fmt, b_fmt, out_fmt,
         sr, saturate, scale, lm, ln, with_counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ta = sam == 1, tb = sbn == 1;
  cudaError_t err;
  if (!ta && tb)
    err = launch_bn<OUT_FP8, 0, 1>(p, bn, s);
  else if (!ta && !tb)
    err = launch_bn<OUT_FP8, 0, 0>(p, bn, s);
  else if (ta && tb)
    err = launch_bn<OUT_FP8, 1, 1>(p, bn, s);
  else
    err = cudaErrorInvalidValue;  // A^T . B^T: no caller
  return static_cast<int>(err);
}

// The unfused GEMM: out (M, N) = A (M, K) @ B (K, N), both row-major fp8,
// out f32 (out_bf16 = 0) or bf16 (out_bf16 = 1). M a multiple of 128, N of
// bn, K of 64 (the wrapper pads). Returns cudaGetLastError().
extern "C" int fp8mm_launch(const void* a, const void* b, void* out, int M,
                            int N, int K, int a_fmt, int b_fmt, int out_bf16,
                            int bn, void* stream) {
  if (!shape_ok(M, N, K, bn)) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
         nullptr, out, nullptr, nullptr, nullptr, M, N, K,
         (long long)K, 1LL, (long long)N, 1LL, a_fmt, b_fmt, 0, 0, 0, 1.f,
         M, N, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = out_bf16 ? launch_bn<OUT_BF16, 0, 1>(p, bn, s)
                             : launch_bn<OUT_F32, 0, 1>(p, bn, s);
  return static_cast<int>(err);
}

// Variant `v` of the kernel, in the order of ops.py's GEMM_VARIANTS
// (fp8 nn / nt / tn, then f32 and bf16 nn; each 128 then 256 wide): its
// dynamic shared memory, registers and local (spill) bytes a thread, and
// blocks resident per SM, into out[0..3].
extern "C" int fqmm_variant_info(int v, int* out) {
  cudaError_t err;
  switch (v) {
    case 0: err = info<OUT_FP8, 0, 1, 128>(out); break;
    case 1: err = info<OUT_FP8, 0, 1, 256>(out); break;
    case 2: err = info<OUT_FP8, 0, 0, 128>(out); break;
    case 3: err = info<OUT_FP8, 0, 0, 256>(out); break;
    case 4: err = info<OUT_FP8, 1, 1, 128>(out); break;
    case 5: err = info<OUT_FP8, 1, 1, 256>(out); break;
    case 6: err = info<OUT_F32, 0, 1, 128>(out); break;
    case 7: err = info<OUT_F32, 0, 1, 256>(out); break;
    case 8: err = info<OUT_BF16, 0, 1, 128>(out); break;
    case 9: err = info<OUT_BF16, 0, 1, 256>(out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
