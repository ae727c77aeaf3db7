// Stochastic rounding f32 / bf16 -> fp8 (e5m2 or e4m3fn) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
//   src/repro/kernels/stochastic_round/kernel.py
//   sr_quantize_kernel         (random bits from a uint8 operand)
//   sr_quantize_kernel_onchip  (random bits from the TPU's PRNG)
// and computes their function: out = SR(x * (1/scale)) by the exact fp16
// bit-twiddle of repro.core.quantize.sr_fp8_via_f16 (fp8_common.cuh's
// quant_sr, the same device function the GEMM epilogue rounds with).
//
// The random bits: sr_launch reads one byte per element from `rand8`
// (kernel 6); with rand8 == nullptr they come from the counter hash of
// fp8_common.cuh on (seed, flat element index) (kernel 7), so no bits are
// read from memory. The TPU PRNG's stream cannot be reproduced on the card;
// the hash gives the same uniform low bits, and the plain version
// (kernels/stochastic_round/ref.py) reproduces them exactly.
//
// What bounds it: an elementwise pass, 4 (f32) or 2 (bf16) bytes in, one
// byte out, plus one byte of bits for kernel 6 — device-memory bytes, far
// below the card's operation rate. The design moves 16 elements per thread
// and iteration with 16-byte loads and stores, in a grid-stride loop.
#include "fp8_common.cuh"

namespace {

constexpr uint32_t SALT_SR = 0x55u;  // kernels/stochastic_round/ref.py
constexpr int VEC = 16;              // elements per thread and iteration

template <typename T>
__device__ __forceinline__ void load16(const T* x, float v[VEC]);

template <>
__device__ __forceinline__ void load16<float>(const float* x, float v[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    float4 w = reinterpret_cast<const float4*>(x)[i];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* x,
                                                      float v[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC / 8; ++i) {
    uint4 w = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[8 * i + j] = __bfloat162float(h[j]);
  }
}

__device__ __forceinline__ float load1(const float* x, long long i) {
  return x[i];
}

__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ uint32_t bits_at(const uint8_t* rand8,
                                            uint32_t seed, long long i) {
  return rand8 ? (uint32_t)rand8[i]
               : fp8::hash_bits(seed, SALT_SR, 0u, 0u, (uint32_t)i);
}

template <typename T>
__global__ void __launch_bounds__(256)
    sr_kernel(const T* __restrict__ x, const uint8_t* __restrict__ rand8,
              uint32_t seed, float inv, uint8_t* __restrict__ out,
              long long n, int fmt, int sat) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / VEC;
  for (long long v = tid; v < nvec; v += stride) {
    const long long base = v * VEC;
    float xs[VEC];
    load16(x + base, xs);
    __align__(16) uint8_t r[VEC];
    if (rand8) {
      *reinterpret_cast<uint4*>(r) =
          *reinterpret_cast<const uint4*>(rand8 + base);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        r[i] = (uint8_t)fp8::hash_bits(seed, SALT_SR, 0u, 0u,
                                       (uint32_t)(base + i));
    }
    __align__(16) uint8_t q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      q[i] = fp8::quant_sr(__fmul_rn(xs[i], inv), r[i], fmt, sat != 0);
    *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<uint4*>(q);
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride)
    out[i] = fp8::quant_sr(__fmul_rn(load1(x, i), inv),
                           bits_at(rand8, seed, i), fmt, sat != 0);
}

}  // namespace

// x: n contiguous f32 (x_bf16 = 0) or bf16 (x_bf16 = 1) values; out: n fp8
// bytes; rand8: n bytes of random bits, or nullptr for the hash of (seed,
// index). inv = 1/scale in f32 (computed by the caller). x, rand8 and out
// start on 16-byte boundaries; n < 2^32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sr_launch(const void* x, int x_bf16, const void* rand8,
                         unsigned int seed, float inv, void* out,
                         long long n, int fmt, int saturate, void* stream) {
  const int threads = 256;
  long long blocks = (n / VEC + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(rand8);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (x_bf16)
    sr_kernel<__nv_bfloat16><<<(int)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), r, seed, inv, o, n, fmt,
        saturate);
  else
    sr_kernel<float><<<(int)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), r, seed, inv, o, n, fmt, saturate);
  return static_cast<int>(cudaGetLastError());
}
