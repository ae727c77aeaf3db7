// Hopper tile helpers shared by the port's wgmma kernels: cp.async copies
// into an fp8 staging ring, the exact widening of fp8 tiles into
// 128-byte-swizzled f16 operand tiles, wgmma shared-memory descriptors, the
// wgmma instructions (m64nNk16, f32 += f16 x f16) and their fences.
#pragma once

#include "fp8_common.cuh"

namespace fp8 {

// k depth of an operand tile: 64 f16 values fill one 128-byte swizzle row.
constexpr int TILE_K = 64;

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy stores (the widening) made visible to wgmma's async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major: sbo = 1024
// (8 rows of 128 bytes), lbo unused. MN-major: lbo = 8192 (the next 64
// elements along m / n), sbo = 1024 (the next 8 rows of k).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// Descriptor of k-slice j (16 deep) of an operand tile at `base`.
template <bool MN>
__device__ __forceinline__ uint64_t slice_desc(uint32_t base, int j) {
  return MN ? smem_desc(base + j * 2048, 8192, 1024)
            : smem_desc(base + j * 32, 16, 1024);
}

#define F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x N, f32) += A(64 x 16, f16) . B(16 x N, f16), both from shared
// memory; TA / TB: the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56),
        F8(d, 64), F8(d, 72), F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104), F8(d, 112), F8(d, 120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D(64 x 128, f32) += A(64 x 16, f16) . B(16 x 128, f16), A from registers:
// each warp's four words hold its 16 rows in mma.sync m16n8k16's A layout
// ({row g, k 2t}, {g + 8, 2t}, {g, 2t + 8}, {g + 8, 2t + 8}, low half first);
// TB: B is MN-major. The A registers must not change before the product's
// group is waited on: call keep_a on them after that wait.
template <int TB>
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// Keeps the A registers of register-A wgmmas (wgmma_n128_rs, one row of
// four words a k slice) live and unchanged up to this point; placed after
// the wait on their group, so the compiler cannot reuse them while the
// products still read them.
template <int N>
__device__ __forceinline__ void keep_a(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

// ---- operand tiles ---------------------------------------------------------
//
// An operand tile is X (m or n) by 64 (k) fp8 bytes. Its source rows run
// along the contiguous dim: K-major, R = X rows of 64 k; MN-major, R = 64
// rows (k) of X elements, cut into X / 64 segments of 64. Unit u (16 bytes)
// is row (u / 4) % R, segment (u / 4) / R, quarter u % 4; in the ring it
// sits at u * 16, so 8 neighbouring threads copy and read 128 contiguous
// bytes. Widened, segment s row r is one 128-byte swizzle row at
// s * R * 128 + r * 128, 16-byte chunk c stored at chunk c ^ (r % 8) — the
// layout wgmma's 128-byte swizzle reads, K-major or MN-major alike.
// THREADS threads share a tile's units.

template <int X, bool MN, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const uint8_t* src,
                                          long long ld, int tid) {
  constexpr int R = MN ? TILE_K : X, UNITS = X * TILE_K / 16;
  static_assert(UNITS % THREADS == 0, "tile units per thread");
#pragma unroll
  for (int i = 0; i < UNITS / THREADS; ++i) {
    const int u = tid + i * THREADS;
    const int row = (u >> 2) % R, seg = (u >> 2) / R;
    cp16(dst + u * 16, src + row * ld + seg * 64 + (u & 3) * 16);
  }
}

// Two fp8 bytes (low half of x) -> f16x2, exact.
__device__ __forceinline__ uint32_t widen2(uint32_t x, int fmt) {
  if (fmt == fp8::E5M2)  // e5m2 is the top byte of an f16
    return __byte_perm(x, 0u, 0x1404);
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(r) : "h"((unsigned short)x));
  return r;
}

// Unit x (quarter q of a 64-element segment row `row`) widened and stored
// into that row's 128 swizzled bytes at d.
__device__ __forceinline__ void widen_unit(uint8_t* d, int row, int q,
                                           const uint4& x, int fmt) {
  const uint32_t v[4] = {x.x, x.y, x.z, x.w};
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = widen2(v[j], fmt);
    w[2 * j + 1] = widen2(v[j] >> 16, fmt);
  }
  const int sw = row & 7;
  *reinterpret_cast<uint4*>(d + (((2 * q) ^ sw) << 4)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(d + (((2 * q + 1) ^ sw) << 4)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

template <int X, bool MN, int THREADS>
__device__ __forceinline__ void widen_tile(uint8_t* dst, const uint8_t* src,
                                           int fmt, int tid) {
  constexpr int R = MN ? TILE_K : X, UNITS = X * TILE_K / 16;
#pragma unroll
  for (int i = 0; i < UNITS / THREADS; ++i) {
    const int u = tid + i * THREADS;
    const int row = (u >> 2) % R, seg = (u >> 2) / R;
    widen_unit(dst + seg * (R * 128) + row * 128, row, u & 3,
               *reinterpret_cast<const uint4*>(src + u * 16), fmt);
  }
}

}  // namespace fp8
