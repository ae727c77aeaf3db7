// FP8 flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fp8_attention/kernel.py::fp8_attention_bwd_kernel
// — its stats + dQ pallas_call (body _bwd_dq_body, grid (B, H, Q/bq, 4 nk);
// with COUNTS, both dQ variants' template switch, _bwd_dq_body_counts: the
// saturated / flushed / observed dP8 and dS8 values of each q tile, summed
// over the block in integers; the dK/dV kernel counts nothing, as in the
// reference)
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
// Kernel 1 (dQ + statistics), two variants, both one block per (b, h,
// 64-row q tile) of four warps of 16 rows, over the 128-column kv blocks
// of the tile's kv_stripe_span (taken at the 128-row q tile that holds
// this 64-row tile, the granularity the dK/dV kernel skips at). The host
// picks the variant from the shape, mask and window (ops.dq_variant).
//
// The stash variant (attn_bwd_dq_kernel_stash), for spans of up to
// STASH_BLOCKS = 4 kv blocks (512 columns: every causal tile at S = 512):
//   A  over the span, S = q.K^T -> S8 (salt 0x51) into a byte stash and
//      the row max m; then dP = dO.V^T -> dP8 (salt 0x53) into a second
//      stash and the dP amax (two halves, so that only one operand's A
//      fragments are live at a time);
//   B  no products: l = sum exp(S8 * s_s - m) from the S8 stash; then
//      P8 = Q_A(exp(.) / d_safe * f_p) (salt 0x52) written over its S8
//      byte, and rd = sum P * dP from the two stashes;
//   C  dS8 = Q_E(P * (dP - rd) * f_ds) (salt 0x54) from the stashes, the
//      dS amax, and dq += dS8 . K with dq in registers (64 f32 a thread).
// So each product, SR hash and quantization runs once per score and
// `exp` twice; K is loaded twice and V once. A stash word holds the four
// bytes of one accumulator fragment of one thread, laid out [kv block]
// [fragment][thread]: each thread reads back only what it wrote, without
// bank conflicts or barriers. K and V go through one bf16 tile in shared
// memory (fp8 -> f16 by the hardware conversion, exact), fetched into
// registers one tile ahead; q and dO are staged through it once into A
// fragments; the S / dP B fragments come from ldmatrix, dQ's from
// ldmatrix.trans on the same row-major K tile (no transposed copy). The
// loops walk a kv block's 16 fragments at run time, a few at a time (the
// products per fragment pair, each accumulator's k steps in order), so
// that the code of a pass fits the instruction cache; the quantizers are
// the fp8_common ones rewritten without branches (their constants
// precomputed per Q node, the SR-or-RNE choice made outside the loops),
// so ptxas can interleave the scores of a fragment. Shared memory:
// 34,848 bytes of tile and scratch + 16 KB per kv block of span, 100,384
// bytes at 4 blocks, so two blocks (8 warps) share an SM under
// __launch_bounds__(128, 2). Every product and sum is taken in the same
// order as in the long-span variant, so the two agree bit for bit.
//
// The long-span variant (attn_bwd_dq_kernel), for longer spans: the
// TPU's sequential 4*nk grid axis (phases m -> l -> rd -> dQ over kv
// stripes) as four in-block loops over the span, recomputing S in each
// and dP in two. S and dP are mma.sync m16n8k16 products of bf16 tiles in
// shared memory (fp8 -> bf16 is exact); dS feeds the dQ product from
// registers, with K^T from a transposed bf16 copy. dQ accumulates per kv
// block (acc + block product) in shared memory (173 KB a block, one block
// an SM).
//
// Both write dQ * f_dq and the per-row m, l, rd in f32 for kernel 2.
//
// Kernel 2 (dK/dV, attn_bwd_dkv_kernel_head): one block per (query head
// h, batch row b, 64 kv rows), one warpgroup, two blocks an SM. It runs head
// h's part of the chain: the 128-row q tiles whose kv_span holds its kv
// rows, in ascending order, each in two steps of 64 q rows. A step:
//  - copies: a 2-stage cp.async ring holds the next steps' q and dO bytes
//    and their m, l, rd rows (rows past Q read as zeros); each stage is
//    widened exactly into 128-byte-swizzled f16 tiles, which serve as
//    K-major B operands of S^T and dP^T and, as they lie, as MN-major B
//    operands of dK and dV; K and V are widened once, as the A operands;
//  - S^T = K . Q^T on wgmma m64n64k16; the epilogue per score, a run of
//    branch-free Q nodes folded at compile time for the call's rounding,
//    saturation and format (S and P on Q_A, dP and dS on Q_E), the SR hash
//    prefixes taken once per q row of the step (the accumulator's column in
//    this transposed layout), exp(ok ? x - m : -inf) and the division by
//    d_safe as fp8_epilogue.cuh's div_rn with 1 / d_safe taken once a row;
//  - dV += P8^T . dO8 and dK += dS8^T . Q8 on register-A wgmma m64n128k16
//    (the accumulator layout of S^T is the A layout) into f32 registers
//    that live across the chain; dP^T = V . dO^T on m64n64k16.
// Every score of a visited (q tile, kv block) pair is computed, masked
// ones too (P = 0, so an unsaturated dP that overflows gives dS = NaN, as
// in the plain version). The skip set is kv_span's, as in kernel 1.
//
// Association: the reference adds the (GQA member, q tile) parts of dK and
// dV in one flat chain. Here each member's chain accumulates in the wgmma
// accumulator; with a GQA group of one the block writes dK * f_dk and
// dV * f_dv. Else each block writes head h's raw partials into a scratch
// that attn_bwd_dkv_kernel_group_sum adds in head order,
// ((P_0 + P_1) + P_2) ..., before scaling once. No atomics: the result
// does not change from run to run. On inputs whose every partial sum is
// exact (the exact fixtures) it equals the flat chain bit for bit.
//
// Head dims: each library holds the kernels at D = 128 or D = 256
// (FP8_ATTN_D). At D = 256 a block computes the scores over the whole head
// dim and 128 columns of its output, two blocks to a q tile (dQ) or kv
// block (dK/dV), so a thread's accumulators are D = 128's; the long-span
// dQ variant drops its transposed K copy (ldmatrix.trans on K instead) and
// adds each block's dQ in place in device memory, its tiles taking 198 of
// the 227 KB a block may hold.
//
// Both files' arithmetic is built with --fmad=false and the epilogues use
// __fmul_rn / __fadd_rn / __fdiv_rn (or div_rn), so every product and sum
// is rounded on its own, as in the reference.
//
// What bounds them (H100 SXM at 700 W; chip_smoke.py and the probe,
// kernels/fp8_attention/probe.py): at the training shape (B=4, H=12,
// Hkv=2, S=512, D=128, causal) each kernel moves ~1-7 MB and does ~10
// GFLOP of matrix products, a few microseconds at the card's rates (bounds
// 6.0 and 3.5 us). Both visit the same ~7.9 M scores and are bound by
// their per-score epilogues (4 SR hashes, 4 quantizations, exp, a division
// and the fp8 conversions) and the grid's tail; PERF.md holds the times
// and the probes' split. The long-span variant of kernel 1 is bound by its
// recomputation, its shared-memory accumulator and one block an SM.
#include <algorithm>
#include <type_traits>

#include "fp8_epilogue.cuh"
#include "wgmma_tiles.cuh"

namespace {

using fp8::QConst;
using fp8::make_qconst;
using fp8::quant_bf;
using fp8::ldsm_x4;
using fp8::ldsm_x4_t;
using fp8::byte_to_f32;
using fp8::word_to_f32;
using fp8::hash_row;
using fp8::hash_col;
using fp8::with_flag;
using fp8::with_qnode;
using fp8::cp_commit;
using fp8::cp_wait;
using fp8::fence_acc;
using fp8::fence_async_smem;
using fp8::slice_desc;
using fp8::wg_commit;
using fp8::wg_fence;
using fp8::wg_wait;
using fp8::widen2;
using fp8::widen_tile;
using fp8::widen_unit;

// Every kernel is built at head dim D = 128 and D = 256 (the wrapper
// zero-pads smaller heads to 128, wider ones up to 256 to 256). A block
// computes the scores over the whole head dim and DO = 128 columns of its
// output: at D = 256 two blocks (dh = 0, 1) share each q tile (dQ) or kv
// block (dK/dV), each recomputing the scores, so that the accumulators a
// thread holds are those of D = 128.
constexpr int LANE = 128;  // kv columns per block (and q rows per dK tile)
constexpr int DO = 128;    // output columns per block
constexpr int BQ = 64;     // q rows per dQ block
constexpr int BKV = 64;    // kv rows per dK/dV block
constexpr int TQ = 128;    // q rows per dK/dV contribution
template <int D>
constexpr int ks_of = D + 8;  // bf16 row stride (bank spread)
constexpr int FS = DO + 4;    // f32 row stride of the accumulators
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
  int* counts;         // (B, H, nq, 6): dP then dS [saturated, flushed,
                       // observed] (the dQ kernels' count variants), or null
  float* dk;           // (B, Hkv, S, D)
  float* dv;
  int B, H, Hkv, Q, S, q_len, s_len, causal, window;
  int q_fmt, k_fmt, v_fmt, do_fmt, fmt_s, fmt_p, fmt_e;
  int sr_s, sr_p, sr_e, sat_s, sat_p, sat_e;
  float f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds, f_dq, f_dk, f_dv;
  // The SR hash's head index of batch row b, head h: b * hash_h + head0 + h
  // (hash_h = H, head0 = 0, unless q holds heads head0.. of hash_h).
  int hash_h, head0;
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
template <int D, int KS = ks_of<D>>
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
template <int D, int KS = ks_of<D>>
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

// acc[16][4] = A(16 rows of `a`, stride KS) . B^T, where B is 128 rows of
// `b` (stride KS) — a 16 x 128 tile of a . b^T over the head dim.
template <int D, int KS = ks_of<D>>
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

// A q tile's counts [dP sat, dP flush, dS sat, dS flush, observed] as
// its (2, 3) row [dP; dS] x [saturated, flushed, observed].
__device__ __forceinline__ void write_counts(int* c, const int (&s)[5]) {
  c[0] = s[0];
  c[1] = s[1];
  c[2] = s[4];
  c[3] = s[2];
  c[4] = s[3];
  c[5] = s[4];
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

template <int D, int KS = ks_of<D>>
struct SmemDQ {
  __nv_bfloat16 q[BQ][KS];
  __nv_bfloat16 dO[BQ][KS];
  __nv_bfloat16 k[LANE][KS];   // [kv][d]
  __nv_bfloat16 v[LANE][KS];   // [kv][d]
  __nv_bfloat16 kt[D][KS];     // [d][kv]
  float dq[BQ][FS];
  float red[2][4];
};
// At D = 256 the four bf16 tiles alone take 198 KB: dQ's B operand comes
// from the K tile by ldmatrix.trans (no transposed copy), and each thread
// accumulates its own dQ elements in place in the output (device memory,
// read back by the thread that wrote them).
template <>
struct SmemDQ<256> {
  __nv_bfloat16 q[BQ][ks_of<256>];
  __nv_bfloat16 dO[BQ][ks_of<256>];
  __nv_bfloat16 k[LANE][ks_of<256>];
  __nv_bfloat16 v[LANE][ks_of<256>];
  float red[2][4];
};

// COUNTS (both dQ variants): also count the saturated, flushed and
// observed dP8 and dS8 values of each q tile (the reference counts them in
// its dQ kernel only); the variant without it is the same code with the
// counting left out, and both compute the same outputs.
template <bool COUNTS, int D>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(Args p) {
  constexpr int KS = ks_of<D>, DH = D / DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDQ<D>& sm = *reinterpret_cast<SmemDQ<D>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // x: the q tile and, at D = 256, the output half dh.
  const int iq = blockIdx.x / DH, dh = blockIdx.x % DH;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = iq * BQ;
  const uint32_t bh = (uint32_t)(b * p.hash_h + p.head0 + h);
  const uint32_t seed = *p.seed;
  const long long qoff = (long long)(b * p.H + h) * p.Q * D;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;

  load_rows<D>(&sm.q[0][0], p.q + qoff, BQ, row0, p.Q, p.q_fmt);
  load_rows<D>(&sm.dO[0][0], p.dO + qoff, BQ, row0, p.Q, p.do_fmt);
  if constexpr (DH == 1)
    for (int i = tid; i < BQ * FS; i += 128) (&sm.dq[0][0])[i] = 0.f;

  int rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = row0 + warp * 16 + g + 8 * i;
  // This thread's dQ elements of the block's output columns, at D = 256
  // accumulated in place: row rows[hf], columns dh * DO + 8 n + 2 t + e.
  auto dqg = [&](int hf) {
    return p.dq + ((long long)(b * p.H + h) * p.Q + rows[hf]) * D + dh * DO +
           2 * t;
  };
  if constexpr (DH > 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (rows[hf] < p.Q)
#pragma unroll
        for (int n = 0; n < DO / 8; ++n)
          *reinterpret_cast<float2*>(dqg(hf) + 8 * n) = make_float2(0.f, 0.f);
  }
  int jmin, jmax;
  kv_span(p, row0 / TQ * TQ, jmin, jmax);

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float dsafe[2] = {1.f, 1.f};
  float amax_dp = 0.f, amax_ds = 0.f;
  // Health counts of this thread's observed values: dP saturated,
  // flushed, dS saturated, flushed, observed.
  uint32_t cnt[5] = {0u, 0u, 0u, 0u, 0u};
  const float maxn_e = p.fmt_e == fp8::E4M3 ? 448.f : 57344.f;
  const float minn_e = p.fmt_e == fp8::E4M3 ? 0.015625f : 6.103515625e-05f;
  const __nv_bfloat16* qw = &sm.q[warp * 16][0];
  const __nv_bfloat16* dow = &sm.dO[warp * 16][0];

  for (int phase = 0; phase < 4; ++phase) {
    for (int j = jmin; j <= jmax; ++j) {
      __syncthreads();  // previous block's tiles fully consumed
      load_rows<D>(&sm.k[0][0], p.k + kvoff, LANE, j * LANE, p.S, p.k_fmt);
      if (phase >= 2)
        load_rows<D>(&sm.v[0][0], p.v + kvoff, LANE, j * LANE, p.S, p.v_fmt);
      if constexpr (DH == 1) {
        if (phase == 3)
          load_rows_t<D>(&sm.kt[0][0], p.k + kvoff, LANE, j * LANE, p.k_fmt);
      }
      __syncthreads();

      float s[16][4];
      tile_abt<D>(s, qw, &sm.k[0][0]);
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
      tile_abt<D>(dp, dow, &sm.v[0][0]);
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
            if constexpr (COUNTS) {
              // Saturated: at or past max normal, or not finite.
              cnt[0] += (obs && !(fabsf(dpv) < maxn_e)) ? 1u : 0u;
              cnt[1] += (obs && fabsf(dpv) < minn_e) ? 1u : 0u;
              cnt[4] += obs ? 1u : 0u;
            }
          } else {
            rnd = p.sr_e ? fp8::hash_bits(seed, SALT_DS, bh, row, col) : 0u;
            const float ds = __fmul_rn(s[nt][e], __fsub_rn(dpd, rd[hf]));
            dsq[e] = fp8::to_float(
                fp8::quant(__fmul_rn(ds, p.f_ds), rnd, p.fmt_e, p.sr_e,
                           p.sat_e), p.fmt_e);
            if (obs) amax_ds = fp8::nanmax(amax_ds, fabsf(dsq[e]));
            if constexpr (COUNTS) {
              cnt[2] += (obs && !(fabsf(dsq[e]) < maxn_e)) ? 1u : 0u;
              cnt[3] += (obs && fabsf(dsq[e]) < minn_e) ? 1u : 0u;
            }
          }
        }
        if (phase == 3) pack_a(dsf, nt, dsq);
      }
      if (phase == 2) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) rd[hf] = __fadd_rn(rd[hf], warp_sum4(rsum[hf]));
        continue;
      }

      if constexpr (DH > 1) {
        // dq += dS8 . K[:, dh * DO ...] for this block: K's B fragments by
        // ldmatrix.trans from the row-major tile, as in the stash variant's
        // pass C; the block's product added in place.
        const int li = lane >> 3, lr = lane & 7;
        float part[16][4];
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const __nv_bfloat16* rowp = &sm.k[0][0] +
                                      (ks * 16 + (li & 1) * 8 + lr) * KS +
                                      dh * DO + (li >> 1) * 8;
#pragma unroll
          for (int dp2 = 0; dp2 < 8; ++dp2) {
            uint32_t bf[4];
            fp8::ldsm_x4_t(bf, rowp + dp2 * 16);
            fp8::mma_bf16(part[2 * dp2], dsf[ks], bf[0], bf[1]);
            fp8::mma_bf16(part[2 * dp2 + 1], dsf[ks], bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (rows[hf] < p.Q)
#pragma unroll
            for (int n = 0; n < 16; ++n) {
              float2* a = reinterpret_cast<float2*>(dqg(hf) + 8 * n);
              const float2 x = *a;
              *a = make_float2(__fadd_rn(x.x, part[n][2 * hf]),
                               __fadd_rn(x.y, part[n][2 * hf + 1]));
            }
      } else {
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
    if constexpr (DH == 1) {
      float* dqr = p.dq + r * D;
      const int lr = warp * 16 + g + 8 * hf;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const int col = dt * 8 + 2 * t;
        dqr[col] = __fmul_rn(sm.dq[lr][col], p.f_dq);
        dqr[col + 1] = __fmul_rn(sm.dq[lr][col + 1], p.f_dq);
      }
    } else {
#pragma unroll
      for (int n = 0; n < DO / 8; ++n) {
        float2* a = reinterpret_cast<float2*>(dqg(hf) + 8 * n);
        const float2 x = *a;
        *a = make_float2(__fmul_rn(x.x, p.f_dq), __fmul_rn(x.y, p.f_dq));
      }
    }
    if (t == 0 && dh == 0) {
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
  // The output halves of a q tile observe the same values; the first one
  // writes the amaxes and counts.
  if (tid == 0 && dh == 0) {
    float a = sm.red[0][0], c = sm.red[1][0];
    for (int w = 1; w < 4; ++w) {
      a = fp8::nanmax(a, sm.red[0][w]);
      c = fp8::nanmax(c, sm.red[1][w]);
    }
    const long long idx = (long long)(b * p.H + h) * (gridDim.x / DH) + iq;
    p.amax_dp[idx] = a;
    p.amax_ds[idx] = c;
  }
  if constexpr (COUNTS) {
    int sums[5];
    if constexpr (DH == 1)
      fp8::block_counts<5, 4>(cnt, reinterpret_cast<uint32_t*>(&sm.kt[0][0]),
                              sums);
    else
      fp8::block_counts<5, 4>(cnt, reinterpret_cast<uint32_t*>(&sm.k[0][0]),
                              sums);
    if (tid == 0 && dh == 0)
      write_counts(
          p.counts + ((long long)(b * p.H + h) * (gridDim.x / DH) + iq) * 6,
          sums);
  }
}

// ---------------------------------------------------------------------------
// kernel 1, stash variant: each product, SR hash and quantization once
// ---------------------------------------------------------------------------

constexpr int STASH_BLOCKS = 4;   // kv blocks a stash-variant span may cover
template <int D>
constexpr int TILE_BYTES = LANE * ks_of<D> * 2;
constexpr int STASH_WORDS = 16 * 128;   // words per stash per kv block


struct QConsts {
  QConst s, p, e;
};


// 16 fp8 bytes -> 8 packed bf16 pairs.
__device__ __forceinline__ void bytes_to_bf16_hw(const uint4& x, int fmt,
                                                 uint32_t w[8]) {
  const uint32_t b[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
    word_to_f32(b[i], fmt, v);
    w[2 * i] = fp8::pack_bf16(v[0], v[1]);
    w[2 * i + 1] = fp8::pack_bf16(v[2], v[3]);
  }
}

// The units of ROWS rows of W fp8 bytes (16 bytes per thread and step):
// W / 16 a row, 8 (W = 128) or 16 (W = 256).
template <int W>
constexpr int unit_shift = W == 128 ? 3 : 4;

// ROWS x W fp8 bytes of rows LD apart (the first W of each row at src)
// from device memory into registers (16 bytes per thread and step; rows
// at or past `limit` read as zeros) ...
template <int ROWS, int W, int LD, int N>
__device__ __forceinline__ void fetch_rows(uint4 (&x)[N], const uint8_t* src,
                                           int row0, int limit) {
  static_assert(N >= ROWS * W / 2048, "fetch_rows: registers");
  constexpr int SH = unit_shift<W>;
#pragma unroll
  for (int i = 0; i < ROWS * W / 2048; ++i) {
    const int v = threadIdx.x + 128 * i, r = v >> SH,
              c = (v & ((1 << SH) - 1)) * 16;
    x[i] = row0 + r < limit
               ? __ldg(reinterpret_cast<const uint4*>(
                     src + (long long)(row0 + r) * LD + c))
               : make_uint4(0, 0, 0, 0);
  }
}

// ... and from registers into a bf16 shared-memory tile of row stride KS.
template <int ROWS, int W, int KS, int N>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const uint4 (&x)[N], int fmt) {
  constexpr int SH = unit_shift<W>;
#pragma unroll
  for (int i = 0; i < ROWS * W / 2048; ++i) {
    const int v = threadIdx.x + 128 * i, r = v >> SH,
              c = (v & ((1 << SH) - 1)) * 16;
    uint32_t w[8];
    bytes_to_bf16_hw(x[i], fmt, w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * KS + c);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The A fragments of 16 rows x D of a bf16 tile (stride KS), per 16-wide
// k step: {a[g][c], a[g+8][c], a[g][c+8], a[g+8][c+8]}, c = kk + 2t.
template <int D, int KS = ks_of<D>>
__device__ __forceinline__ void load_afrag(uint32_t af[D / 16][4],
                                           const __nv_bfloat16* rows16) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(af[kk], rows16 + ((i & 1) * 8 + r) * KS + kk * 16 + (i >> 1) * 8);
}

// acc[2][4] = the n tiles 2np, 2np+1 (kv columns 16np .. 16np+15) of
// A . tile^T over the head dim: A from registers (16 rows), tile = 128 kv
// rows of stride KS; the k steps in ascending order, as tile_abt.
template <int D, int KS = ks_of<D>>
__device__ __forceinline__ void frag_abt_pair(float acc[2][4],
                                              const uint32_t af[D / 16][4],
                                              const __nv_bfloat16* tile,
                                              int np) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const __nv_bfloat16* rowp = tile + ((2 * np + (i >> 1)) * 8 + r) * KS +
                              (i & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t bf[4];
    ldsm_x4(bf, rowp + kk * 16);
    fp8::mma_bf16(acc[0], af[kk], bf[0], bf[1]);
    fp8::mma_bf16(acc[1], af[kk], bf[2], bf[3]);
  }
}


// Built with -DDQ_PROBE (kernels/fp8_attention/probe.py), the stash
// kernel records the SM clock at its pass boundaries in two blocks (the
// grid's first, which holds a longest span, and its last, a shortest),
// and each block's start, end (global timer, ns), SM and clock count.
#ifdef DQ_PROBE
constexpr int PROBE_BLOCKS = 8192;
__device__ unsigned long long dq_probe_marks[2][8];
__device__ unsigned long long dq_probe_blocks[PROBE_BLOCKS][4];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DQ_PROBE_MARK(k)                                                  \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&           \
      (blockIdx.z == 0 || blockIdx.z == gridDim.z - 1))                   \
    dq_probe_marks[blockIdx.z == 0 ? 0 : 1][k] = clock64();
#else
#define DQ_PROBE_MARK(k)
#endif


// At D = 256 the block's output half dh is the only part that differs:
// passes A and B run in full, and pass C stages and multiplies the K
// columns of that half alone, so dq keeps its 64 registers a thread.
template <bool COUNTS, int D>
__global__ void __launch_bounds__(128, D == 128 ? 2 : 1)
    attn_bwd_dq_kernel_stash(Args p, QConsts qc) {
  constexpr int KS = ks_of<D>, DH = D / DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float(*red)[4] = reinterpret_cast<float(*)[4]>(smem_raw + TILE_BYTES<D>);
  uint32_t* stash =
      reinterpret_cast<uint32_t*>(smem_raw + TILE_BYTES<D> + 32);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Longest spans first: the z axis walks the q tiles from the last (and,
  // at D = 256, each tile's two output halves dh in turn).
  const int dh = blockIdx.z % DH;
  const int h = blockIdx.x, b = blockIdx.y,
            iq = gridDim.z / DH - 1 - blockIdx.z / DH;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = iq * BQ;
  const uint32_t bh = (uint32_t)(b * p.hash_h + p.head0 + h);
  const uint32_t seed = *p.seed;
  const long long qoff = (long long)(b * p.H + h) * p.Q * D;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;
  const uint8_t* kg = p.k + kvoff;
  const uint8_t* vg = p.v + kvoff;

  // Per row of this thread: the SR hash prefixes, and the valid columns
  // [lo, hi] (is_valid) with the observed ones (row < q_len) a subset.
  int rows[2], lo[2], hi[2], hi_obs[2];
  uint32_t hs[2], hp[2], hdp[2], hds[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + g + 8 * i;
    rows[i] = row;
    hs[i] = hash_row(seed, SALT_S, bh, row);
    hp[i] = hash_row(seed, SALT_P, bh, row);
    hdp[i] = hash_row(seed, SALT_DP, bh, row);
    hds[i] = hash_row(seed, SALT_DS, bh, row);
    hi[i] = p.causal ? min(row, p.s_len - 1) : p.s_len - 1;
    lo[i] = (p.causal && p.window) ? row - p.window + 1 : 0;
    hi_obs[i] = row < p.q_len ? hi[i] : -1;
  }
  int jmin, jmax;
  kv_span(p, row0 / TQ * TQ, jmin, jmax);
  // Stashes, thread-private words [kv block][nt][thread]: S8 (then P8)
  // and dP8, byte e of word nt = accumulator element (nt, e).
  uint32_t* s8w = stash;
  uint32_t* dp8w = stash + (jmax - jmin + 1) * STASH_WORDS;

#ifdef DQ_PROBE
  const unsigned long long probe_ns = global_ns();
  const long long probe_clk = clock64();
#endif
  DQ_PROBE_MARK(0)
  // Pass A, in two halves that each hold one operand's A fragments:
  // S8 per kv block into its stash and the row max m; then dP8 and its
  // amax. q and dO are staged through the tile once; K and V are
  // fetched into registers one tile ahead.
  uint32_t af[D / 16][4];
  uint4 nx[LANE * D / 2048], xdo[BQ * D / 2048];
  {
    uint4 x[BQ * D / 2048];
    fetch_rows<BQ, D, D>(x, p.q + qoff, row0, p.Q);
    fetch_rows<BQ, D, D>(xdo, p.dO + qoff, row0, p.Q);
    fetch_rows<LANE, D, D>(nx, kg, jmin * LANE, p.S);
    stage_rows<BQ, D, KS>(tile, x, p.q_fmt);
    __syncthreads();
    load_afrag<D>(af, tile + warp * 16 * KS);
  }
  DQ_PROBE_MARK(1)
  // The loops below walk a kv block's 16 accumulator fragments (8 kv
  // columns each) at run time, a pair or two at a time: the unrolled
  // epilogue of all 64 scores a thread holds would not fit the
  // instruction cache.
  float m[2] = {-1e30f, -1e30f};
  float amax_dp = 0.f, amax_ds = 0.f;
  // Health counts of this thread's observed values: dP saturated,
  // flushed, dS saturated, flushed, observed.
  uint32_t cnt[5] = {0u, 0u, 0u, 0u, 0u};
  const uint32_t sat_e = fp8::sat_bits(p.fmt_e);
  const uint32_t flush_e = fp8::flush_bits(p.fmt_e);
  for (int j = jmin; j <= jmax; ++j) {
    const int jl = j - jmin;
    __syncthreads();  // the tile's previous contents consumed
    stage_rows<LANE, D, KS>(tile, nx, p.k_fmt);
    __syncthreads();
    // The next K block, or the span's first V block.
    if (j < jmax)
      fetch_rows<LANE, D, D>(nx, kg, (j + 1) * LANE, p.S);
    else
      fetch_rows<LANE, D, D>(nx, vg, jmin * LANE, p.S);
    float mx[2] = {-1e30f, -1e30f};
    with_flag(p.sr_s, [&](auto sr) {
#pragma unroll 2
      for (int np = 0; np < 8; ++np) {
        float acc[2][4];
        frag_abt_pair<D>(acc, af, tile, np);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int nt = 2 * np + n;
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
            const uint32_t q8 = quant_bf<decltype(sr)::value>(
                __fmul_rn(acc[n][e], p.f_s),
                decltype(sr)::value ? hash_col(hs[hf], col) : 0u, qc.s);
            word |= q8 << (8 * e);
            const float x = (col >= lo[hf] && col <= hi[hf])
                                ? __fmul_rn(byte_to_f32(q8, p.fmt_s), p.s_s)
                                : -1e30f;
            mx[hf] = fp8::nanmax(mx[hf], x);
          }
          s8w[(jl * 16 + nt) * 128 + tid] = word;
        }
      }
    });
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) m[hf] = fp8::nanmax(m[hf], warp_max4(mx[hf]));
  }
  DQ_PROBE_MARK(2)
  __syncthreads();  // the last K block consumed
  stage_rows<BQ, D, KS>(tile, xdo, p.do_fmt);
  __syncthreads();
  load_afrag<D>(af, tile + warp * 16 * KS);
  for (int j = jmin; j <= jmax; ++j) {
    const int jl = j - jmin;
    __syncthreads();  // the tile's previous contents consumed
    stage_rows<LANE, D, KS>(tile, nx, p.v_fmt);
    __syncthreads();
    // The next V block, or the span's first K block (the block's output
    // columns) for pass C.
    if constexpr (DH == 1)
      fetch_rows<LANE, D, D>(nx, j < jmax ? vg : kg,
                             (j < jmax ? j + 1 : jmin) * LANE, p.S);
    else if (j < jmax)
      fetch_rows<LANE, D, D>(nx, vg, (j + 1) * LANE, p.S);
    else
      fetch_rows<LANE, DO, D>(nx, kg + dh * DO, jmin * LANE, p.S);
    with_flag(p.sr_e, [&](auto sr) {
#pragma unroll 2
      for (int np = 0; np < 8; ++np) {
        float acc[2][4];
        frag_abt_pair<D>(acc, af, tile, np);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int nt = 2 * np + n;
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
            const uint32_t q8 = quant_bf<decltype(sr)::value>(
                __fmul_rn(acc[n][e], p.f_dp),
                decltype(sr)::value ? hash_col(hdp[hf], col) : 0u, qc.e);
            word |= q8 << (8 * e);
            const bool obs = col >= lo[hf] && col <= hi_obs[hf];
            amax_dp = obs ? fp8::nanmax(amax_dp,
                                        fabsf(byte_to_f32(q8, p.fmt_e)))
                          : amax_dp;
            if constexpr (COUNTS) {
              fp8::count_health(q8, obs, sat_e, flush_e, cnt);
              cnt[4] += obs ? 1u : 0u;
            }
          }
          dp8w[(jl * 16 + nt) * 128 + tid] = word;
        }
      }
    });
  }

  DQ_PROBE_MARK(3)
  // Pass B, no products: l from the S8 stash; then P8 over S8, and rd.
  float l[2] = {0.f, 0.f};
  for (int j = jmin; j <= jmax; ++j) {
    const int jl = j - jmin;
    float rsum[2] = {0.f, 0.f};
#pragma unroll 4
    for (int nt = 0; nt < 16; ++nt) {
      float sv[4];
      word_to_f32(s8w[(jl * 16 + nt) * 128 + tid], p.fmt_s, sv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
        const float ev = (col >= lo[hf] && col <= hi[hf])
            ? expf(__fsub_rn(__fmul_rn(sv[e], p.s_s), m[hf])) : 0.f;
        rsum[hf] = __fadd_rn(rsum[hf], ev);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = __fadd_rn(l[hf], warp_sum4(rsum[hf]));
  }
  DQ_PROBE_MARK(4)
  float dsafe[2], rd[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) dsafe[hf] = l[hf] > 0.f ? l[hf] : 1.f;
  with_flag(p.sr_p, [&](auto sr) {
    for (int j = jmin; j <= jmax; ++j) {
      const int jl = j - jmin;
      float rsum[2] = {0.f, 0.f};
#pragma unroll 2
      for (int nt = 0; nt < 16; ++nt) {
        const int w = (jl * 16 + nt) * 128 + tid;
        float sv[4], dpv[4];
        word_to_f32(s8w[w], p.fmt_s, sv);
        word_to_f32(dp8w[w], p.fmt_e, dpv);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
          const float ev = (col >= lo[hf] && col <= hi[hf])
              ? expf(__fsub_rn(__fmul_rn(sv[e], p.s_s), m[hf])) : 0.f;
          const uint32_t p8 = quant_bf<decltype(sr)::value>(
              __fmul_rn(__fdiv_rn(ev, dsafe[hf]), p.f_p),
              decltype(sr)::value ? hash_col(hp[hf], col) : 0u, qc.p);
          word |= p8 << (8 * e);
          const float pd = __fmul_rn(byte_to_f32(p8, p.fmt_p), p.s_p);
          rsum[hf] = __fadd_rn(rsum[hf],
                               __fmul_rn(pd, __fmul_rn(dpv[e], p.s_dp)));
        }
        s8w[w] = word;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) rd[hf] = __fadd_rn(rd[hf], warp_sum4(rsum[hf]));
    }
  });

  DQ_PROBE_MARK(5)
  // Pass C: dS8 from the stashes, its amax, dq += dS8 . K in registers:
  // per 16 kv columns (one k step), the two fragments' dS8 as the A
  // operand against all 16 n tiles of the head dim (K's B fragments from
  // the row-major tile through ldmatrix.trans); the block's product is
  // then added to dq (the reference's per-block order).
  float dq[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const int li = lane >> 3, lr = lane & 7;
  for (int j = jmin; j <= jmax; ++j) {
    const int jl = j - jmin;
    __syncthreads();  // the tile's previous contents consumed
    stage_rows<LANE, DO, KS>(tile, nx, p.k_fmt);
    __syncthreads();
    if (j < jmax) fetch_rows<LANE, DO, D>(nx, kg + dh * DO, (j + 1) * LANE, p.S);
    float part[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    with_flag(p.sr_e, [&](auto sr) {
#pragma unroll 1
      for (int ks = 0; ks < 8; ++ks) {
        float dsq[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int nt = 2 * ks + n;
          const int w = (jl * 16 + nt) * 128 + tid;
          float pv[4], dpv[4];
          word_to_f32(s8w[w], p.fmt_p, pv);
          word_to_f32(dp8w[w], p.fmt_e, dpv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
            const float ds = __fmul_rn(
                __fmul_rn(pv[e], p.s_p),
                __fsub_rn(__fmul_rn(dpv[e], p.s_dp), rd[hf]));
            const uint32_t d8 = quant_bf<decltype(sr)::value>(
                __fmul_rn(ds, p.f_ds),
                decltype(sr)::value ? hash_col(hds[hf], col) : 0u, qc.e);
            dsq[n][e] = byte_to_f32(d8, p.fmt_e);
            const bool obs = col >= lo[hf] && col <= hi_obs[hf];
            amax_ds = obs ? fp8::nanmax(amax_ds, fabsf(dsq[n][e])) : amax_ds;
            if constexpr (COUNTS)
              fp8::count_health(d8, obs, sat_e, flush_e, cnt + 2);
          }
        }
        const uint32_t a[4] = {fp8::pack_bf16(dsq[0][0], dsq[0][1]),
                               fp8::pack_bf16(dsq[0][2], dsq[0][3]),
                               fp8::pack_bf16(dsq[1][0], dsq[1][1]),
                               fp8::pack_bf16(dsq[1][2], dsq[1][3])};
        const __nv_bfloat16* rowp = tile + (ks * 16 + (li & 1) * 8 + lr) * KS +
                                    (li >> 1) * 8;
#pragma unroll
        for (int dp = 0; dp < 8; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, rowp + dp * 16);
          fp8::mma_bf16(part[2 * dp], a, bf[0], bf[1]);
          fp8::mma_bf16(part[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    });
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = __fadd_rn(dq[n][e], part[n][e]);
  }

  DQ_PROBE_MARK(6)
  // Write dq * f_dq and the row statistics (rows of this thread).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = rows[hf];
    if (row >= p.Q) continue;
    const long long r = (long long)(b * p.H + h) * p.Q + row;
    float* dqr = p.dq + r * D + dh * DO;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      *reinterpret_cast<float2*>(dqr + dt * 8 + 2 * t) =
          make_float2(__fmul_rn(dq[dt][2 * hf], p.f_dq),
                      __fmul_rn(dq[dt][2 * hf + 1], p.f_dq));
    if (t == 0 && dh == 0) {
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
    red[0][warp] = amax_dp;
    red[1][warp] = amax_ds;
  }
  __syncthreads();
  if (tid == 0 && dh == 0) {
    float a = red[0][0], c = red[1][0];
    for (int w = 1; w < 4; ++w) {
      a = fp8::nanmax(a, red[0][w]);
      c = fp8::nanmax(c, red[1][w]);
    }
    const long long idx = (long long)(b * p.H + h) * (gridDim.z / DH) + iq;
    p.amax_dp[idx] = a;
    p.amax_ds[idx] = c;
  }
  if constexpr (COUNTS) {
    // The tile is free from here on: its words hold the block's sums.
    int sums[5];
    fp8::block_counts<5, 4>(cnt, reinterpret_cast<uint32_t*>(tile), sums);
    if (tid == 0 && dh == 0)
      write_counts(
          p.counts + ((long long)(b * p.H + h) * (gridDim.z / DH) + iq) * 6,
          sums);
  }
#ifdef DQ_PROBE
  const unsigned bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (tid == 0 && bid < PROBE_BLOCKS) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    dq_probe_blocks[bid][0] = probe_ns;
    dq_probe_blocks[bid][1] = global_ns();
    dq_probe_blocks[bid][2] = sm;
    dq_probe_blocks[bid][3] = clock64() - probe_clk;
  }
#endif
}

// ---------------------------------------------------------------------------
// kernel 2: dK / dV
// ---------------------------------------------------------------------------

constexpr int DKV_THREADS = 128;  // one warpgroup; warp w: kv rows 16w .. 16w+15
constexpr int QU = 64;            // q rows per step (half a 128-row q tile)

// Shared memory at head dim D, by byte offset (the f16 tiles 1024-byte
// aligned for the 128-byte swizzle). Every f16 tile is D / 64 d segments
// of 64 rows (widen_unit's layout): K and V, the K-major A operands of S^T
// and dP^T; the step's Q and dO, the K-major B operands of S^T and dP^T
// and, as they lie, the MN-major B operands of dK and dV (two segments
// from the block's output half on). A ring stage: the step's q and dO fp8
// bytes in load_tile's unit order, then its m, l and rd rows. The step's
// rows: 1 / d_safe (double), m, rd and the four SR hash prefixes. 101,888
// bytes at D = 128 (two blocks an SM), 200,192 at D = 256 (one).
template <int D>
struct Dkv {
  static constexpr int DH = D / DO;  // blocks per kv block
  static constexpr int KH = 0, VH = KH + BKV * D * 2;
  static constexpr int QH = VH + BKV * D * 2, DOH = QH + QU * D * 2;
  static constexpr int RING = DOH + QU * D * 2;
  static constexpr int ST_Q = 0, ST_DO = QU * D, ST_STATS = 2 * QU * D;
  static constexpr int STAGE = ST_STATS + 3 * QU * 4;
  static constexpr int RCP = RING + 2 * STAGE;
  static constexpr int M = RCP + QU * 8, RD = M + QU * 4;
  static constexpr int PRE = RD + QU * 4;
  static constexpr int SMEM = PRE + 4 * QU * 4;
};

// cp.async of 16 (4) bytes that writes zeros for a source out of range.
__device__ __forceinline__ void cp16_zfill(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4_zfill(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The register A operand (four k slices of 16 q rows) from eight words of
// fp8 bytes in the accumulator layout, widened exactly to f16.
__device__ __forceinline__ void a_from_words(uint32_t (&a)[4][4],
                                             const uint32_t (&w)[8], int fmt) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = widen2(w[2 * ks], fmt);
    a[ks][1] = widen2(w[2 * ks] >> 16, fmt);
    a[ks][2] = widen2(w[2 * ks + 1], fmt);
    a[ks][3] = widen2(w[2 * ks + 1] >> 16, fmt);
  }
}

// Built with -DDKV_PROBE (kernels/fp8_attention/probe.py --dkv), thread 0 of
// every block attributes its SM clock to the parts below and records the
// block's start and end (global timer, ns), SM, (h, b, kv block) and the
// 128-row q tiles it visited (probe.dkv_schedule_faults holds them against
// ops.dkv_block_order and ops.dkv_live_tiles).
enum DkvPart { D_STAGE, D_SPROD, D_SPEPI, D_DV, D_DPPROD, D_DSEPI, D_DK,
               D_STORE, N_DPART };
#ifdef DKV_PROBE
constexpr int DKV_PROBE_BLOCKS = 16384, DKV_PROBE_WORDS = 9 + N_DPART;
__device__ unsigned long long dkv_probe_blocks[DKV_PROBE_BLOCKS]
                                              [DKV_PROBE_WORDS];
__device__ __forceinline__ unsigned long long dkv_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DKV_TICK(k)                  \
  {                                  \
    const long long now = clock64(); \
    probe_c[k] += now - probe_last;  \
    probe_last = now;                \
  }
#else
#define DKV_TICK(k)
#endif

// One block per (query head h, batch row b, 64 kv rows; at D = 256 also
// the output half dh): head h's part of the dK / dV chain, the 128-row q
// tiles whose kv_span holds these rows in ascending order, each in two
// steps of 64 q rows. With a GQA group of one it writes dK * f_dk and
// dV * f_dv; else head h's raw partials into `part` ((2, B, H, S, D) f32),
// which attn_bwd_dkv_kernel_group_sum adds. At D = 256 both halves' blocks
// compute S^T and dP^T over the whole head dim and the same P8 / dS8, and
// each accumulates its 128 columns of dK and dV: the 64 + 64 accumulator
// registers a thread of D = 128.
template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 2)
    attn_bwd_dkv_kernel_head(Args p, float* part) {
  using F = Dkv<D>;
  constexpr int DK_KH = F::KH, DK_VH = F::VH, DK_QH = F::QH, DK_DH = F::DOH;
  constexpr int DK_RING = F::RING, DK_STAGE = F::STAGE, DK_RCP = F::RCP;
  constexpr int DK_M = F::M, DK_RD = F::RD, DK_PRE = F::PRE;
  constexpr int ST_Q = F::ST_Q, ST_DO = F::ST_DO, ST_STATS = F::ST_STATS;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (sbase & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ops.dkv_block_order: blockIdx.z walks the kv blocks ascending, along
  // which the chains never grow (longest first).
  const int h = blockIdx.x, b = blockIdx.y, kb = blockIdx.z / F::DH;
  const int dh = blockIdx.z % F::DH;
  const int group = p.H / p.Hkv, hk = h / group;
  const int kv0 = kb * BKV, jblk = kv0 / LANE;
  const uint32_t bh = (uint32_t)(b * p.hash_h + p.head0 + h);
  const uint32_t seed = *p.seed;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;
  const long long qoff = (long long)(b * p.H + h) * p.Q * D;
  const long long roff = (long long)(b * p.H + h) * p.Q;
  const uint8_t* qg = p.q + qoff;
  const uint8_t* dog = p.dO + qoff;
#ifdef DKV_PROBE
  const unsigned long long probe_ns = dkv_global_ns();
  long long probe_c[N_DPART] = {};
  const long long probe_clk = clock64();
  long long probe_last = probe_clk;
#endif

  // The q tiles whose kv_span holds this kv block: an interval
  // (ops.dkv_live_tiles) under the causal (+ window) and full masks.
  const int nt_q = (p.Q + TQ - 1) / TQ;
  int tq_lo = nt_q, tq_hi = -1;
  for (int tq = 0; tq < nt_q; ++tq) {
    int jmin, jmax;
    kv_span(p, tq * TQ, jmin, jmax);
    if (jblk >= jmin && jblk <= jmax) {
      tq_lo = min(tq_lo, tq);
      tq_hi = tq;
    }
  }
  const int nu = tq_hi >= tq_lo ? 2 * (tq_hi - tq_lo + 1) : 0;
  auto row0_of = [&](int u) { return (tq_lo + (u >> 1)) * TQ + (u & 1) * QU; };

  // Step u's q and dO bytes and m, l, rd rows into ring stage st (rows at
  // or past Q read as zeros: m = 0, d_safe = 1, rd = 0, q = dO = 0).
  auto load = [&](int u, int st) {
    const int r0 = row0_of(u);
    const uint32_t s = sbase + DK_RING + st * DK_STAGE;
#pragma unroll
    for (int i = 0; i < QU * D / 16 / DKV_THREADS; ++i) {
      const int un = tid + i * DKV_THREADS;
      const int row = (un >> 2) % QU, seg = (un >> 2) / QU;
      const bool in = r0 + row < p.Q;
      const long long off =
          (long long)(in ? r0 + row : 0) * D + seg * 64 + (un & 3) * 16;
      cp16_zfill(s + ST_Q + un * 16, qg + off, in);
      cp16_zfill(s + ST_DO + un * 16, dog + off, in);
    }
    for (int i = tid; i < 3 * QU; i += DKV_THREADS) {
      const int r = i % QU;
      const float* src = i < QU ? p.m : (i < 2 * QU ? p.l : p.rd);
      const bool in = r0 + r < p.Q;
      cp4_zfill(s + ST_STATS + i * 4, src + roff + (in ? r0 + r : 0), in);
    }
  };

  // K and V, widened once (kv rows < S: the wrapper pads S).
#pragma unroll
  for (int i = 0; i < BKV * D / 16 / DKV_THREADS; ++i) {
    const int un = tid + i * DKV_THREADS;
    const int seg = un / (BKV * 4), row = (un >> 2) % BKV, q4 = un & 3;
    const long long off =
        kvoff + (long long)(kv0 + row) * D + seg * 64 + q4 * 16;
    const uint4 xk = __ldg(reinterpret_cast<const uint4*>(p.k + off));
    const uint4 xv = __ldg(reinterpret_cast<const uint4*>(p.v + off));
    widen_unit(smem + DK_KH + seg * (BKV * 128) + row * 128, row, q4, xk,
               p.k_fmt);
    widen_unit(smem + DK_VH + seg * (BKV * 128) + row * 128, row, q4, xv,
               p.v_fmt);
  }
  if (nu > 0) load(0, 0);
  cp_commit();
  if (nu > 1) load(1, 1);
  cp_commit();

  // This thread's two kv rows (g and g + 8 of its warp's 16: the columns of
  // its scores), and the q rows that attend each: is_valid, rows < Q.
  int ccol[2], rlo[2], rhi[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int c = kv0 + warp * 16 + g + 8 * hf;
    ccol[hf] = c;
    rlo[hf] = c >= p.s_len ? p.Q : (p.causal ? c : 0);
    rhi[hf] = (p.causal && p.window) ? min(c + p.window - 1, p.Q - 1)
                                     : p.Q - 1;
  }
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const double* rowr = reinterpret_cast<const double*>(smem + DK_RCP);
  const float* rowm = reinterpret_cast<const float*>(smem + DK_M);
  const float* rowrd = reinterpret_cast<const float*>(smem + DK_RD);
  const uint32_t* pre = reinterpret_cast<const uint32_t*>(smem + DK_PRE);
  const uint32_t sk = sbase + DK_KH, sv = sbase + DK_VH;
  const uint32_t sq = sbase + DK_QH, sd = sbase + DK_DH;
  // The MN-major B operands of dK and dV: the output half's two segments.
  const uint32_t sq_out = sq + dh * 2 * (QU * 128);
  const uint32_t sd_out = sd + dh * 2 * (QU * 128);
  DKV_TICK(D_STAGE)

  for (int u = 0; u < nu; ++u) {
    const int st = u & 1, r0 = row0_of(u);
    cp_wait<1>();
    __syncthreads();  // stage st landed; the previous step's tiles consumed
    {
      const uint8_t* s = smem + DK_RING + st * DK_STAGE;
      widen_tile<D, true, DKV_THREADS>(smem + DK_QH, s + ST_Q, p.q_fmt, tid);
      widen_tile<D, true, DKV_THREADS>(smem + DK_DH, s + ST_DO, p.do_fmt, tid);
      const float* stats = reinterpret_cast<const float*>(s + ST_STATS);
      const int r = tid % QU;
      if (tid < QU) {
        const float l = stats[QU + r];
        reinterpret_cast<double*>(smem + DK_RCP)[r] =
            fp8::rcp_rn(l > 0.f ? l : 1.f);
        reinterpret_cast<float*>(smem + DK_M)[r] = stats[r];
        reinterpret_cast<float*>(smem + DK_RD)[r] = stats[2 * QU + r];
      }
      // The SR hash prefixes of the step's rows: S and P (threads 0-63),
      // dP and dS (64-127).
      const uint32_t salt = tid < QU ? SALT_S : SALT_DP;
      uint32_t* pw = reinterpret_cast<uint32_t*>(smem + DK_PRE);
      pw[(salt - SALT_S) * QU + r] = hash_row(seed, salt, bh, r0 + r);
      pw[(salt + 1 - SALT_S) * QU + r] = hash_row(seed, salt + 1, bh, r0 + r);
    }
    fence_async_smem();
    __syncthreads();
    if (u + 2 < nu) load(u + 2, st);
    cp_commit();
    DKV_TICK(D_STAGE)

    // S^T = K . Q^T (64 kv rows x 64 q rows).
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      fp8::wgmma_n64<0, 0>(
          s, slice_desc<false>(sk + (kk >> 2) * (BKV * 128), kk & 3),
          slice_desc<false>(sq + (kk >> 2) * (QU * 128), kk & 3));
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    DKV_TICK(D_SPROD)

    // S8 per score into a word per fragment (byte e = element e), then P8
    // over it. Fragment f holds q rows r0 + 8f + 2t + (e & 1) of kv rows
    // ccol[e >> 1]: the SR prefixes and row statistics are read per row
    // pair, the column step taken per score.
    uint32_t w[8];
    with_qnode(p.sr_s, p.sat_s, p.fmt_s, [&](auto qn) {
      using QN = decltype(qn);
      constexpr QConst qc = make_qconst(QN::FMT, QN::SAT);
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int r = 8 * f + 2 * t;
        const uint2 hs = QN::SR ? *reinterpret_cast<const uint2*>(pre + r)
                                : make_uint2(0u, 0u);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t q8 = quant_bf<QN::SR>(
              __fmul_rn(s[4 * f + e], p.f_s),
              QN::SR ? hash_col((e & 1) ? hs.y : hs.x, ccol[e >> 1]) : 0u,
              qc);
          word |= q8 << (8 * e);
        }
        w[f] = word;
      }
    });
    with_qnode(p.sr_p, p.sat_p, p.fmt_p, [&](auto qn) {
      using QN = decltype(qn);
      constexpr QConst qc = make_qconst(QN::FMT, QN::SAT);
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int r = 8 * f + 2 * t, row = r0 + r;
        const float2 m2 = *reinterpret_cast<const float2*>(rowm + r);
        const double2 y2 = *reinterpret_cast<const double2*>(rowr + r);
        const uint2 hp = QN::SR
                             ? *reinterpret_cast<const uint2*>(pre + QU + r)
                             : make_uint2(0u, 0u);
        float sv[4];
        word_to_f32(w[f], p.fmt_s, sv);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, o = e & 1, qr = row + o;
          const bool ok = qr >= rlo[hf] && qr <= rhi[hf];
          // exp(-inf) = +0: the masked score's e, with no branch.
          const float ev = expf(
              ok ? __fsub_rn(__fmul_rn(sv[e], p.s_s), o ? m2.y : m2.x)
                 : -INFINITY);
          const uint32_t p8 = quant_bf<QN::SR>(
              __fmul_rn(fp8::mul_rcp(ev, o ? y2.y : y2.x), p.f_p),
              QN::SR ? hash_col(o ? hp.y : hp.x, ccol[hf]) : 0u, qc);
          word |= p8 << (8 * e);
        }
        w[f] = word;
      }
    });
    DKV_TICK(D_SPEPI)

    // dV += P8^T . dO8 (P8 widened as the register A operand, dO the
    // MN-major B operand), then dP^T = V . dO^T, in two groups.
    uint32_t a[4][4];
    a_from_words(a, w, p.fmt_p);
    float dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = 0.f;
    fence_acc(dv);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < QU / 16; ++ks)
      fp8::wgmma_n128_rs<1>(dv, a[ks], slice_desc<true>(sd_out, ks));
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      fp8::wgmma_n64<0, 0>(
          dp, slice_desc<false>(sv + (kk >> 2) * (BKV * 128), kk & 3),
          slice_desc<false>(sd + (kk >> 2) * (QU * 128), kk & 3));
    wg_commit();
    wg_wait<1>();
    fence_acc(dv);
    fp8::keep_a(a);
    DKV_TICK(D_DV)
    wg_wait<0>();
    fence_acc(dp);
    DKV_TICK(D_DPPROD)

    // dP8, then dS8 = Q_E(P * (dP - rd) * f_ds) per score.
    uint32_t wd[8];
    with_qnode(p.sr_e, p.sat_e, p.fmt_e, [&](auto qn) {
      using QN = decltype(qn);
      constexpr QConst qc = make_qconst(QN::FMT, QN::SAT);
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int r = 8 * f + 2 * t;
        const float2 rd2 = *reinterpret_cast<const float2*>(rowrd + r);
        const uint2 hdp =
            QN::SR ? *reinterpret_cast<const uint2*>(pre + 2 * QU + r)
                   : make_uint2(0u, 0u);
        const uint2 hds =
            QN::SR ? *reinterpret_cast<const uint2*>(pre + 3 * QU + r)
                   : make_uint2(0u, 0u);
        float pv[4];
        word_to_f32(w[f], p.fmt_p, pv);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, o = e & 1;
          const uint32_t dp8 = quant_bf<QN::SR>(
              __fmul_rn(dp[4 * f + e], p.f_dp),
              QN::SR ? hash_col(o ? hdp.y : hdp.x, ccol[hf]) : 0u, qc);
          const float dpd = __fmul_rn(byte_to_f32(dp8, QN::FMT), p.s_dp);
          const float ds = __fmul_rn(__fmul_rn(pv[e], p.s_p),
                                     __fsub_rn(dpd, o ? rd2.y : rd2.x));
          const uint32_t ds8 = quant_bf<QN::SR>(
              __fmul_rn(ds, p.f_ds),
              QN::SR ? hash_col(o ? hds.y : hds.x, ccol[hf]) : 0u, qc);
          word |= ds8 << (8 * e);
        }
        wd[f] = word;
      }
    });
    DKV_TICK(D_DSEPI)

    // dK += dS8^T . Q8 (Q the MN-major B operand), waited on before the
    // next step's staging overwrites Q.
    a_from_words(a, wd, p.fmt_e);
    fence_acc(dk);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < QU / 16; ++ks)
      fp8::wgmma_n128_rs<1>(dk, a[ks], slice_desc<true>(sq_out, ks));
    wg_commit();
    wg_wait<0>();
    fence_acc(dk);
    fp8::keep_a(a);
    DKV_TICK(D_DK)
  }
  cp_wait<0>();

  // dK * f_dk and dV * f_dv, or head h's raw partials.
  const bool own = group == 1;
  const long long ooff = own ? kvoff : (long long)(b * p.H + h) * p.S * D;
  float* outk = own ? p.dk : part;
  float* outv = own ? p.dv : part + (long long)p.B * p.H * p.S * D;
  const float fk = own ? p.f_dk : 1.f, fv = own ? p.f_dv : 1.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long r = ooff + (long long)ccol[hf] * D + dh * DO;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = nt * 8 + 2 * t, i = 4 * nt + 2 * hf;
      *reinterpret_cast<float2*>(outk + r + c) =
          make_float2(__fmul_rn(dk[i], fk), __fmul_rn(dk[i + 1], fk));
      *reinterpret_cast<float2*>(outv + r + c) =
          make_float2(__fmul_rn(dv[i], fv), __fmul_rn(dv[i + 1], fv));
    }
  }
#ifdef DKV_PROBE
  DKV_TICK(D_STORE)
  const int bid =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (tid == 0 && bid < DKV_PROBE_BLOCKS) {
    unsigned int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    unsigned long long* rec = dkv_probe_blocks[bid];
    rec[0] = probe_ns;
    rec[1] = dkv_global_ns();
    rec[2] = smid;
    rec[3] = clock64() - probe_clk;
    rec[4] = h;
    rec[5] = b;
    rec[6] = kb;
    unsigned long long tiles = 0;  // q tile tq visited: bit tq (nt_q <= 64)
    for (int u = 0; u < nu; u += 2) tiles |= 1ull << ((row0_of(u) / TQ) & 63);
    rec[7] = tiles;
    rec[8] = nu;
    for (int k = 0; k < N_DPART; ++k) rec[9 + k] = probe_c[k];
  }
#endif
}

// dK (blockIdx.y = 0) or dV (1) of each GQA group: its members' raw
// partials added in head order, ((P_0 + P_1) + P_2) ..., then scaled once.
// part: (2, B, H, S, D); dk, dv: (B, Hkv, S, D).
template <int D>
__global__ void __launch_bounds__(256)
    attn_bwd_dkv_kernel_group_sum(const float* part, float* dk, float* dv,
                                  int B, int H, int Hkv, int S, float f_dk,
                                  float f_dv) {
  const int group = H / Hkv, which = blockIdx.y;
  const long long per = (long long)S * D / 4;  // float4s a head
  const long long n = (long long)B * Hkv * per;
  const float4* src = reinterpret_cast<const float4*>(part) +
                      which * (long long)B * H * per;
  float4* dst = reinterpret_cast<float4*>(which ? dv : dk);
  const float f = which ? f_dv : f_dk;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long bk = i / per;  // b * Hkv + hk
  const float4* x = src + (bk * group) * per + i % per;
  float4 a = x[0];
  for (int m = 1; m < group; ++m) {
    const float4 y = x[m * per];
    a = make_float4(__fadd_rn(a.x, y.x), __fadd_rn(a.y, y.y),
                    __fadd_rn(a.z, y.z), __fadd_rn(a.w, y.w));
  }
  dst[i] = make_float4(__fmul_rn(a.x, f), __fmul_rn(a.y, f),
                       __fmul_rn(a.z, f), __fmul_rn(a.w, f));
}

template <int D>
cudaError_t dkv_prepare() {
  return cudaFuncSetAttribute(attn_bwd_dkv_kernel_head<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Dkv<D>::SMEM);
}

Args make_args(const void* q, const void* k, const void* v, const void* dO,
               const void* seed, void* dq, void* m, void* l, void* rd,
               void* amax_dp, void* amax_ds, void* dk, void* dv, const int* iv,
               const float* fv, void* counts = nullptr) {
  Args p;
  p.counts = static_cast<int*>(counts);
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
  p.hash_h = iv[23]; p.head0 = iv[24];
  p.f_s = fv[0]; p.s_s = fv[1]; p.f_p = fv[2]; p.s_p = fv[3];
  p.f_dp = fv[4]; p.s_dp = fv[5]; p.f_ds = fv[6]; p.f_dq = fv[7];
  p.f_dk = fv[8]; p.f_dv = fv[9];
  return p;
}

// The most kv blocks any q tile's span covers (kv_span over the 128-row
// q tiles), on the host: the stash variant sizes its stashes by it.
int span_blocks(const Args& p) {
  const int nk = p.S / LANE;
  if (!p.causal) return nk;
  int most = 0;
  for (int t0 = 0; t0 < p.Q; t0 += TQ) {
    const int jmax = std::min((t0 + TQ - 1) / LANE, nk - 1);
    const int jmin = p.window ? std::max(t0 - p.window + 1, 0) / LANE : 0;
    most = std::max(most, jmax - jmin + 1);
  }
  return most;
}

template <int D>
int stash_smem_bytes(int blocks) {
  return TILE_BYTES<D> + 32 + blocks * 2 * STASH_WORDS * 4;
}

template <bool COUNTS, int D>
cudaError_t stash_prepare(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel_stash<COUNTS, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(attn_bwd_dq_kernel_stash<COUNTS, D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool COUNTS, int D>
int dq_launch(const Args& p, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(SmemDQ<D>));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<COUNTS, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(D / DO * ((p.Q + BQ - 1) / BQ), p.H, p.B);
  attn_bwd_dq_kernel<COUNTS, D><<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNTS, int D>
int stash_launch(const Args& p, int blocks, cudaStream_t st) {
  const int smem = stash_smem_bytes<D>(blocks);
  cudaError_t err = stash_prepare<COUNTS, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const QConsts qc{make_qconst(p.fmt_s, p.sat_s), make_qconst(p.fmt_p, p.sat_p),
                   make_qconst(p.fmt_e, p.sat_e)};
  dim3 grid(p.H, p.B, D / DO * ((p.Q + BQ - 1) / BQ));
  attn_bwd_dq_kernel_stash<COUNTS, D><<<grid, 128, smem, st>>>(p, qc);
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNTS, int D>
int stash_info(int blocks, int* out) {
  const int smem = stash_smem_bytes<D>(blocks);
  cudaError_t err = stash_prepare<COUNTS, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, attn_bwd_dq_kernel_stash<COUNTS, D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, attn_bwd_dq_kernel_stash<COUNTS, D>, 128, smem);
  out[0] = smem;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = resident;
  return static_cast<int>(err);
}

template <int D>
int dkv_launch(const Args& p, float* part, cudaStream_t st) {
  cudaError_t err = dkv_prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.H, p.B, D / DO * (p.S / BKV));
  attn_bwd_dkv_kernel_head<D><<<grid, DKV_THREADS, Dkv<D>::SMEM, st>>>(p,
                                                                       part);
  if (p.H != p.Hkv) {
    // One float4 of dK or dV a thread.
    const long long n4 = (long long)p.B * p.Hkv * p.S * D / 4;
    const dim3 sgrid(static_cast<unsigned>((n4 + 255) / 256), 2);
    attn_bwd_dkv_kernel_group_sum<D><<<sgrid, 256, 0, st>>>(
        part, p.dk, p.dv, p.B, p.H, p.Hkv, p.S, p.f_dk, p.f_dv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_info(int* out) {
  cudaError_t err = dkv_prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a, g;
  err = cudaFuncGetAttributes(&a, attn_bwd_dkv_kernel_head<D>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&g, attn_bwd_dkv_kernel_group_sum<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, attn_bwd_dkv_kernel_head<D>, DKV_THREADS, Dkv<D>::SMEM);
  out[0] = Dkv<D>::SMEM;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = resident;
  out[4] = g.numRegs;
  out[5] = static_cast<int>(g.localSizeBytes);
  return static_cast<int>(err);
}

// A library holds the kernels at one head dim, FP8_ATTN_D (128 unless the
// build defines it 256: kernels/build.py builds both, in parallel).
#ifndef FP8_ATTN_D
#define FP8_ATTN_D 128
#endif

// f<FP8_ATTN_D>() for the library's head dim d; cudaErrorInvalidValue for
// another.
template <class F>
int by_head_dim(int d, F&& f) {
  if (d != FP8_ATTN_D) return static_cast<int>(cudaErrorInvalidValue);
  return f(std::integral_constant<int, FP8_ATTN_D>{});
}

}  // namespace

// The long-span dQ kernel's dynamic shared memory at head dim d (bytes).
extern "C" int attn_bwd_dq_smem_bytes(int d) {
  return by_head_dim(d, [](auto dd) {
    return static_cast<int>(sizeof(SmemDQ<decltype(dd)::value>));
  });
}

// Integer arguments `iv` (25): B, H, Hkv, Q, S, q_len, s_len, causal,
// window, q/k/v/dO formats, fmt_s, fmt_p, fmt_e, sr_s, sr_p, sr_e, sat_s,
// sat_p, sat_e, D, hash_h, head0 (the SR hash's heads, Args). Float
// arguments `fv` (10): f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds, f_dq, f_dk,
// f_dv. Both arrays are read on the host. D must be the library's
// FP8_ATTN_D and S a multiple of 128 (the wrapper pads).
// Return cudaGetLastError().

// Kernel 1, long-span variant: grid (ceil(Q/64) x D/128, H, B). Writes dq,
// m, l, rd, amax_dp/ds, and with a non-null `counts` (the count variant)
// the (B, H, ceil(Q/64), 6) int32 dP / dS counts.
extern "C" int attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dO, const void* seed, void* dq,
                                  void* m, void* l, void* rd, void* amax_dp,
                                  void* amax_ds, void* counts, const int* iv,
                                  const float* fv, void* stream) {
  Args p = make_args(q, k, v, dO, seed, dq, m, l, rd, amax_dp, amax_ds,
                     nullptr, nullptr, iv, fv, counts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(iv[22], [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return counts ? dq_launch<true, D>(p, st) : dq_launch<false, D>(p, st);
  });
}

// Kernel 2: grid (H, B, S/64 x D/128) of attn_bwd_dkv_kernel_head, then,
// for a GQA group of more than one, attn_bwd_dkv_kernel_group_sum over
// `part`, a (2, B, H, S, D) f32 scratch (unused, and may be null, for a
// group of one). Reads m, l, rd of kernel 1; writes dk, dv (B, Hkv, S, D).
extern "C" int attn_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* seed, const void* m,
                                   const void* l, const void* rd, void* dk,
                                   void* dv, void* part, const int* iv,
                                   const float* fv, void* stream) {
  Args p = make_args(q, k, v, dO, seed, nullptr, const_cast<void*>(m),
                     const_cast<void*>(l), const_cast<void*>(rd), nullptr,
                     nullptr, dk, dv, iv, fv);
  if (p.H != p.Hkv && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(iv[22], [&](auto dd) {
    return dkv_launch<decltype(dd)::value>(p, static_cast<float*>(part), st);
  });
}

// At head dim d: out = {attn_bwd_dkv_kernel_head's dynamic shared memory
// bytes, registers a thread, local (spill) bytes a thread, blocks resident
// per SM; attn_bwd_dkv_kernel_group_sum's registers and local bytes a
// thread}. Returns a cudaError_t.
extern "C" int attn_bwd_dkv_info(int d, int* out) {
  return by_head_dim(d, [&](auto dd) {
    return dkv_info<decltype(dd)::value>(out);
  });
}

// Kernel 1, stash variant: grid (H, B, ceil(Q/64) x D/128), for launches
// whose every q tile spans at most STASH_BLOCKS kv blocks
// (cudaErrorInvalidValue otherwise). Same arguments and outputs as
// attn_bwd_dq_launch.
extern "C" int attn_bwd_dq_stash_launch(const void* q, const void* k,
                                        const void* v, const void* dO,
                                        const void* seed, void* dq, void* m,
                                        void* l, void* rd, void* amax_dp,
                                        void* amax_ds, void* counts,
                                        const int* iv, const float* fv,
                                        void* stream) {
  Args p = make_args(q, k, v, dO, seed, dq, m, l, rd, amax_dp, amax_ds,
                     nullptr, nullptr, iv, fv, counts);
  const int blocks = span_blocks(p);
  if (blocks < 1 || blocks > STASH_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(iv[22], [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return counts ? stash_launch<true, D>(p, blocks, st)
                  : stash_launch<false, D>(p, blocks, st);
  });
}

// The stash variant at head dim d (its count variant if `counts`) at a
// span of `blocks` kv blocks: out = {dynamic shared memory bytes, registers
// a thread, local (spill) bytes a thread, blocks resident per SM}. Returns
// a cudaError_t.
extern "C" int attn_bwd_dq_stash_info(int d, int blocks, int counts,
                                      int* out) {
  return by_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return counts ? stash_info<true, D>(blocks, out)
                  : stash_info<false, D>(blocks, out);
  });
}

#ifdef DQ_PROBE
// The probe's records (marks: 2 x 8, blocks: n x 4) after a launch.
extern "C" int attn_bwd_dq_probe_read(unsigned long long* marks,
                                      unsigned long long* blocks, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(marks, dq_probe_marks,
                                         sizeof(dq_probe_marks));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(
      blocks, dq_probe_blocks,
      sizeof(unsigned long long) * 4 * std::min(n, PROBE_BLOCKS)));
}
#endif

#ifdef DKV_PROBE
// The probe's per-block records (n x DKV_PROBE_WORDS) after a launch: start
// and end (ns), SM, clocks, h, b, kv block, the visited q tiles' bits, the
// steps, then the cycles of each part.
extern "C" int attn_bwd_dkv_probe_read(unsigned long long* blocks, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      blocks, dkv_probe_blocks,
      sizeof(unsigned long long) * DKV_PROBE_WORDS *
          std::min(n, DKV_PROBE_BLOCKS)));
}
#endif
