// Streamed-KV FP8 flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fp8_attention/kernel.py::fp8_attention_fwd_kernel
//   (bodies _fwd_body, _masked_none_fwd, _fwd_body_chunk, and with
//   attn_fwd_kernel<true> the count variant _fwd_body_counts)
// and computes the same function, ref.fwd_stripe_online per 128-column
// block in ascending order:
//   S8 = Q_A((q8 . k8^T) * f_s);  x = valid ? S8 * s_s : -1e30
//   m' = max(m, rowmax x);  c = exp(m - m');  e = valid ? exp(x - m') : 0
//   E8 = Q_A(e * f_p)  (unnormalized probs);  l = l*c + rowsum e
//   acc = acc*c + E8 . v8;  m = m'
//   O = (acc * f_o) / (l > 0 ? l : 1)  -> bf16
// with the S/P amaxes in grid units masked to the attended region
// (valid positions of rows < Q). Masks: causal (+ sliding window), full, kv
// (per-column validity), chunk (slot positions against q positions
// start + row for rows < n_valid, -1 otherwise). GQA reads kv head
// h / (H / Hkv) directly — no repeated K/V. SR bits come from the counter
// hash of (seed, salt 0x51 / 0x52, b*H + h, row, col); the seed is read
// from device memory, where the caller's generator drew it. Built with
// --fmad=false; the epilogue rounds every product and sum on its own.
//
// Structure: one block per (b, h, 128-row q tile), two warpgroups of 64
// rows sharing each kv block's tiles. The TPU's sequential kv grid axis
// becomes a loop over the tile's live 128-column kv blocks:
//  - the schedule (kernels/fp8_attention/ops.py::fwd_live_blocks,
//    fwd_dead_warps, fwd_tile_order): the causal (+ window) span, as
//    kv_stripe_span; in kv and chunk mode also no block whose columns all
//    miss the tile's union of row ranges (holes, or slots later than the
//    last live query position) — exact: such a block adds e = 0, keeps m,
//    so c = 1, and touches no amax. A warp whose 16 rows are all dead
//    (row >= Q, or qpos = -1) skips its epilogue and stores zeros, a
//    warpgroup of dead rows also its products, and a warp whose upper 8
//    rows are dead (a decode row) skips their scores. blockIdx.z walks the
//    tiles from the last, so the longest causal spans start first;
//  - copies: a 2-stage cp.async ring holds the fp8 K and V bytes (and the
//    kv mask words) of the next two live blocks while this one computes;
//    each stage is widened exactly into 128-byte-swizzled f16 tiles (e5m2
//    by a byte shift, e4m3 by cvt.rn.f16x2.e4m3x2): K K-major, V as it
//    lies (MN-major for P.V), so no transposed copy exists;
//  - S = Q.K^T: wgmma m64n64k16 from the swizzled Q and K tiles, a chunk
//    of 64 kv columns at a time in a run-time loop; each chunk's scores
//    are quantized (the branch-free Q nodes of fp8_epilogue.cuh, folded at
//    compile time for the call's rounding, saturation and format, chosen
//    once outside the loops; the SR hash's row prefix taken once per row),
//    masked by one pair of integer compares against a per-column key in
//    shared memory, and their S8 bytes kept in a thread-private stash word
//    per accumulator fragment;
//  - P: a run-time loop, four fragments a step, reads the stash back and
//    writes each E8 word over its S8 word (exp of -inf for a masked score,
//    so no branch); then P.V feeds the E8 words, widened to f16 (exact), as
//    wgmma's A operand from registers (the accumulator layout of S is the
//    A layout) against V's MN-major descriptor: m64n128k16 into a fresh f32
//    product, added as acc*c + pv after the block;
//  - the amaxes are kept as fp8 magnitude bytes (they order like the
//    values, inf and NaN above every finite one) and decoded once a tile;
//    the output's division is fp8_epilogue.cuh's div_rn (no slow-path
//    call).
// Shared memory: Q, K and V f16 tiles (96 KB), the ring (65 KB), the stash
// (16 KB), column keys and the live-block list: one block of 8 warps an SM.
//
// Head dims: a library is built at D = 128 or D = 256 (FP8_ATTN_D; the
// wrapper pads smaller heads). At D = 256 (recurrentgemma-9b's heads) two
// blocks share each q tile, each computing the scores over the whole head
// dim and 128 of the output's columns (the SR bits' absolute coordinates
// give both the same S8 and E8), so a thread holds D = 128's accumulators;
// the ring has one stage, refilled as soon as it is widened (Fwd<D>).
//
// The count variant (COUNTS, the template switch; the wrapper's
// with_counts) also counts, per q tile, the observed S8 and E8 values
// that saturate (|q| >= max normal, or not finite) or flush (|q| < min
// normal) and the observed ones (valid columns of rows < Q): per
// fragment word, by byte-wise compares of the four magnitudes and a
// population count, then summed over the block in integers (no atomics:
// the counts do not depend on the order). The variant without it is the
// same code with the counting left out, and o and the amaxes do not
// depend on the switch.
//
// What bounds it (H100 SXM, 700 W; chip_smoke.py and
// kernels/fp8_attention/probe.py --fwd): the per-score epilogue, about 110
// instructions a score (two Q nodes, two SR hashes, an exp, the fp8
// conversions, masks and maxima) issued at about half an instruction a
// cycle by the two warps of each scheduler: 77% of a longest training
// tile's cycles. The products take 9%, staging 9%; the bytes bound is
// 3 us against ~70 us. PERF.md holds the times.
#include "fp8_epilogue.cuh"
#include "wgmma_tiles.cuh"

namespace {

using fp8::byte_to_f32;
using fp8::cp16;
using fp8::cp_commit;
using fp8::cp_wait;
using fp8::div_rn;
using fp8::fence_acc;
using fp8::fence_async_smem;
using fp8::fp8x2_to_half2;
using fp8::hash_col;
using fp8::hash_row;
using fp8::load_tile;
using fp8::make_qconst;
using fp8::QConst;
using fp8::quant_bf;
using fp8::slice_desc;
using fp8::wg_commit;
using fp8::wg_fence;
using fp8::wg_wait;
using fp8::widen_tile;
using fp8::widen_unit;
using fp8::with_flag;
using fp8::word_to_f32;

constexpr int BQ = 128;       // q rows per block
constexpr int THREADS = 256;  // two warpgroups of 64 rows
constexpr int LANE = 128;     // kv columns per online-softmax step
// Output columns per block: the P.V product's width. A block computes the
// scores over the whole head dim D (128 or 256; the wrapper zero-pads
// smaller heads) and the output's columns [dh * DV, dh * DV + DV).
constexpr int DV = 128;
// The S product's chunk width: 64 kv columns, 32 accumulators a thread
// (PERF.md holds the probe's times at 32, 64 and 128).
constexpr int NCH = 64;
constexpr uint32_t SALT_S = 0x51, SALT_P = 0x52;
constexpr int NONE = 0x7FFFFFFF;  // column key that no row range holds
constexpr int ANY = -0x7FFFFFFF - 1;

enum Mask { CAUSAL = 0, FULL = 1, KV = 2, CHUNK = 3 };

// The build at head dim D. Shared memory, by byte offset (the f16 tiles
// 1024-byte aligned for the 128-byte swizzle). QH: Q, K-major, D / 64
// d segments of 128 rows; KH: K the same; VH: the block's DV columns of
// V, two 64-row k halves, each two 64-wide d segments of 64 rows
// (MN-major). A ring stage: K then V fp8 in load_tile's unit order, then
// 128 kv mask words. STASH: S8 words [fragment][thread]. CK: the current
// block's column keys. LIST: the live-block count, then the blocks.
// At D = 128 one block covers the output (DH = 1) and the ring has two
// stages (177 KB at S = 512). At D = 256 two blocks share a q tile, each
// computing the scores in full and its half of the output, and the ring
// has one stage, refilled as soon as it is widened (225 KB at S = 4096):
// two stages would need 274 KB of the 227 KB a block may hold, and a
// 256-wide output accumulator 128 registers a thread more.
template <int D>
struct Fwd {
  static_assert(D == 128 || D == 256, "head dim 128 or 256");
  static constexpr int DH = D / DV;  // blocks per q tile
  static constexpr int STAGES = D == 128 ? 2 : 1;
  static constexpr int QH = 0, KH = QH + BQ * D * 2, VH = KH + LANE * D * 2;
  static constexpr int RING = VH + LANE * DV * 2;
  static constexpr int ST_K = 0, ST_V = LANE * D, ST_M = ST_V + LANE * DV;
  static constexpr int STAGE = ST_M + LANE * 4;
  static constexpr int STASH = RING + STAGES * STAGE;
  static constexpr int CK = STASH + (LANE / 8) * THREADS * 4;
  static constexpr int RED = CK + LANE * 4;
  static constexpr int LIST = RED + 2 * (THREADS / 32) * 4;
};

template <int D>
int smem_bytes(int nk) { return Fwd<D>::LIST + 4 * (nk + 1); }

struct Args {
  const uint8_t* q;   // (B, H, Q, D)
  const uint8_t* k;   // (B, Hkv, S, D), S a multiple of LANE
  const uint8_t* v;
  const int* kvm;     // (B, S) validity (kv) / slot positions (chunk)
  const int* chunk;   // (B, 2) [start, n_valid]
  __nv_bfloat16* o;   // (B, H, Q, D)
  float* amax_s;      // (B, H, nq)
  float* amax_p;
  int* counts;        // (B, H, nq, 6): S then P [saturated, flushed,
                      // observed] (with_counts), or null
  int B, H, Hkv, Q, S, s_len, mask, window;
  int q_fmt, k_fmt, v_fmt, fmt_s, fmt_p, sr_s, sr_p, sat_s, sat_p;
  float f_s, s_s, f_p, f_o;
  const uint32_t* seed;
  // The SR hash's head index of batch row b, head h: b * hash_h + head0 + h
  // (hash_h = H, head0 = 0, unless q holds heads head0.. of hash_h).
  int hash_h, head0;
};

// A column's key: valid for a row iff lo <= key <= hi of the row's range.
// Causal: the column; kv and full: 0; chunk: the slot's position; NONE for
// padding, holes and masked-out kv columns.
__device__ __forceinline__ int col_key(const Args& p, int col, int mv) {
  if (col >= p.s_len) return NONE;
  switch (p.mask) {
    case CAUSAL:
      return col;
    case KV:
      return mv != 0 ? 0 : NONE;
    case CHUNK:
      return mv >= 0 ? mv : NONE;
    default:
      return 0;
  }
}

// A row's range of column keys (empty for rows at or past Q).
__device__ __forceinline__ void row_range(const Args& p, int row, int start,
                                          int n_valid, int& lo, int& hi) {
  lo = 1;
  hi = 0;
  if (row >= p.Q) return;
  if (p.mask == CAUSAL || p.mask == CHUNK) {
    const int pos = p.mask == CAUSAL ? row : (row < n_valid ? start + row : -1);
    hi = pos;
    lo = p.window ? pos - p.window + 1 : ANY;
  } else {
    lo = hi = 0;
  }
}

// Built with -DFWD_PROBE (kernels/fp8_attention/probe.py), thread 0 of
// every block attributes its SM clock to the passes below and records the
// block's start and end (global timer, ns), SM, the kv blocks it visited
// and the warps that ran their epilogue (the schedule that
// probe.fwd_schedule_faults holds against ops.fwd_live_blocks and
// ops.fwd_dead_warps).
enum Pass { P_STAGE, P_SPROD, P_SEPI, P_PEPI, P_PV, P_RESCALE, P_STORE,
            N_PASS };
#ifdef FWD_PROBE
constexpr int PROBE_BLOCKS = 8192, PROBE_WORDS = 7 + THREADS / 32 + N_PASS;
__device__ unsigned long long fwd_probe_blocks[PROBE_BLOCKS][PROBE_WORDS];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FWD_TICK(k)                  \
  {                                  \
    const long long now = clock64(); \
    probe_c[k] += now - probe_last;  \
    probe_last = now;                \
  }
#else
#define FWD_TICK(k)
#endif

__device__ __forceinline__ uint32_t half2_bits(__half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// f(QNode, std::bool_constant<up>): a pass's Q node, and whether the
// upper rows (g + 8) of the warp hold live rows.
template <class F>
__device__ __forceinline__ void with_qnode(int sr, int sat, int fmt, bool up,
                                           F&& f) {
  with_flag(up, [&](auto u) {
    fp8::with_qnode(sr, sat, fmt, [&](auto qn) { f(qn, u); });
  });
}

// COUNTS: the count variant (the reference's _fwd_body_counts) also
// counts the saturated, flushed and observed S8 and E8 values of each q
// tile, next to the amaxes; the variant without it is the same code with
// the counting left out, and both compute the same o and amaxes.
template <bool COUNTS, int D>
__global__ void __launch_bounds__(THREADS, 1) attn_fwd_kernel(Args p) {
  using F = Fwd<D>;
  constexpr int QH = F::QH, KH = F::KH, VH = F::VH, RING = F::RING;
  constexpr int ST_K = F::ST_K, ST_V = F::ST_V, ST_M = F::ST_M;
  constexpr int STAGE = F::STAGE, STAGES = F::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (sbase & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  uint32_t* stash = reinterpret_cast<uint32_t*>(smem + F::STASH);
  int* ck = reinterpret_cast<int*>(smem + F::CK);
  uint32_t(*red)[THREADS / 32] =
      reinterpret_cast<uint32_t(*)[THREADS / 32]>(smem + F::RED);
  int* list = reinterpret_cast<int*>(smem + F::LIST);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  // Longest causal spans first: the z axis walks the q tiles from the last
  // (and, at D = 256, each tile's two output halves dh in turn).
  const int dh = blockIdx.z % F::DH;
  const int h = blockIdx.x, b = blockIdx.y,
            iq = gridDim.z / F::DH - 1 - blockIdx.z / F::DH;
  const int hk = h / (p.H / p.Hkv);
  const int row0 = iq * BQ;
  const int nk = p.S / LANE;
  const uint32_t bh = (uint32_t)(b * p.hash_h + p.head0 + h);
  const uint32_t seed = *p.seed;
  const bool kv_words = p.mask == KV || p.mask == CHUNK;
  const int start = p.mask == CHUNK ? p.chunk[2 * b] : 0;
  const int n_valid = p.mask == CHUNK ? p.chunk[2 * b + 1] : 0;
  const int live_rows = p.mask == CHUNK ? min(p.Q, n_valid) : p.Q;
  const bool wg_live = row0 + wg * 64 < live_rows;
  const bool warp_live = row0 + warp * 16 < live_rows;
  // Rows g + 8 of the warp live too (else their scores are skipped: a
  // decode row leaves them all dead).
  const bool upper_live = row0 + warp * 16 + 8 < live_rows;
  const long long kvoff = (long long)(b * p.Hkv + hk) * p.S * D;
  const uint8_t* kg = p.k + kvoff;
  const uint8_t* vg = p.v + kvoff + dh * DV;
  const int* kvmb = kv_words ? p.kvm + (long long)b * p.S : nullptr;
#ifdef FWD_PROBE
  const unsigned long long probe_ns = global_ns();
  long long probe_c[N_PASS] = {};
  const long long probe_clk = clock64();
  long long probe_last = probe_clk;
#endif

  // The live kv blocks of this tile: flags in list[1 + j], then compacted.
  if (live_rows <= row0) {
    for (int j = tid; j < nk; j += THREADS) list[1 + j] = 0;
  } else if (kv_words) {
    // The union of the tile's live row ranges (monotonic in the row).
    int lo, hi, lo_last, hi_last;
    row_range(p, row0, start, n_valid, lo, hi);
    row_range(p, min(row0 + BQ, live_rows) - 1, start, n_valid, lo_last,
              hi_last);
    for (int j = warp; j < nk; j += THREADS / 32) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < LANE / 32; ++i) {
        const int col = j * LANE + i * 32 + lane;
        const int key = col_key(p, col, kvmb[col]);
        any |= key >= lo && key <= hi_last;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) list[1 + j] = any;
    }
  } else {
    // kv_stripe_span: the causal (+ window) span; every block for 'full'.
    int jmin = 0, jmax = nk - 1;
    if (p.mask == CAUSAL) {
      jmax = min((row0 + BQ - 1) / LANE, nk - 1);
      if (p.window) jmin = max(row0 - p.window + 1, 0) / LANE;
    }
    for (int j = tid; j < nk; j += THREADS)
      list[1 + j] = j >= jmin && j <= jmax;
  }

  // Q -> the swizzled f16 tile (rows past Q read as zeros), as widen_tile
  // lays out a 128-row K-major tile per 64-wide d segment.
  {
    const uint8_t* qb = p.q + (long long)(b * p.H + h) * p.Q * D;
#pragma unroll
    for (int i = 0; i < BQ * D / 16 / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int seg = u / (BQ * 4), row = (u / 4) % BQ, q4 = u & 3;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row0 + row < p.Q)
        x = __ldg(reinterpret_cast<const uint4*>(
            qb + (long long)(row0 + row) * D + seg * 64 + q4 * 16));
      widen_unit(smem + QH + seg * (BQ * 128) + row * 128, row, q4, x,
                 p.q_fmt);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < nk; ++j)
      if (list[1 + j]) list[1 + n++] = j;
    list[0] = n;
  }
  __syncthreads();
  const int nlive = list[0];

  // kv block j's fp8 K, the block's DV columns of V and the mask words
  // into ring stage `st`.
  auto load = [&](int j, int st) {
    const uint32_t s = sbase + RING + st * STAGE;
    const uint8_t* kj = kg + (long long)j * LANE * D;
    const uint8_t* vj = vg + (long long)j * LANE * D;
#pragma unroll
    for (int sg = 0; sg < D / 64; ++sg)
      load_tile<LANE, false, THREADS>(s + ST_K + sg * LANE * 64, kj + sg * 64,
                                      D, tid);
    load_tile<DV, true, THREADS>(s + ST_V, vj, D, tid);
    load_tile<DV, true, THREADS>(s + ST_V + 64 * DV, vj + 64 * D, D, tid);
    if (kv_words && tid < LANE / 4)
      cp16(s + ST_M + tid * 16, kvmb + j * LANE + tid * 4);
  };
  if (nlive > 0) load(list[1], 0);
  cp_commit();
  if constexpr (STAGES > 1) {
    if (nlive > 1) load(list[2], 1);
    cp_commit();
  }

  // This thread's two rows (g and g + 8 of its warp's 16): the key range
  // (empty past Q, so that the amaxes observe exactly the valid scores),
  // the SR hash prefixes, m and l.
  int lo[2], hi[2];
  uint32_t hs[2], hp[2];
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + g + 8 * i;
    row_range(p, row, start, n_valid, lo[i], hi[i]);
    hs[i] = hash_row(seed, SALT_S, bh, row);
    hp[i] = hash_row(seed, SALT_P, bh, row);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // The amaxes as magnitude bytes: fp8 magnitudes order like the values,
  // inf and NaN above every finite one, so the largest byte decodes to
  // the NaN-propagating max of |S8| (|E8|) over the valid scores.
  uint32_t mag_s = 0, mag_p = 0;
  // Health counts of this thread's observed scores, in bits (8 a score,
  // a word's four bytes counted at once): S saturated, flushed, observed,
  // P saturated, flushed.
  uint32_t cnt[5] = {0u, 0u, 0u, 0u, 0u};
  const int2* ck2 = reinterpret_cast<const int2*>(ck);
  const uint32_t sq = sbase + QH + wg * 64 * 128;
  const uint32_t sk = sbase + KH, sv = sbase + VH;

  for (int i = 0; i < nlive; ++i) {
    const int j = list[1 + i], st = STAGES > 1 ? i & 1 : 0;
    cp_wait<STAGES - 1>();
    __syncthreads();  // stage st landed; the previous block's tiles consumed
    {
      const uint8_t* s = smem + RING + st * STAGE;
      uint8_t* kh = smem + KH;
      uint8_t* vh = smem + VH;
#pragma unroll
      for (int sg = 0; sg < D / 64; ++sg)
        widen_tile<LANE, false, THREADS>(kh + sg * LANE * 128,
                                         s + ST_K + sg * LANE * 64, p.k_fmt,
                                         tid);
      widen_tile<DV, true, THREADS>(vh, s + ST_V, p.v_fmt, tid);
      widen_tile<DV, true, THREADS>(vh + 64 * DV * 2, s + ST_V + 64 * DV,
                                    p.v_fmt, tid);
      const int* words = reinterpret_cast<const int*>(s + ST_M);
      if (tid < LANE)
        ck[tid] = col_key(p, j * LANE + tid, kv_words ? words[tid] : 0);
    }
    fence_async_smem();
    __syncthreads();
    if (i + STAGES < nlive) load(list[1 + i + STAGES], st);
    cp_commit();
    FWD_TICK(P_STAGE)
    if (!wg_live) continue;

    // S, a chunk of NCH kv columns at a time: quantize, mask, row max,
    // and the chunk's S8 bytes into the stash.
    float mx[2] = {-1e30f, -1e30f};
    with_qnode(p.sr_s, p.sat_s, p.fmt_s, upper_live, [&](auto qn, auto up) {
      using QN = decltype(qn);
      constexpr QConst qc = make_qconst(QN::FMT, QN::SAT);
      constexpr int NE = decltype(up)::value ? 4 : 2;  // elements per fragment
#pragma unroll 1
      for (int c = 0; c < LANE / NCH; ++c) {
        float s[NCH / 2];
#pragma unroll
        for (int e = 0; e < NCH / 2; ++e) s[e] = 0.f;
        fence_acc(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          fp8::wgmma_n64<0, 0>(
              s, slice_desc<false>(sq + (kk >> 2) * (BQ * 128), kk & 3),
              slice_desc<false>(sk + (kk >> 2) * (LANE * 128) + c * NCH * 128,
                                kk & 3));
        wg_commit();
        wg_wait<0>();
        fence_acc(s);
        FWD_TICK(P_SPROD)
        if (warp_live) {
#pragma unroll
          for (int f = 0; f < NCH / 8; ++f) {
            const int nt = c * (NCH / 8) + f;
            const int2 key = ck2[nt * 4 + t];
            uint32_t word = 0, okw = 0;
#pragma unroll
            for (int e = 0; e < NE; ++e) {
              const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
              const uint32_t q8 = quant_bf<QN::SR>(
                  __fmul_rn(s[4 * f + e], p.f_s),
                  QN::SR ? hash_col(hs[hf], col) : 0u, qc);
              word |= q8 << (8 * e);
              const int kv = (e & 1) ? key.y : key.x;
              const bool ok = kv >= lo[hf] && kv <= hi[hf];
              mag_s = max(mag_s, ok ? (q8 & 0x7Fu) : 0u);
              if constexpr (COUNTS) okw |= ok ? 0xFFu << (8 * e) : 0u;
              const float v = byte_to_f32(q8, QN::FMT);
              mx[hf] = fp8::nanmax(mx[hf], ok ? __fmul_rn(v, p.s_s) : -1e30f);
            }
            stash[nt * THREADS + tid] = word;
            if constexpr (COUNTS)
              fp8::count_word<true>(word, okw, fp8::sat_bits(QN::FMT),
                                    fp8::flush_bits(QN::FMT), cnt);
          }
        }
        FWD_TICK(P_SEPI)
      }
    });
    float corr[2] = {1.f, 1.f};
    if (warp_live) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fp8::nanmax(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fp8::nanmax(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float mn = fp8::nanmax(m[hf], mx[hf]);
        corr[hf] = expf(__fsub_rn(m[hf], mn));
        m[hf] = mn;
      }
    }
    FWD_TICK(P_SEPI)

    // P: e and E8 per score from the stash, each E8 word written over its
    // S8 word, four fragments (two 16-column k slices) a step.
    float rsum[2] = {0.f, 0.f};
    if (warp_live) {
      with_qnode(p.sr_p, p.sat_p, p.fmt_p, upper_live, [&](auto qn, auto up) {
        using QN = decltype(qn);
        constexpr QConst qc = make_qconst(QN::FMT, QN::SAT);
        constexpr int NE = decltype(up)::value ? 4 : 2;
#pragma unroll 1
        for (int kp = 0; kp < LANE / 32; ++kp) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int nt = 4 * kp + n;
            const int2 key = ck2[nt * 4 + t];
            float sv8[4];
            word_to_f32(stash[nt * THREADS + tid], p.fmt_s, sv8);
            uint32_t word = 0, okw = 0;
#pragma unroll
            for (int e = 0; e < NE; ++e) {
              const int hf = e >> 1, col = j * LANE + nt * 8 + 2 * t + (e & 1);
              const int kv = (e & 1) ? key.y : key.x;
              const bool ok = kv >= lo[hf] && kv <= hi[hf];
              // exp(-inf) = +0: the masked score's e, with no branch.
              const float ev = expf(
                  ok ? __fsub_rn(__fmul_rn(sv8[e], p.s_s), m[hf]) : -INFINITY);
              rsum[hf] = __fadd_rn(rsum[hf], ev);
              const uint32_t p8 = quant_bf<QN::SR>(
                  __fmul_rn(ev, p.f_p),
                  QN::SR ? hash_col(hp[hf], col) : 0u, qc);
              word |= p8 << (8 * e);
              mag_p = max(mag_p, ok ? (p8 & 0x7Fu) : 0u);
              if constexpr (COUNTS) okw |= ok ? 0xFFu << (8 * e) : 0u;
            }
            stash[nt * THREADS + tid] = word;
            if constexpr (COUNTS)
              fp8::count_word<false>(word, okw, fp8::sat_bits(QN::FMT),
                                     fp8::flush_bits(QN::FMT), cnt + 3);
          }
        }
      });
    }
    FWD_TICK(P_PEPI)

    // P.V: E8 widened to f16 (exact) as wgmma's A operand from registers
    // (the S accumulator layout is the A layout), V the MN-major B operand,
    // the eight k slices into a fresh f32 product. Dead warps feed zeros.
    float pv[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) pv[e] = 0.f;
    {
      uint32_t a[LANE / 16][4];
#pragma unroll
      for (int ks = 0; ks < LANE / 16; ++ks) {
        const uint32_t* w = stash + 2 * ks * THREADS + tid;
        const uint32_t w0 = warp_live ? w[0] : 0u;
        const uint32_t w1 = warp_live ? w[THREADS] : 0u;
        a[ks][0] = half2_bits(fp8x2_to_half2(w0, p.fmt_p));
        a[ks][1] = half2_bits(fp8x2_to_half2(w0 >> 16, p.fmt_p));
        a[ks][2] = half2_bits(fp8x2_to_half2(w1, p.fmt_p));
        a[ks][3] = half2_bits(fp8x2_to_half2(w1 >> 16, p.fmt_p));
      }
      fence_acc(pv);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < LANE / 16; ++ks)
        fp8::wgmma_n128_rs<1>(
            pv, a[ks],
            slice_desc<true>(sv + (ks >> 2) * (64 * DV * 2), ks & 3));
      wg_commit();
      wg_wait<0>();
      fence_acc(pv);
      fp8::keep_a(a);
    }
    FWD_TICK(P_PV)
    if (warp_live) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          rsum[hf] = __fadd_rn(rsum[hf],
                               __shfl_xor_sync(0xffffffffu, rsum[hf], off));
        l[hf] = __fadd_rn(__fmul_rn(l[hf], corr[hf]), rsum[hf]);
      }
#pragma unroll
      for (int e = 0; e < 64; ++e)
        acc[e] = __fadd_rn(__fmul_rn(acc[e], corr[(e >> 1) & 1]), pv[e]);
    }
    FWD_TICK(P_RESCALE)
  }
  cp_wait<0>();

  // O = (acc * f_o) / d_safe -> bf16; dead rows hold acc = l = 0 and give
  // exact zeros.
  __nv_bfloat16* ob = p.o + (long long)(b * p.H + h) * p.Q * D + dh * DV;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + warp * 16 + g + 8 * hf;
    if (row >= p.Q) continue;
    const float dsafe = l[hf] > 0.f ? l[hf] : 1.f;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      const float* a2 = acc + 4 * dt + 2 * hf;
      const float o0 = div_rn(__fmul_rn(a2[0], p.f_o), dsafe);
      const float o1 = div_rn(__fmul_rn(a2[1], p.f_o), dsafe);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * D + dt * 8 +
                                         2 * t) = __floats2bfloat162_rn(o0, o1);
    }
  }

  mag_s = __reduce_max_sync(0xffffffffu, mag_s);
  mag_p = __reduce_max_sync(0xffffffffu, mag_p);
  if (lane == 0) {
    red[0][warp] = mag_s;
    red[1][warp] = mag_p;
  }
  __syncthreads();
  // The amaxes and counts: the output halves of a q tile observe the same
  // scores, and the first one writes them.
  if (tid == 0 && dh == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      mag_s = max(mag_s, red[0][w]);
      mag_p = max(mag_p, red[1][w]);
    }
    const long long idx = (long long)(b * p.H + h) * (gridDim.z / F::DH) + iq;
    p.amax_s[idx] = byte_to_f32(mag_s, p.fmt_s);
    p.amax_p[idx] = byte_to_f32(mag_p, p.fmt_p);
  }
  if constexpr (COUNTS) {
    // The stash is free from here on: its words hold the block's sums.
    int sums[5];
    fp8::block_counts<5, THREADS / 32>(cnt, stash, sums);
    if (tid == 0 && dh == 0) {
      int* c = p.counts +
               ((long long)(b * p.H + h) * (gridDim.z / F::DH) + iq) * 6;
      c[0] = sums[0] / 8;
      c[1] = sums[1] / 8;
      c[2] = sums[2] / 8;
      c[3] = sums[3] / 8;
      c[4] = sums[4] / 8;
      c[5] = sums[2] / 8;
    }
  }
#ifdef FWD_PROBE
  FWD_TICK(P_STORE)
  const int bid =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (lane == 0 && bid < PROBE_BLOCKS)
    fwd_probe_blocks[bid][7 + warp] = warp_live;
  if (tid == 0 && bid < PROBE_BLOCKS) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* r = fwd_probe_blocks[bid];
    r[0] = probe_ns;
    r[1] = global_ns();
    r[2] = sm;
    r[3] = clock64() - probe_clk;
    r[4] = nlive;
    r[5] = iq;
    unsigned long long live = 0;  // kv block j visited: bit j (nk <= 64)
    for (int n = 0; n < nlive; ++n) live |= 1ull << (list[1 + n] & 63);
    r[6] = live;
    for (int k = 0; k < N_PASS; ++k) r[7 + THREADS / 32 + k] = probe_c[k];
  }
#endif
}

template <bool COUNTS, int D>
cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(attn_fwd_kernel<COUNTS, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <bool COUNTS, int D>
int info(int nk, int* out) {
  const int smem = smem_bytes<D>(nk);
  cudaError_t err = prepare<COUNTS, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, attn_fwd_kernel<COUNTS, D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, attn_fwd_kernel<COUNTS, D>, THREADS, smem);
  out[0] = smem;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = resident;
  return static_cast<int>(err);
}

template <bool COUNTS, int D>
int launch(const Args& p, int B, int H, int Q, int S, cudaStream_t stream) {
  const int smem = smem_bytes<D>(S / LANE);
  cudaError_t err = prepare<COUNTS, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, Fwd<D>::DH * ((Q + BQ - 1) / BQ));
  attn_fwd_kernel<COUNTS, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A library holds the kernel at one head dim, FP8_ATTN_D (128 unless the
// build defines it 256: kernels/build.py builds both, in parallel), and
// refuses the other (cudaErrorInvalidValue).
#ifndef FP8_ATTN_D
#define FP8_ATTN_D 128
#endif

// The kernel at head dim d and nk kv blocks, the count variant if
// `counts`: out = {dynamic shared memory bytes, registers a thread, local
// (spill) bytes a thread, blocks resident per SM}. Returns a cudaError_t.
extern "C" int attn_fwd_info(int d, int nk, int counts, int* out) {
  if (d != FP8_ATTN_D) return static_cast<int>(cudaErrorInvalidValue);
  return counts ? info<true, FP8_ATTN_D>(nk, out)
                : info<false, FP8_ATTN_D>(nk, out);
}

// Launch on `stream`: grid (H, B, ceil(Q/128) at D = 128, twice that at
// D = 256), 256 threads, ~178 KB of dynamic shared memory at D = 128 and
// S = 512, ~225 KB at D = 256 and S = 4096. D must be the library's
// FP8_ATTN_D and S a multiple of 128 (the wrapper pads). A non-null
// `counts` launches the count variant. Returns cudaGetLastError().
extern "C" int attn_fwd_launch(
    const void* q, const void* k, const void* v, const int* kvm,
    const int* chunk, void* o, float* amax_s, float* amax_p, int* counts,
    int B, int H,
    int Hkv, int Q, int S, int s_len, int mask, int window,
    int q_fmt, int k_fmt, int v_fmt, int fmt_s, int fmt_p, int sr_s, int sr_p,
    int sat_s, int sat_p, int D, float f_s, float s_s, float f_p, float f_o,
    const void* seed, int hash_h, int head0, void* stream) {
  Args p{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
         static_cast<const uint8_t*>(v), kvm, chunk,
         static_cast<__nv_bfloat16*>(o), amax_s, amax_p, counts, B, H, Hkv,
         Q, S,
         s_len, mask, window, q_fmt, k_fmt, v_fmt, fmt_s, fmt_p, sr_s,
         sr_p, sat_s, sat_p, f_s, s_s, f_p, f_o,
         static_cast<const uint32_t*>(seed), hash_h, head0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != FP8_ATTN_D) return static_cast<int>(cudaErrorInvalidValue);
  return counts ? launch<true, FP8_ATTN_D>(p, B, H, Q, S, st)
                : launch<false, FP8_ATTN_D>(p, B, H, Q, S, st);
}

#ifdef FWD_PROBE
// The probe's per-block records (n x PROBE_WORDS) after a launch: start and
// end (ns), SM, clocks, live kv blocks, q tile, the visited kv blocks' bits,
// whether each warp ran its epilogue, then the cycles of each pass.
extern "C" int attn_fwd_probe_read(unsigned long long* blocks, int n) {
  const int rows = n < PROBE_BLOCKS ? n : PROBE_BLOCKS;
  return static_cast<int>(cudaMemcpyFromSymbol(
      blocks, fwd_probe_blocks,
      sizeof(unsigned long long) * PROBE_WORDS * rows));
}
#endif
