// K2 and K2b: coarse gather-score kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of similaritysearchbyrdf_tpu/ops/pallas/
// coarse_gather.py: K2 `pallas_coarse_scores` (`_kernel`, blocks at
// arbitrary starts, block mode) and K2b `pallas_coarse_scores_aligned`
// (`_kernel_aligned*`, aligned windows of window mode, dead windows
// skipped; see `coarse_window_scores_kernel` below for what K2b adds).
// For every (query b, block m) K2 reads `bs` contiguous rows of
// table t = clip(table[b, m], 0, L-1) starting at s = clip(start[b, m], 0,
// caprows-bs) of the per-table int8 or bf16 tier [L, caprows, cs], and
// writes
//   out[b, m, j] = sum_c float(tier[t, s+j, c]) * float(q[b, c])
// with f32 accumulation: the numerics of the XLA scoring path
// (index/forest.py `_coarse_block_scores`, int8 or bf16 rows times a bf16
// query). Every int8 x bf16 and bf16 x bf16 product is exact in f32; only
// the summation order differs from the reference.
//
// Generic design (every shape but the two main paths', which take kernels
// of their own below): one warp per (query, block), looping grid-stride over
// all B*MB blocks. A row of cs bytes is cs/8 8-column chunks; it takes LPR lanes,
// the next power of two of its chunks up to 32, so a warp pass covers 32/LPR
// rows (8 rows at cs 32: the whole 256-byte block in one coalesced 8-byte
// load per lane). A lane keeps the query columns of its chunks in registers,
// takes an 8-term dot per chunk, and a segmented butterfly of shuffles over
// the lanes of a row finishes the sum. Any cs that is a multiple of 8
// works: at cs 96 (12 chunks) a row takes 16 lanes, of which 4 load
// nothing and add 0; past 32 chunks a lane takes CPL = 2, 4 or 8 chunks,
// LPR chunks apart, and past 2048 columns (CPL 0) a lane walks its chunks
// 32 apart and reads each chunk's query columns through L1 instead of
// holding them. The TPU's DMA tactics (aligned
// 2*bs windows with a shift-select, lane packing of G tables per 128-lane
// row, run coalescing, static drain) answered per-descriptor DMA cost and
// have no counterpart here: the tier is stored per table.
//
// Bound: bytes read. At the bench shapes (B 1024, MB 512, bs 8, cs 32) a
// call reads 134 MB of tier rows and writes 16.8 MB of scores, with 2 flops
// per byte read. In the generic kernel each iteration waits on two dependent
// loads (table/start, then the rows), so enough warps must be in flight to
// hide the latency; that shape, the block-mode main path's, takes
// block_scores_b8_kernel below instead (chosen by rdf_coarse_block_form).
// wgmma and TMA are not needed for a byte-bound gather of 256-byte blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the dot of one 8-column chunk of a tier row (int8 or bf16) with the query
__device__ __forceinline__ float dot8(const int8_t* p, const float* q) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc = fmaf((float)(int8_t)(v.x >> (8 * k)), q[k], acc);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc = fmaf((float)(int8_t)(v.y >> (8 * k)), q[4 + k], acc);
  }
  return acc;
}

__device__ __forceinline__ float dot8(const __nv_bfloat16* p, const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    acc = fmaf(f.x, q[2 * k], acc);
    acc = fmaf(f.y, q[2 * k + 1], acc);
  }
  return acc;
}

// the 8 bf16 query columns of one chunk as f32 (zeros on a padding lane)
__device__ __forceinline__ void load_query8(const __nv_bfloat16* src, bool loads, float* qv) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (loads) raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    qv[2 * k] = f.x;
    qv[2 * k + 1] = f.y;
  }
}

// a lane's query columns: chunks chunk, chunk + LPR, ... (CPL of them) of
// the query row's cpr chunks, zeros past the row (none held with CPL 0)
template <int LPR, int CPL>
__device__ __forceinline__ void load_query(const __nv_bfloat16* qrow, int chunk, int cpr,
                                           float* qv) {
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = chunk + c * LPR;
    load_query8(qrow + k * 8, k < cpr, qv + 8 * c);
  }
}

// a lane's part of the dot of one tier row with the query (0 on a padding
// lane); with CPL 0 the lane walks chunks LPR apart and reads the query row
template <int LPR, int CPL, typename TierT>
__device__ __forceinline__ float row_dot(const TierT* row, const float* qv,
                                         const __nv_bfloat16* qrow, int chunk, int cpr) {
  float acc = 0.f;
  if constexpr (CPL == 0) {
    for (int k = chunk; k < cpr; k += LPR) {
      float qk[8];
      load_query8(qrow + k * 8, true, qk);
      acc += dot8(row + k * 8, qk);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int k = chunk + c * LPR;
      if (k < cpr) acc += dot8(row + k * 8, qv + 8 * c);
    }
  }
  return acc;
}

template <int LPR, int CPL, typename TierT>  // lanes per tier row, chunks per lane
__global__ void __launch_bounds__(kThreads)
coarse_block_scores_kernel(const TierT* __restrict__ tier,
                           const __nv_bfloat16* __restrict__ q,
                           const int* __restrict__ table,
                           const int* __restrict__ start, float* __restrict__ out,
                           int L, int caprows, int cs, int B, int MB, int bs) {
  constexpr int kRowsPerPass = 32 / LPR;
  const int cpr = cs >> 3;               // 8-column chunks per tier row
  const int lane = threadIdx.x & 31;
  const int chunk = lane % LPR;          // this lane's first chunk of a row
  const int row_in_pass = lane / LPR;
  const long long n_blocks = (long long)B * MB;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n_blocks; i += n_warps) {     // warp-uniform
    const int b = (int)(i / MB);
    const __nv_bfloat16* qrow = q + (size_t)b * cs;
    float qv[8 * (CPL ? CPL : 1)];
    load_query<LPR, CPL>(qrow, chunk, cpr, qv);
    const int t = min(max(table[i], 0), L - 1);
    const int s = min(max(start[i], 0), caprows - bs);
    const TierT* blk = tier + ((size_t)t * caprows + s) * cs;
    float* o = out + i * bs;
    for (int r0 = 0; r0 < bs; r0 += kRowsPerPass) {
      const int r = r0 + row_in_pass;
      float acc = 0.f;
      if (r < bs) acc = row_dot<LPR, CPL>(blk + (size_t)r * cs, qv, qrow, chunk, cpr);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (chunk == 0 && r < bs) o[r] = acc;
    }
  }
}

// K2b: scores of aligned windows with the validity mask fused in. Same warp
// layout and loads as K2 (one warp per (query, window), the query in
// registers, one coalesced 8-byte load per lane and row chunk). A window
// with live[i] == 0 reads neither the query nor the tier and writes -inf;
// a slot whose position blk_start + j lies outside [start, end) issues no
// load and writes -inf. The rows read start at clip(blk_start, 0,
// caprows - win), as K2 clips; callers pass blk_start already clamped.
// Bound: bytes, as K2. At the window-mode query's shapes (B 128, MB 1024,
// win 64, cs 32) a call writes 33.5 MB of scores and reads at most 268 MB
// of tier rows, less by the dead windows and masked slots it skips; the
// fused mask saves the caller two elementwise passes over the scores. The
// tier may also be bf16 (the flat engine's bf16 sketch as a one-table
// tier): a chunk is then one 16-byte load per lane. This generic kernel
// serves every shape but the main path's (int8, 64-slot windows, 32 or 128
// columns), which take window_scores_w64_kernel below.
template <int LPR, int CPL, typename TierT>
__global__ void __launch_bounds__(kThreads)
coarse_window_scores_kernel(const TierT* __restrict__ tier,
                            const __nv_bfloat16* __restrict__ q,
                            const int* __restrict__ table,
                            const int* __restrict__ blk_start,
                            const int* __restrict__ start, const int* __restrict__ end,
                            const uint8_t* __restrict__ live, float* __restrict__ out,
                            int L, int caprows, int cs, int B, int MB, int win) {
  constexpr int kRowsPerPass = 32 / LPR;
  const int cpr = cs >> 3;
  const int lane = threadIdx.x & 31;
  const int chunk = lane % LPR;
  const int row_in_pass = lane / LPR;
  const long long n_windows = (long long)B * MB;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n_windows; i += n_warps) {    // warp-uniform
    float* o = out + i * win;
    if (!live[i]) {
      for (int r = lane; r < win; r += 32) o[r] = -INFINITY;
      continue;
    }
    const int b = (int)(i / MB);
    const __nv_bfloat16* qrow = q + (size_t)b * cs;
    float qv[8 * (CPL ? CPL : 1)];
    load_query<LPR, CPL>(qrow, chunk, cpr, qv);
    const int t = min(max(table[i], 0), L - 1);
    const int p0 = blk_start[i];
    const int lo = start[i];
    const int hi = end[i];
    const int s = min(max(p0, 0), caprows - win);
    const TierT* rows = tier + ((size_t)t * caprows + s) * cs;
    for (int r0 = 0; r0 < win; r0 += kRowsPerPass) {
      const int r = r0 + row_in_pass;
      const bool valid = r < win && p0 + r >= lo && p0 + r < hi;
      float acc = 0.f;
      if (valid) acc = row_dot<LPR, CPL>(rows + (size_t)r * cs, qv, qrow, chunk, cpr);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (chunk == 0 && r < win) o[r] = valid ? acc : -INFINITY;
    }
  }
}

// K2b at the main path's shapes: an int8 tier, 64-slot windows, rows of CS
// = 32 columns (window mode, IVF) or 128 (the flat engine's exact2
// re-score). A window is CS * 64 contiguous bytes; a warp reads it with
// kLoads 16-byte loads per lane, load k covering chunks 32k..32k+31, so each
// is one coalesced 512-byte access and lane l always holds the same 16
// columns (16 * (l % kLpr)) of rows k * kRowsPerLoad + l / kLpr.
//
// What held the generic kernel back here: one 8-byte load per lane in
// flight, a chain of dependent index loads before every window, and 32
// I2F conversions per score at cs 32. This kernel runs a persistent grid
// whose CTAs take steps of 32 consecutive windows grid-stride; a step's
// small inputs are loaded one per lane a step ahead and broadcast by
// shuffle. Each warp takes four consecutive windows of a step, one at a
// time, and issues every 16-byte load of a window's valid slots before its
// first FMA (masked slots and dead windows load nothing). int8 becomes f32
// by byte permute and one FADD (i8_to_f32), and each row's partial dots are
// folded over its lanes so that every lane ends with two rows, written as
// two 128-byte stores. On an NVIDIA H100 80GB HBM3 at a 700 W power limit
// it takes 0.048 ms of device time on chip_smoke.py's kernels_window (the
// 1M fit's windows, B 128 x MB 1024, 28.8% of slots valid) against a bound
// of 0.032 ms; on timing.py's seeded operands 0.056 ms at K2b_window_1m
// where the generic kernel takes 0.087, and 0.055 ms at the flat engine's
// re-score (cs 128, every window live) where it takes 0.092, gathering
// 252 MB from L2 at 4.6 TB/s.
template <int CS>
struct Win64 {
  static constexpr int kWin = 64;
  static constexpr int kLpr = CS / 16;                   // lanes per row
  static constexpr int kRowsPerLoad = 32 / kLpr;         // rows of one warp-wide load
  static constexpr int kLoads = kWin / kRowsPerLoad;     // loads per lane and window
  static constexpr int kStep = 32;                       // windows a CTA takes at a time
  static constexpr int kPerWarp = kStep / (kThreads / 32);  // consecutive windows per warp
  // resident CTAs per SM: at cs 32 a window's loads take 16 registers, and
  // four CTAs of warps loading one window at a time were as fast as three
  // loading two and faster than two loading four
  static constexpr int kMinCtas = CS == 32 ? 4 : 2;
};

// float(x) for the int8 x in byte k of a word, exactly and off the
// conversion pipe: given the word with every byte xor 0x80 (x + 128), one
// byte permute puts x + 128 under the exponent byte 0x4b, the float 2^23 +
// x + 128, and one FADD removes the 2^23 + 128.
__device__ __forceinline__ float i8_to_f32(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4bu, 0x4550u | (unsigned)k)) - 8388736.f;
}

// the dot of 16 int8 tier columns with the lane's 16 query columns, in
// column order
__device__ __forceinline__ float dot16_i8(const uint4 v, const float* q) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(i8_to_f32(w[j], k), q[4 * j + k], acc);
  }
  return acc;
}

// Sum each row's partial dots over its LPR lanes (xor masks 1 .. LPR/2).
// Each level halves the N values a lane holds: of every pair the lane keeps
// one row and sends its partner the other, so lane l ends with two full
// dots, of the rows held at index LPR * j + (l % LPR), j = 0, 1.
template <int N, int MASK, int LPR>
__device__ __forceinline__ void fold_rows(float* p, int lane) {
  if constexpr (MASK < LPR) {
    const bool upper = lane & MASK;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float keep = upper ? p[2 * j + 1] : p[2 * j];
      const float send = upper ? p[2 * j] : p[2 * j + 1];
      p[j] = keep + __shfl_xor_sync(kFull, send, MASK);
    }
    fold_rows<N / 2, MASK * 2, LPR>(p, lane);
  }
}

// a window's small inputs as one lane holds them: the byte offset of its
// first (clipped) row, and its valid slots [lo, hi) relative to blk_start,
// clipped to [0, 64) and empty for a dead window, packed as lo | hi << 8
struct WinMeta {
  long long row0;
  int range;
  int b;
};

template <int CS>
__global__ void __launch_bounds__(kThreads, Win64<CS>::kMinCtas)
window_scores_w64_kernel(const int8_t* __restrict__ tier, const __nv_bfloat16* __restrict__ q,
                         const int* __restrict__ table, const int* __restrict__ blk_start,
                         const int* __restrict__ start, const int* __restrict__ end,
                         const uint8_t* __restrict__ live, float* __restrict__ out, int L,
                         int caprows, int n, int MB) {
  using S = Win64<CS>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = 16 * (lane % S::kLpr);
  // the CTA takes every gridDim.x-th step of kStep consecutive windows: a
  // query's live windows come first among its MB, so a contiguous split of
  // the windows would leave some CTAs only dead ones
  const int n_steps = (n + S::kStep - 1) / S::kStep;

  // the raw small inputs of window step + lane, loaded one step ahead
  int r_t = 0, r_p0 = 0, r_lo = 0, r_hi = 0, r_live = 0;
  auto prefetch = [&](int i) {
    if (i < n) {
      r_t = table[i];
      r_p0 = blk_start[i];
      r_lo = start[i];
      r_hi = end[i];
      r_live = live[i];
    }
  };
  if (blockIdx.x < n_steps) prefetch(blockIdx.x * S::kStep + lane);

  float qf[16];
  int cur_b = -1;
  for (int st = blockIdx.x; st < n_steps; st += gridDim.x) {
    const int step = st * S::kStep;
    WinMeta m = {0, 0, 0};
    if (step + lane < n) {
      const int t = min(max(r_t, 0), L - 1);
      const int s = min(max(r_p0, 0), caprows - S::kWin);
      m.row0 = ((long long)t * caprows + s) * CS;
      const int lo = (int)min(max((long long)r_lo - r_p0, 0LL), (long long)S::kWin);
      const int hi = r_live ? (int)min(max((long long)r_hi - r_p0, 0LL), (long long)S::kWin) : 0;
      m.range = lo | (hi << 8);
      m.b = (step + lane) / MB;
    }
    if (st + (int)gridDim.x < n_steps) prefetch((st + gridDim.x) * S::kStep + lane);

#pragma unroll 1
    for (int w = 0; w < S::kPerWarp; ++w) {     // the warp's windows, one at a time
      const int src = warp * S::kPerWarp + w;   // the lane holding its small inputs
      const int i = step + src;
      const long long row0 = __shfl_sync(kFull, m.row0, src);
      const int range = __shfl_sync(kFull, m.range, src);
      const int b = __shfl_sync(kFull, m.b, src);
      if (i >= n) break;                        // warp-uniform
      const int lo = range & 0xff, hi = range >> 8;
      float* o = out + (size_t)i * S::kWin;
      if (lo >= hi) {                           // no valid slot: 16-byte -inf stores
        if (lane < S::kWin / 4)
          reinterpret_cast<float4*>(o)[lane] =
              make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        continue;
      }
      // every 16-byte load of the window's valid slots before the first FMA
      const uint4* base = reinterpret_cast<const uint4*>(tier + row0);
      uint4 v[S::kLoads];
#pragma unroll
      for (int k = 0; k < S::kLoads; ++k) {
        const int r = k * S::kRowsPerLoad + lane / S::kLpr;
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (r >= lo && r < hi) v[k] = __ldg(base + k * 32 + lane);
      }
      if (b != cur_b) {                         // warp-uniform: another step or query
        const uint4* qp = reinterpret_cast<const uint4*>(q + (size_t)b * CS + col0);
        const uint4 qa = __ldg(qp), qb = __ldg(qp + 1);
        const uint32_t qw[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qf[2 * j] = __uint_as_float(qw[j] << 16);
          qf[2 * j + 1] = __uint_as_float(qw[j] & 0xffff0000u);
        }
        cur_b = b;
      }
      float p[S::kLoads];
#pragma unroll
      for (int k = 0; k < S::kLoads; ++k) p[k] = dot16_i8(v[k], qf);
      fold_rows<S::kLoads, 1, S::kLpr>(p, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {             // two coalesced 128-byte stores
        const int r = 32 * j + (lane % S::kLpr) * S::kRowsPerLoad + lane / S::kLpr;
        o[r] = (r >= lo && r < hi) ? p[j] : -INFINITY;
      }
    }
  }
}

// K2 at the block-mode main shape: an int8 tier of CS 32 columns read in
// blocks of 8 rows (the bench config's B 1024 x MB 512). A block is 256
// contiguous bytes, 16 lanes x 16 bytes, so one warp-wide 16-byte load
// covers two blocks: lanes 0-15 the first, 16-31 the second, lane l holding
// columns 16 (l % 2) .. +15 of row (l % 16) / 2.
//
// What held the generic kernel back here: one (query, block) per warp and
// iteration, each behind a 64-bit divide and the dependent table/start and
// query loads, one 8-byte load per lane in flight, 32 I2F conversions per
// score and a 4-level shuffle reduction. This kernel follows K2b's
// window_scores_w64_kernel: a persistent grid whose CTAs take grid-stride
// steps of 32 consecutive blocks; a step's table ids and starts are loaded
// one per lane a step ahead, clipped, and broadcast by shuffle. A CTA is
// two warps; each takes 16 consecutive blocks of a step and issues all 8 of
// their 16-byte loads per lane before its first FMA; a lane keeps its 16
// query columns in
// registers while its blocks' query stays the same (a whole step at MB 512);
// int8 becomes f32 by byte permute and one FADD (i8_to_f32); one shuffle
// level folds each row's two halves, leaving every lane four scores, which
// the warp writes as four coalesced 128-byte stores of four consecutive
// blocks each. Two warps of 16 blocks were faster than four of 8 (0.037
// against 0.043 ms on chip_smoke.py's operands) and as fast as one of 32.
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit it takes 0.0370 ms of
// device time on those operands (134 MB gathered, mostly from L2, against
// a bound of 0.0121 ms), where the generic kernel takes 0.1046.
struct Blk8 {
  static constexpr int kBs = 8;
  static constexpr int kCs = 32;
  static constexpr int kLpr = kCs / 16;                     // lanes per row
  static constexpr int kThreads = 64;
  static constexpr int kStep = 32;   // blocks a CTA takes at a time: one's small inputs a lane
  static constexpr int kPerWarp = kStep / (kThreads / 32);  // consecutive blocks per warp
  static constexpr int kLoads = kPerWarp / 2;               // warp-wide loads, two blocks each
  static constexpr int kMinCtas = 8;   // launch bound: at most 128 registers a thread
};

// the 16 bf16 query columns at src as f32
__device__ __forceinline__ void load_query16(const __nv_bfloat16* src, float* qf) {
  const uint4* qp = reinterpret_cast<const uint4*>(src);
  const uint4 qa = __ldg(qp), qb = __ldg(qp + 1);
  const uint32_t qw[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qf[2 * j] = __uint_as_float(qw[j] << 16);
    qf[2 * j + 1] = __uint_as_float(qw[j] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(Blk8::kThreads, Blk8::kMinCtas)
block_scores_b8_kernel(const int8_t* __restrict__ tier, const __nv_bfloat16* __restrict__ q,
                       const int* __restrict__ table, const int* __restrict__ start,
                       float* __restrict__ out, int L, int caprows, int n, int MB) {
  using S = Blk8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;                     // which block of a load's pair
  const int col0 = 16 * (lane % S::kLpr);
  const int n_steps = (n + S::kStep - 1) / S::kStep;

  // the raw small inputs of block step + lane, loaded one step ahead
  int r_t = 0, r_s = 0;
  auto prefetch = [&](int i) {
    if (i < n) {
      r_t = table[i];
      r_s = start[i];
    }
  };
  if ((int)blockIdx.x < n_steps) prefetch(blockIdx.x * S::kStep + lane);

  float qf[16];
  int cur_b = -1;                                 // the query whose columns qf holds
  for (int st = blockIdx.x; st < n_steps; st += gridDim.x) {
    const int step = st * S::kStep;
    long long row0 = 0;                           // lane's block: byte offset of its first row
    int bq = 0;                                   // and its query
    if (step + lane < n) {
      const int t = min(max(r_t, 0), L - 1);
      const int s = min(max(r_s, 0), caprows - S::kBs);
      row0 = ((long long)t * caprows + s) * S::kCs;
      bq = (step + lane) / MB;
    }
    if (st + (int)gridDim.x < n_steps) prefetch((st + gridDim.x) * S::kStep + lane);

    const int first = warp * S::kPerWarp;         // the warp's blocks within the step
    uint4 v[S::kLoads];
    int vq[S::kLoads];
#pragma unroll
    for (int k = 0; k < S::kLoads; ++k) {         // every 16-byte load before the first FMA
      const int src = first + 2 * k + half;       // the lane holding this block's inputs
      const long long r0 = __shfl_sync(kFull, row0, src);
      vq[k] = __shfl_sync(kFull, bq, src);
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (step + src < n) v[k] = __ldg(reinterpret_cast<const uint4*>(tier + r0) + (lane & 15));
    }
    float p[S::kLoads];
#pragma unroll
    for (int k = 0; k < S::kLoads; ++k) {
      if (vq[k] != cur_b) {                       // another query: reload this lane's columns
        load_query16(q + (size_t)vq[k] * S::kCs + col0, qf);
        cur_b = vq[k];
      }
      p[k] = dot16_i8(v[k], qf);
    }
    fold_rows<S::kLoads, 1, S::kLpr>(p, lane);
    // lane l holds row (l % 16) / 2 of blocks 4j + 2 (l % 2) + l / 16, j = 0, 1, ...
#pragma unroll
    for (int j = 0; j < S::kLoads / S::kLpr; ++j) {
      const int blk = step + first + 4 * j + 2 * (lane % S::kLpr) + half;
      if (blk < n) out[(size_t)blk * S::kBs + ((lane & 15) >> 1)] = p[j];
    }
  }
}

int grid_for(long long n_items) {
  const long long warps_per_cta = kThreads / 32;
  const long long ctas = (n_items + warps_per_cta - 1) / warps_per_cta;
  return (int)(ctas < 132 * 32 ? ctas : 132 * 32);
}

template <int LPR, int CPL>
int launch(const void* tier, const void* q, const void* table, const void* start,
           void* out, int L, int caprows, int cs, int B, int MB, int bs, int tier_bf16,
           cudaStream_t stream) {
  const int grid = grid_for((long long)B * MB);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ti = static_cast<const int*>(table);
  const auto* si = static_cast<const int*>(start);
  auto* o = static_cast<float*>(out);
  if (tier_bf16) {
    coarse_block_scores_kernel<LPR, CPL, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(tier), qb, ti, si, o, L, caprows, cs, B, MB, bs);
  } else {
    coarse_block_scores_kernel<LPR, CPL, int8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(tier), qb, ti, si, o, L, caprows, cs, B, MB, bs);
  }
  return (int)cudaGetLastError();
}

template <int LPR, int CPL>
int launch_window(const void* tier, const void* q, const void* table, const void* blk_start,
                  const void* start, const void* end, const void* live, void* out, int L,
                  int caprows, int cs, int B, int MB, int win, int tier_bf16,
                  cudaStream_t stream) {
  const int grid = grid_for((long long)B * MB);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ti = static_cast<const int*>(table);
  const auto* bi = static_cast<const int*>(blk_start);
  const auto* si = static_cast<const int*>(start);
  const auto* ei = static_cast<const int*>(end);
  const auto* li = static_cast<const uint8_t*>(live);
  auto* o = static_cast<float*>(out);
  if (tier_bf16) {
    coarse_window_scores_kernel<LPR, CPL, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(tier), qb, ti, bi, si, ei, li, o, L, caprows, cs, B,
        MB, win);
  } else {
    coarse_window_scores_kernel<LPR, CPL, int8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(tier), qb, ti, bi, si, ei, li, o, L, caprows, cs, B, MB,
        win);
  }
  return (int)cudaGetLastError();
}

constexpr int kMaxDevices = 64;   // devices whose grid size is cached

// SMs x resident CTAs per SM of `kernel` on the current device: queried on a
// device's first launch and kept in `cache` (threads that race there store
// the same value); 0 and an error on failure
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, std::atomic<int>* cache, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *ctas = dev < kMaxDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (*ctas == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    *ctas = sms * per_sm;
    if (dev < kMaxDevices) cache[dev].store(*ctas, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// the specialised K2b on a persistent grid: as many CTAs as fit on the card
template <int CS>
int launch_window_w64(const void* tier, const void* q, const void* table, const void* blk_start,
                      const void* start, const void* end, const void* live, void* out, int L,
                      int caprows, int n, int MB, cudaStream_t stream) {
  static std::atomic<int> ctas_of[kMaxDevices];
  int ctas = 0;
  const cudaError_t err = resident_ctas(window_scores_w64_kernel<CS>, kThreads, ctas_of, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long steps = ((long long)n + Win64<CS>::kStep - 1) / Win64<CS>::kStep;
  const int grid = (int)(steps < ctas ? steps : ctas);
  window_scores_w64_kernel<CS><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tier), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(blk_start),
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const uint8_t*>(live), static_cast<float*>(out), L, caprows, n, MB);
  return (int)cudaGetLastError();
}

// the specialised K2 on a persistent grid, as K2b's
int launch_block_b8(const void* tier, const void* q, const void* table, const void* start,
                    void* out, int L, int caprows, int n, int MB, cudaStream_t stream) {
  static std::atomic<int> ctas_of[kMaxDevices];
  int ctas = 0;
  const cudaError_t err = resident_ctas(block_scores_b8_kernel, Blk8::kThreads, ctas_of, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long steps = ((long long)n + Blk8::kStep - 1) / Blk8::kStep;
  const int grid = (int)(steps < ctas ? steps : ctas);
  block_scores_b8_kernel<<<grid, Blk8::kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tier), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(start), static_cast<float*>(out),
      L, caprows, n, MB);
  return (int)cudaGetLastError();
}

// LAUNCH(LPR, CPL) for a row of cs columns: the next power of two of lanes
// up to 32, then 2, 4 or 8 chunks per lane, then (CPL 0) any width
#define RDF_BY_WIDTH(cs, LAUNCH)                   \
  if ((cs) <= 8) return LAUNCH(1, 1);              \
  if ((cs) <= 16) return LAUNCH(2, 1);             \
  if ((cs) <= 32) return LAUNCH(4, 1);             \
  if ((cs) <= 64) return LAUNCH(8, 1);             \
  if ((cs) <= 128) return LAUNCH(16, 1);           \
  if ((cs) <= 256) return LAUNCH(32, 1);           \
  if ((cs) <= 512) return LAUNCH(32, 2);           \
  if ((cs) <= 1024) return LAUNCH(32, 4);          \
  if ((cs) <= 2048) return LAUNCH(32, 8);          \
  return LAUNCH(32, 0);

}  // namespace

// Which kernel K2 takes for a shape: 1, the specialised kernel, for the
// block-mode main shape (an int8 tier of 32 columns, 8-slot blocks, a block
// count that fits an int); 0, the generic kernel, for every other shape and
// for every bf16 tier.
extern "C" int rdf_coarse_block_form(int cs, int bs, int B, int MB, int tier_bf16) {
  return !tier_bf16 && cs == Blk8::kCs && bs == Blk8::kBs &&
         (long long)B * MB < (1LL << 31) - Blk8::kStep;
}

// tier i8[L, caprows, cs] (bf16 with tier_bf16 = 1), q bf16[B, cs], table
// and start i32[B, MB] (all contiguous, 16-byte aligned); out f32[B, MB,
// bs]. cs is a multiple of 8 and caprows >= bs. Launches on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unsupported cs). A bf16 tier takes the generic kernel, a chunk of 8
// columns being one 16-byte load per lane; every bf16 x bf16 product is
// exact in f32, as the int8 ones are.
extern "C" int rdf_coarse_block_scores(const void* tier, const void* q,
                                       const void* table, const void* start,
                                       void* out, int L, int caprows, int cs,
                                       int B, int MB, int bs, int tier_bf16, void* stream) {
  if ((long long)B * MB == 0) return 0;
  if (cs <= 0 || cs % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (rdf_coarse_block_form(cs, bs, B, MB, tier_bf16))
    return launch_block_b8(tier, q, table, start, out, L, caprows, B * MB, MB, st);
#define RDF_BLOCK(LPR, CPL) \
  launch<LPR, CPL>(tier, q, table, start, out, L, caprows, cs, B, MB, bs, tier_bf16, st)
  RDF_BY_WIDTH(cs, RDF_BLOCK)
#undef RDF_BLOCK
}

// K2b. tier i8[L, caprows, cs] (bf16 with tier_bf16 = 1), q bf16[B, cs],
// table, blk_start, start and end i32[B, MB], live u8[B, MB] (all
// contiguous, tier and q 16-byte aligned); out f32[B, MB, win] with
// out[b, m, j] = the K2 score of row clip(blk_start, 0, caprows-win) + j
// when live[b, m] and start[b, m] <= blk_start[b, m] + j < end[b, m], else
// -inf. cs as for K2, caprows >= win.
extern "C" int rdf_coarse_window_scores(const void* tier, const void* q, const void* table,
                                        const void* blk_start, const void* start,
                                        const void* end, const void* live, void* out,
                                        int L, int caprows, int cs, int B, int MB, int win,
                                        int tier_bf16, void* stream) {
  if ((long long)B * MB == 0) return 0;
  if (cs <= 0 || cs % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the main path's shapes take the specialised kernel (a window count that
  // fits an int: at 256 bytes of scores a window, any that fits on a card)
  if (!tier_bf16 && win == 64 && (long long)B * MB < (1LL << 31) - 64) {
    if (cs == 32)
      return launch_window_w64<32>(tier, q, table, blk_start, start, end, live, out, L, caprows,
                                   B * MB, MB, st);
    if (cs == 128)
      return launch_window_w64<128>(tier, q, table, blk_start, start, end, live, out, L,
                                    caprows, B * MB, MB, st);
  }
#define RDF_WIN(LPR, CPL)                                                              \
  launch_window<LPR, CPL>(tier, q, table, blk_start, start, end, live, out, L, caprows, cs, \
                          B, MB, win, tier_bf16, st)
  RDF_BY_WIDTH(cs, RDF_WIN)
#undef RDF_WIN
}
