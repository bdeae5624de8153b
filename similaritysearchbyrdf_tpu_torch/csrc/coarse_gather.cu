// K2 and K2b: coarse gather-score kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of similaritysearchbyrdf_tpu/ops/pallas/
// coarse_gather.py: K2 `pallas_coarse_scores` (`_kernel`, blocks at
// arbitrary starts, block mode) and K2b `pallas_coarse_scores_aligned`
// (`_kernel_aligned*`, aligned windows of window mode, dead windows
// skipped; see `coarse_window_scores_kernel` below for what K2b adds).
// For every (query b, block m) K2 reads `bs` contiguous rows of
// table t = clip(table[b, m], 0, L-1) starting at s = clip(start[b, m], 0,
// caprows-bs) of the per-table int8 tier [L, caprows, cs], and writes
//   out[b, m, j] = sum_c float(tier[t, s+j, c]) * float(q[b, c])
// with f32 accumulation: the numerics of the XLA scoring path
// (index/forest.py `_coarse_block_scores`, int8 rows times a bf16 query).
// Every int8 x bf16 product is exact in f32; only the summation order
// differs from the reference.
//
// Design: one warp per (query, block), looping grid-stride over all B*MB
// blocks. A row of cs bytes is cs/8 8-column chunks; it takes LPR lanes,
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
// per byte read; each iteration waits on two dependent loads (table/start,
// then the rows), so enough warps must be in flight to hide the latency.
// wgmma and TMA are not needed for a byte-bound gather of 256-byte blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int LPR, int CPL>  // lanes per tier row, chunks per lane
__global__ void __launch_bounds__(kThreads)
coarse_block_scores_kernel(const int8_t* __restrict__ tier,
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
    const int8_t* blk = tier + ((size_t)t * caprows + s) * cs;
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
// tier): a chunk is then one 16-byte load per lane.
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

int grid_for(long long n_items) {
  const long long warps_per_cta = kThreads / 32;
  const long long ctas = (n_items + warps_per_cta - 1) / warps_per_cta;
  return (int)(ctas < 132 * 32 ? ctas : 132 * 32);
}

template <int LPR, int CPL>
int launch(const void* tier, const void* q, const void* table, const void* start,
           void* out, int L, int caprows, int cs, int B, int MB, int bs, cudaStream_t stream) {
  coarse_block_scores_kernel<LPR, CPL><<<grid_for((long long)B * MB), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tier), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(start),
      static_cast<float*>(out), L, caprows, cs, B, MB, bs);
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

// tier i8[L, caprows, cs], q bf16[B, cs], table and start i32[B, MB] (all
// contiguous, 16-byte aligned); out f32[B, MB, bs]. cs is a multiple of 8
// and caprows >= bs. Launches on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported cs).
extern "C" int rdf_coarse_block_scores(const void* tier, const void* q,
                                       const void* table, const void* start,
                                       void* out, int L, int caprows, int cs,
                                       int B, int MB, int bs, void* stream) {
  if ((long long)B * MB == 0) return 0;
  if (cs <= 0 || cs % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define RDF_BLOCK(LPR, CPL) \
  launch<LPR, CPL>(tier, q, table, start, out, L, caprows, cs, B, MB, bs, st)
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
#define RDF_WIN(LPR, CPL)                                                                 \
  launch_window<LPR, CPL>(tier, q, table, blk_start, start, end, live, out, L, caprows, cs, \
                          B, MB, win, tier_bf16, st)
  RDF_BY_WIDTH(cs, RDF_WIN)
#undef RDF_WIN
}
