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
// blocks. A row of cs bytes is cs/8 lanes' worth of 8-byte loads, so a warp
// pass covers 32/(cs/8) rows (8 rows at cs 32: the whole 256-byte block in
// one coalesced load per lane). Each lane keeps its 8 query columns in
// registers, takes an 8-term dot, and a segmented butterfly of shuffles over
// the cs/8 lanes of a row finishes the sum. The TPU's DMA tactics (aligned
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

__device__ __forceinline__ float dot8(uint2 v, const float* q) {
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

template <int CPR>  // 8-byte chunks per tier row: cs / 8
__global__ void __launch_bounds__(kThreads)
coarse_block_scores_kernel(const int8_t* __restrict__ tier,
                           const __nv_bfloat16* __restrict__ q,
                           const int* __restrict__ table,
                           const int* __restrict__ start, float* __restrict__ out,
                           int L, int caprows, int B, int MB, int bs) {
  constexpr int CS = CPR * 8;
  constexpr int kRowsPerPass = 32 / CPR;
  const int lane = threadIdx.x & 31;
  const int chunk = lane % CPR;          // this lane's 8 columns of a row
  const int row_in_pass = lane / CPR;
  const long long n_blocks = (long long)B * MB;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n_blocks; i += n_warps) {     // warp-uniform
    const int b = (int)(i / MB);
    float qv[8];
    const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)b * CS + chunk * 8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      qv[2 * k] = f.x;
      qv[2 * k + 1] = f.y;
    }
    const int t = min(max(table[i], 0), L - 1);
    const int s = min(max(start[i], 0), caprows - bs);
    const int8_t* blk = tier + ((size_t)t * caprows + s) * CS + chunk * 8;
    float* o = out + i * bs;
    for (int r0 = 0; r0 < bs; r0 += kRowsPerPass) {
      const int r = r0 + row_in_pass;
      float acc = 0.f;
      if (r < bs) acc = dot8(*reinterpret_cast<const uint2*>(blk + (size_t)r * CS), qv);
#pragma unroll
      for (int off = CPR / 2; off > 0; off >>= 1) {
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
// fused mask saves the caller two elementwise passes over the scores.
template <int CPR>
__global__ void __launch_bounds__(kThreads)
coarse_window_scores_kernel(const int8_t* __restrict__ tier,
                            const __nv_bfloat16* __restrict__ q,
                            const int* __restrict__ table,
                            const int* __restrict__ blk_start,
                            const int* __restrict__ start, const int* __restrict__ end,
                            const uint8_t* __restrict__ live, float* __restrict__ out,
                            int L, int caprows, int B, int MB, int win) {
  constexpr int CS = CPR * 8;
  constexpr int kRowsPerPass = 32 / CPR;
  const int lane = threadIdx.x & 31;
  const int chunk = lane % CPR;
  const int row_in_pass = lane / CPR;
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
    float qv[8];
    const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)b * CS + chunk * 8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      qv[2 * k] = f.x;
      qv[2 * k + 1] = f.y;
    }
    const int t = min(max(table[i], 0), L - 1);
    const int p0 = blk_start[i];
    const int lo = start[i];
    const int hi = end[i];
    const int s = min(max(p0, 0), caprows - win);
    const int8_t* rows = tier + ((size_t)t * caprows + s) * CS + chunk * 8;
    for (int r0 = 0; r0 < win; r0 += kRowsPerPass) {
      const int r = r0 + row_in_pass;
      const bool valid = r < win && p0 + r >= lo && p0 + r < hi;
      float acc = 0.f;
      if (valid) acc = dot8(*reinterpret_cast<const uint2*>(rows + (size_t)r * CS), qv);
#pragma unroll
      for (int off = CPR / 2; off > 0; off >>= 1) {
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

template <int CPR>
int launch(const void* tier, const void* q, const void* table, const void* start,
           void* out, int L, int caprows, int B, int MB, int bs, cudaStream_t stream) {
  coarse_block_scores_kernel<CPR><<<grid_for((long long)B * MB), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tier), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(start),
      static_cast<float*>(out), L, caprows, B, MB, bs);
  return (int)cudaGetLastError();
}

template <int CPR>
int launch_window(const void* tier, const void* q, const void* table, const void* blk_start,
                  const void* start, const void* end, const void* live, void* out, int L,
                  int caprows, int B, int MB, int win, cudaStream_t stream) {
  coarse_window_scores_kernel<CPR><<<grid_for((long long)B * MB), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(tier), static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(blk_start),
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const uint8_t*>(live), static_cast<float*>(out), L, caprows, B, MB, win);
  return (int)cudaGetLastError();
}

}  // namespace

// tier i8[L, caprows, cs], q bf16[B, cs], table and start i32[B, MB] (all
// contiguous, 16-byte aligned); out f32[B, MB, bs]. cs is one of 8, 16, 32,
// 64, 128, 256 and caprows >= bs. Launches on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported cs).
extern "C" int rdf_coarse_block_scores(const void* tier, const void* q,
                                       const void* table, const void* start,
                                       void* out, int L, int caprows, int cs,
                                       int B, int MB, int bs, void* stream) {
  if ((long long)B * MB == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cs) {
    case 8: return launch<1>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    case 16: return launch<2>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    case 32: return launch<4>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    case 64: return launch<8>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    case 128: return launch<16>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    case 256: return launch<32>(tier, q, table, start, out, L, caprows, B, MB, bs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2b. tier i8[L, caprows, cs], q bf16[B, cs], table, blk_start, start and
// end i32[B, MB], live u8[B, MB] (all contiguous, tier and q 16-byte
// aligned); out f32[B, MB, win] with out[b, m, j] = the K2 score of row
// clip(blk_start, 0, caprows-win) + j when live[b, m] and start[b, m] <=
// blk_start[b, m] + j < end[b, m], else -inf. cs as for K2, caprows >= win.
extern "C" int rdf_coarse_window_scores(const void* tier, const void* q, const void* table,
                                        const void* blk_start, const void* start,
                                        const void* end, const void* live, void* out,
                                        int L, int caprows, int cs, int B, int MB, int win,
                                        void* stream) {
  if ((long long)B * MB == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define RDF_WIN(CPR) \
  launch_window<CPR>(tier, q, table, blk_start, start, end, live, out, L, caprows, B, MB, win, st)
  switch (cs) {
    case 8: return RDF_WIN(1);
    case 16: return RDF_WIN(2);
    case 32: return RDF_WIN(4);
    case 64: return RDF_WIN(8);
    case 128: return RDF_WIN(16);
    case 256: return RDF_WIN(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RDF_WIN
}
