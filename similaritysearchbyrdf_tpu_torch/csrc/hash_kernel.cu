// K1: fused angle hash for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hash_kernel` in
// similaritysearchbyrdf_tpu/ops/pallas/hash_kernel.py (entries
// `pallas_hash_dense`, `make_pallas_hash_fn`, `_call`). For each row b and
// table t it computes the chain's C projections x[b] . proj[t, j], their
// signs, and for each permutation p the packed hash whose bit 31-j is the
// sign of function perm[t, p, j]. With `margins` non-null it also writes the
// margins of `hash_dense_with_margins`: margins[b, t*P+p, 31-j] =
// |x[b] . proj[t, perm[t, p, j]]|, and +inf on the low 32-C bits.
//
// Design: register-blocked f32 FMA. A CTA of kWarps warps takes kTileRows
// rows of x and one table; warp w owns kRows of those rows, and its lane j
// keeps kRows accumulators, one per row, for chain function j. Every dot
// stays in full f32 FMA (no tensor cores, no TF32: a bit decided by the
// sign of a dot must not move), summed over d in ascending order. The CTA
// stages its x tile, its table's projection and perm in shared memory by
// asynchronous copies (`cp.async`, 16 bytes each when D is a multiple of 4
// and the operands are 16-byte aligned, else 4 bytes), in chunks of up to
// 128 columns and within a chunk in parts of 32 columns: every part's
// copies are in flight at once, no thread waits on one load before issuing
// the next, and the warps compute on each part as soon as it has landed
// (`cp.async.wait_group`), so the copies overlap the FMAs. The projection is
// transposed on the way in to [D/4][32][4]: one 16-byte shared load gives
// lane j four columns of its function, and feeds kRows independent FMA
// chains; the kRows rows' four columns come from broadcast 16-byte shared
// loads (all lanes read one address). D is walked four columns at a time:
// the last group's missing columns are zeros in both staged tiles, so there
// is no tail loop and the sums are those of a plain d-ordered loop, as in
// the kernel this one replaced.
// The epilogue takes every row's sign word (`__ballot_sync(dot > 0)`) first;
// then for each permutation one ballot a row of sign[perm[t,p,lane]], of
// which lane r keeps row r's word, bit-reversed (`__brev`) to MSB-first, so
// that one store writes the warp's kRows hashes; a shuffle of |dot| gives
// the margins, one 128-byte store per (row, permutation). The TPU kernel's
// hi/lo f32 pack-weight matmuls were a Mosaic workaround and are not
// carried over.
//
// Bound: at the bench shapes (B 1024-8192, D 100, T 10, P 3, C 32) the
// kernel does 2*B*T*C*D flops, 0.07 us of the H100's f32 peak per 1,024
// rows, against B*D*4 bytes read and B*T*P*8 bytes of hashes written, plus
// B*T*P*128 bytes of margins: bytes bound it (1.4 us at B 1024 with
// margins). What it takes beyond that is latency and the staging's traffic
// (x is staged once per table, the projection once per 64 rows), not FMA
// issue or shared-memory bandwidth: with the compute loop removed it took
// three quarters of its time, and a register tile of 2-4 rows x 8 functions
// per lane, with a third of the shared loads, was no faster. On an NVIDIA
// H100 80GB HBM3 at a 700 W power limit (timing.py, device time) it takes
// 0.0147 ms at B 1024 with margins and 0.0415 ms at the fit's B 8192,
// where the kernel it replaced (one warp per row and table, a shuffle and
// a shared load per FMA) took 0.0292 and 0.0894.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                    // rows per warp: FMA chains per projection load
constexpr int kWarps = 8;                   // warps per CTA, all on one table
constexpr int kTileRows = kRows * kWarps;   // rows per CTA
constexpr int kChunkGroups = 32;            // 4-column groups staged at a time (128 columns)
constexpr int kPartGroups = 8;              // groups of one copy part, waited for in turn
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0-3) of this thread's copy parts are still in flight
__device__ __forceinline__ void cp_async_wait_parts(int n) {
  static_assert(kChunkGroups / kPartGroups <= 4, "a chunk has at most 4 parts");
  if (n >= 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one 4-column group of a staged tile: zeros where `in` is false or past D
template <bool kVec>
__device__ __forceinline__ void stage_group(float4* dst, const float* src, bool in, int d, int D) {
  if constexpr (kVec) {
    if (in) cp_async16(dst, src);
    else *dst = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dk = reinterpret_cast<float*>(dst) + k;
      if (in && d + k < D) cp_async4(dk, src + k);
      else *dk = 0.f;
    }
  }
}

// Stage part `part` of a chunk of gc 4-column groups starting at group g0:
// groups [kPartGroups * part, +kPartGroups) of the table's projection as
// proj_s[g][j] (a float4 of columns 4(g0+g)..+3 of function j, held at
// index j ^ (g & 7) of its group so that the copies of one function's
// consecutive groups land in different banks; zeros past D and for j >= C)
// and of the tile's rows as x_s[r][g] (zeros past D and B), as one group of
// copies. kVec: D % 4 == 0 and x, proj 16-byte aligned, so every group is
// one 16-byte copy.
template <bool kVec>
__device__ __forceinline__ void stage_part(float4* proj_s, float4* x_s, const float* proj_t,
                                           const float* x_tile, int rows, int D, int C, int g0,
                                           int gc, int part) {
  // kPartGroups consecutive threads copy consecutive groups of one row
  for (int i = threadIdx.x; i < (32 + kTileRows) * kPartGroups; i += blockDim.x) {
    const int row = i / kPartGroups, g = part * kPartGroups + i % kPartGroups;
    if (g >= gc) continue;
    const int d = 4 * (g0 + g);
    if (row < 32) {
      stage_group<kVec>(proj_s + g * 32 + (row ^ (g & 7)), proj_t + (size_t)row * D + d,
                        row < C, d, D);
    } else {
      const int r = row - 32;
      stage_group<kVec>(x_s + r * gc + g, x_tile + (size_t)r * D + d, r < rows, d, D);
    }
  }
  cp_async_commit();
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
hash_dense_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                  const int* __restrict__ perm, long long* __restrict__ hashes,
                  float* __restrict__ margins, int B, int D, int T, int C, int P) {
  extern __shared__ float4 smem4[];
  const int G = (D + 3) / 4;                          // 4-column groups of a row
  const int gcap = min(G, kChunkGroups);
  float4* proj_s = smem4;                             // [gc][32]
  float4* x_s = smem4 + 32 * gcap;                    // [kTileRows][gc]
  int* perm_s = reinterpret_cast<int*>(x_s + kTileRows * gcap);   // [P][32]
  const int t = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, B - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* x_tile = x + (size_t)r0 * D;

  // perm rides with the first part's copies: no thread waits on it first
  for (int i = threadIdx.x; i < P * 32; i += blockDim.x) {
    const int p = i >> 5, j = i & 31;
    if (j < C) cp_async4(perm_s + i, perm + ((size_t)t * P + p) * C + j);
    else perm_s[i] = 0;
  }

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const bool active = warp * kRows < rows;            // warp-uniform
  for (int g0 = 0; g0 < G; g0 += kChunkGroups) {
    const int gc = min(kChunkGroups, G - g0);
    const int parts = (gc + kPartGroups - 1) / kPartGroups;
    if (g0 > 0) __syncthreads();                      // the previous chunk is consumed
    // every part's copies in flight at once (perm joins the first part);
    // each part is computed on as soon as it has landed
    for (int part = 0; part < parts; ++part)
      stage_part<kVec>(proj_s, x_s, proj + (size_t)t * C * D, x_tile, rows, D, C, g0, gc, part);
    for (int part = 0; part < parts; ++part) {
      cp_async_wait_parts(parts - 1 - part);
      __syncthreads();
      if (!active) continue;
      const float4* xw = x_s + warp * kRows * gc;
#pragma unroll
      for (int k = 0; k < kPartGroups; ++k) {
        const int g = part * kPartGroups + k;
        if (g >= gc) break;                           // warp-uniform
        const float4 p = proj_s[g * 32 + (lane ^ (g & 7))];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 v = xw[r * gc + g];            // broadcast: one address for the warp
          acc[r] = fmaf(v.x, p.x, acc[r]);
          acc[r] = fmaf(v.y, p.y, acc[r]);
          acc[r] = fmaf(v.z, p.z, acc[r]);
          acc[r] = fmaf(v.w, p.w, acc[r]);
        }
      }
    }
  }
  if (!active) return;

  // every row's sign word, then per permutation one ballot a row; lane r
  // keeps row r's packed word, so one store writes the warp's kRows hashes
  const int L = T * P;
  const int nr = min(kRows, rows - warp * kRows);     // the warp's rows inside B
  const int row0 = r0 + warp * kRows;
  unsigned signs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) signs[r] = __ballot_sync(kFull, lane < C && acc[r] > 0.f);
  for (int p = 0; p < P; ++p) {
    const int pj = perm_s[p * 32 + lane];
    const size_t col = (size_t)t * P + p;
    unsigned mine = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned word = __ballot_sync(kFull, lane < C && ((signs[r] >> pj) & 1u));
      if (lane == r) mine = __brev(word);
      if (margins != nullptr && r < nr) {
        const float m = __shfl_sync(kFull, fabsf(acc[r]), pj);
        margins[((size_t)(row0 + r) * L + col) * 32 + (31 - lane)] = lane < C ? m : INFINITY;
      }
    }
    if (lane < nr) hashes[(size_t)(row0 + lane) * L + col] = (long long)mine;
  }
}

}  // namespace

// x f32[B, D], proj f32[T, C, D], perm i32[T, P, C] (all contiguous);
// hashes i64[B, T*P] (unsigned 32-bit values); margins f32[B, T*P, 32] or
// null. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int rdf_hash_dense(const void* x, const void* proj, const void* perm,
                              void* hashes, void* margins, int B, int D, int T,
                              int C, int P, void* stream) {
  if (B == 0) return 0;
  const int gcap = min((D + 3) / 4, kChunkGroups);
  const size_t smem = (size_t)(32 + kTileRows) * gcap * sizeof(float4) +
                      (size_t)P * 32 * sizeof(int);
  const bool vec = D % 4 == 0 && ((uintptr_t)x | (uintptr_t)proj) % 16 == 0;
  const auto kernel = vec ? hash_dense_kernel<true> : hash_dense_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kTileRows - 1) / kTileRows, T);
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(proj),
      static_cast<const int*>(perm), static_cast<long long*>(hashes),
      static_cast<float*>(margins), B, D, T, C, P);
  return (int)cudaGetLastError();
}
