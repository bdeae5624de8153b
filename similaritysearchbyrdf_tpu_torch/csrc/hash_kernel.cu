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
// Design: one warp per (row, table). Lane j accumulates chain function j's
// dot over D in full f32 FMA (no tensor cores, no TF32: a bit decided by the
// sign of a dot must not move). The row is read coalesced 32 floats at a
// time and broadcast with shuffles; the table's projection sits transposed
// in shared memory ([D][32], lane j reads column j: no bank conflicts).
// `__ballot_sync(dot > 0)` gives the chain's sign word; for each
// permutation a second ballot of sign[perm[t,p,lane]] and `__brev` give the
// MSB-first packed hash, with integer ops only. The TPU kernel's hi/lo f32
// pack-weight matmuls were a Mosaic workaround and are not carried over.
//
// Bound: at the bench shapes (B 1024-8192, D 100, T 10, P 3, C 32) the
// kernel does 2*B*T*C*D flops against B*D*4 bytes read and B*T*P*8 bytes of
// hashes written (plus B*T*P*128 bytes of margins), so it is bound by
// instruction issue, not memory: every FMA comes with one shuffle and one
// shared-memory load. Each block holds one table's projection (12.8 KB at
// D 100) and runs 64 rows through it. Reusing each projection load for
// several rows per warp is the obvious next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
hash_dense_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                  const int* __restrict__ perm, long long* __restrict__ hashes,
                  float* __restrict__ margins, int B, int D, int T, int C, int P) {
  extern __shared__ float smem[];
  float* proj_s = smem;                                   // [D][32]
  int* perm_s = reinterpret_cast<int*>(smem + D * 32);    // [P][32]
  const int t = blockIdx.y;
  for (int i = threadIdx.x; i < D * 32; i += blockDim.x) {
    const int d = i >> 5, j = i & 31;
    proj_s[i] = j < C ? proj[((size_t)t * C + j) * D + d] : 0.f;
  }
  for (int i = threadIdx.x; i < P * 32; i += blockDim.x) {
    const int p = i >> 5, j = i & 31;
    perm_s[i] = j < C ? perm[((size_t)t * P + p) * C + j] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int L = T * P;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = blockIdx.x * kRowsPerBlock + r;
    if (row >= B) break;                                  // warp-uniform
    const float* xr = x + (size_t)row * D;
    float acc = 0.f;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const float xv = d0 + lane < D ? xr[d0 + lane] : 0.f;
      const int n = min(32, D - d0);
      for (int k = 0; k < n; ++k) {
        acc = fmaf(__shfl_sync(kFull, xv, k), proj_s[(d0 + k) * 32 + lane], acc);
      }
    }
    const unsigned signs = __ballot_sync(kFull, lane < C && acc > 0.f);
    const float absdot = fabsf(acc);
    for (int p = 0; p < P; ++p) {
      const int pj = perm_s[p * 32 + lane];
      const unsigned word = __ballot_sync(kFull, lane < C && ((signs >> pj) & 1u));
      const size_t col = (size_t)row * L + (size_t)t * P + p;
      if (lane == 0) hashes[col] = (long long)__brev(word);
      if (margins != nullptr) {
        const float m = __shfl_sync(kFull, absdot, pj);
        margins[col * 32 + (31 - lane)] = lane < C ? m : INFINITY;
      }
    }
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
  const size_t smem = (size_t)(D + P) * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, T);
  hash_dense_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(proj),
      static_cast<const int*>(perm), static_cast<long long*>(hashes),
      static_cast<float*>(margins), B, D, T, C, P);
  return (int)cudaGetLastError();
}
