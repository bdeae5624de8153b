// K3: folded rowmax kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of similaritysearchbyrdf_tpu/ops/pallas/
// coarse_fold.py (`pallas_coarse_rowmax` -> `_kernel`). The folded coarse
// tier i8[L, capf, lanes] holds fold = lanes / cs consecutive slots of one
// table per physical row. For every (query b, window m) that is live
// (row_start >= 0) it reads wpr physical rows of table t = clip(table, 0,
// L-1) from row rs = min(row_start, capf - wpr), scores every slot s of row
// r with the exact int32 dot of its cs int8 values against the query's cs
// int8 values, packs
//   pk = (score << mshift) | member,  member = ((r % rpg) * fold) | s
// (the shift in unsigned arithmetic: the caller guarantees it does not
// overflow) and writes the row's maximum pk to out[b, m*wpr + r] and, with
// out2, the row's second-largest pk (kDead when the row has one slot). A
// dead window writes kDead to every row of both outputs and reads nothing.
// Every value is integer-exact, so the kernel equals its plain version
// (`coarse_rowmax_plain`, a transcription of `rowmax_fallback`) bit for bit.
//
// Design: one warp per (query, window), looping grid-stride over all B*MB
// windows and, inside, over the window's rows. A 128-byte physical row is 16
// lanes' worth of 8-byte loads, so a warp pass reads two rows in one
// coalesced 256-byte load. A lane holds 8 bytes of one slot and the
// matching 8 query bytes in two registers and takes two __dp4a; a butterfly
// of shuffles over the cs/8 lanes of a slot finishes the dot, and a second
// butterfly over the slots of a row keeps the top two packed values. The
// TPU kernel's block-diagonal [fold, 128] query matrix (the Mosaic way to a
// per-slot dot without a lane-splitting reshape) and its DMA run coalescing
// have no counterpart here.
//
// Bound: bytes read. At the folded query's shapes (B 64, MB 128, wpr 512,
// 128-byte rows) a call reads up to 537 MB of tier rows, two integer
// operations per byte, and writes 16.8 MB (33.6 MB with the second output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kDead = -2147483647;   // -(2^31 - 1), the caller's I32_DEAD

template <int CPS, int CPR>  // 8-byte chunks per slot (cs / 8) and per row (lanes / 8)
__global__ void __launch_bounds__(kThreads)
coarse_rowmax_kernel(const int8_t* __restrict__ folded, const int8_t* __restrict__ q,
                     const int* __restrict__ table, const int* __restrict__ row_start,
                     int32_t* __restrict__ out, int32_t* __restrict__ out2, int L,
                     int capf, int B, int MB, int wpr, int rpg, int mshift) {
  constexpr int CS = CPS * 8;
  constexpr int LANES = CPR * 8;
  constexpr int FOLD = CPR / CPS;
  constexpr int kRowsPerPass = 32 / CPR;
  const int lane = threadIdx.x & 31;
  const int chunk = lane % CPR;          // this lane's 8 bytes of a row
  const int row_in_pass = lane / CPR;
  const int slot = chunk / CPS;
  const int part = chunk % CPS;          // this lane's 8 bytes of the slot
  const long long n_windows = (long long)B * MB;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n_windows; i += n_warps) {    // warp-uniform
    int32_t* o = out + i * wpr;
    int32_t* o2 = out2 ? out2 + i * wpr : nullptr;
    const int rs = row_start[i];
    if (rs < 0) {
      for (int r = lane; r < wpr; r += 32) {
        o[r] = kDead;
        if (o2) o2[r] = kDead;
      }
      continue;
    }
    const int b = (int)(i / MB);
    const uint2 qw = *reinterpret_cast<const uint2*>(q + (size_t)b * CS + part * 8);
    const int t = min(max(table[i], 0), L - 1);
    const int r_first = min(rs, capf - wpr);
    const int8_t* rows = folded + ((size_t)t * capf + r_first) * LANES + chunk * 8;
#pragma unroll 4
    for (int r0 = 0; r0 < wpr; r0 += kRowsPerPass) {
      const int r = r0 + row_in_pass;
      int acc = 0;
      if (r < wpr) {
        const uint2 v = *reinterpret_cast<const uint2*>(rows + (size_t)r * LANES);
        acc = __dp4a((int)v.x, (int)qw.x, acc);
        acc = __dp4a((int)v.y, (int)qw.y, acc);
      }
#pragma unroll
      for (int off = CPS / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      const unsigned member = (unsigned)((r % rpg) * FOLD + slot);
      int32_t m1 = (int32_t)(((unsigned)acc << mshift) | member);
      int32_t m2 = kDead;
      // top two over the row's slots: each step merges two disjoint slot sets
#pragma unroll
      for (int off = CPS; off < CPR; off <<= 1) {
        const int32_t p1 = __shfl_xor_sync(kFull, m1, off);
        const int32_t p2 = __shfl_xor_sync(kFull, m2, off);
        m2 = max(min(m1, p1), max(m2, p2));
        m1 = max(m1, p1);
      }
      if (chunk == 0 && r < wpr) {
        o[r] = m1;
        if (o2) o2[r] = m2;
      }
    }
  }
}

template <int CPS, int CPR>
int launch(const void* folded, const void* q, const void* table, const void* row_start,
           void* out, void* out2, int L, int capf, int B, int MB, int wpr, int rpg,
           int mshift, cudaStream_t stream) {
  const long long n_windows = (long long)B * MB;
  const long long warps_per_cta = kThreads / 32;
  const long long ctas = (n_windows + warps_per_cta - 1) / warps_per_cta;
  const int grid = (int)(ctas < 132 * 32 ? ctas : 132 * 32);
  coarse_rowmax_kernel<CPS, CPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(folded), static_cast<const int8_t*>(q),
      static_cast<const int*>(table), static_cast<const int*>(row_start),
      static_cast<int32_t*>(out), static_cast<int32_t*>(out2), L, capf, B, MB, wpr, rpg,
      mshift);
  return (int)cudaGetLastError();
}

}  // namespace

// folded i8[L, capf, lanes] with lanes = fold * cs, q i8[B, cs], table and
// row_start i32[B, MB] (all contiguous, folded and q 16-byte aligned);
// out i32[B, MB * wpr] and, when out2 is not null, out2 of the same shape.
// (cs, lanes) is one of (8, 128), (16, 128), (32, 128), (64, 128),
// (128, 128), (256, 256); 0 < wpr <= capf, rpg >= 1, 0 <= mshift < 32.
// Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unsupported width).
extern "C" int rdf_coarse_rowmax(const void* folded, const void* q, const void* table,
                                 const void* row_start, void* out, void* out2, int L,
                                 int capf, int lanes, int cs, int B, int MB, int wpr, int rpg,
                                 int mshift, void* stream) {
  if ((long long)B * MB == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define RDF_ROWMAX(CPS, CPR) \
  launch<CPS, CPR>(folded, q, table, row_start, out, out2, L, capf, B, MB, wpr, rpg, mshift, st)
  if (lanes == 128) {
    switch (cs) {
      case 8: return RDF_ROWMAX(1, 16);
      case 16: return RDF_ROWMAX(2, 16);
      case 32: return RDF_ROWMAX(4, 16);
      case 64: return RDF_ROWMAX(8, 16);
      case 128: return RDF_ROWMAX(16, 16);
      default: break;
    }
  } else if (lanes == 256 && cs == 256) {
    return RDF_ROWMAX(32, 32);
  }
#undef RDF_ROWMAX
  return (int)cudaErrorInvalidValue;
}
