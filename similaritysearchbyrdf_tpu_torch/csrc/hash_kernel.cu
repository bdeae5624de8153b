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
// Two forms, chosen by shape in `rdf_hash_dense`: the narrow form below for
// D under kWideMinD (the dense paths' D 96-100), the wide form after it.
//
// The narrow form: register-blocked f32 FMA. A CTA of kWarps warps takes kTileRows
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
//
// The wide form (D from kWideMinD on; the sparse path's densified rows, D
// 4096): the work is a plain f32 GEMM, [B, D] x [D, T*C], and operations
// bound it (2*B*T*C*D flops: 0.32 ms at the fit's B 8192, T 10, C 32), which
// the narrow form's one table a CTA, chunk walk and per-chunk barriers do
// not reach. A CTA of 8 warps takes 320 rows x 2 tables (each table's C
// functions padded to 32 slots; 130 CTAs at B 8192, T 10) and walks D in
// 32-column k-slabs through a 3-stage cp.async ring, so copies overlap
// FMAs. Warp (wm, wt) holds rows 80 wm.. of table wt; its lane (tr, tc) =
// (lane % 8, lane / 8) a 10 x 8 register tile, rows tr + 8i and functions
// tc + 4j: per 4 columns, ten 16-byte shared loads of x (8 distinct rows a
// quarter-warp, 144 bytes apart: no bank conflict) and eight of the
// projection (broadcast within a quarter-warp) feed 320 FMAs, and the next
// 4 columns' loads go out before them (two register sets). A thread stages
// the same column group of every 32nd row, so its copies' addresses
// advance by fixed strides. Every dot stays in full
// f32 FMA, summed in ascending d. Where the row x table tiles do not fill
// the card (the query's B 64: 5 tiles), D is split across CTAs so that
// about one CTA runs an SM, each split at least 2 slabs; each split writes
// its partial dots to scratch the wrapper allocates ([splits, B, T*32]
// f32), and a second kernel adds them in ascending split order (no atomics:
// the same result in every run) and runs the narrow form's sign,
// permutation and margin epilogue. A hash word may differ from the plain
// version's only at bits whose |dot| is within rounding of 0.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (timing.py
// K1_sparse_fit / K1_sparse_query, 5 pairs against the narrow form in one
// call; D 4096, T 10, P 3, C 32): 0.562-0.567 ms device at the fit's B 8192
// (57% of the 0.3205 ms bound; from 1.13, and cuBLAS's f32 product alone
// takes 0.47) and 0.040 ms at the query's B 64 (from 0.18). The FMA loop
// alone ran at about 70% of the FMA issue rate with 8 x 8 register tiles;
// what it did not gain: the projection transposed in shared memory, 64- or
// 16-column slabs, 2 or 4 stages. kWideMinD: timing.py --only K1_width on
// two builds of this source, kWideMinD set past and below every width
// (device ms, narrow / wide): at D 256 the narrow form wins at B 64 and
// 1024 (0.0165 / 0.0186, 0.0235 / 0.0273) and loses at B 8192 (0.0813 /
// 0.0725); at D 384 the wide form wins at B 64 and 8192 (0.0221 / 0.0196,
// 0.120 / 0.089) and ties at B 1024 (0.0313 / 0.0315), and from D 512 on it
// wins at every B.

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

// kBytes (16 or 4) global -> shared, zero-filled when !valid (src is then
// not read)
template <int kBytes>
__device__ __forceinline__ void cp_async_z(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
  }
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
    if (in) cp_async_z<16>(dst, src, true);
    else *dst = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dk = reinterpret_cast<float*>(dst) + k;
      if (in && d + k < D) cp_async_z<4>(dk, src + k, true);
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

// the epilogue of both forms, for a warp's nr rows from row0 on and table t:
// lane j holds acc[r], the dot of row r with function j (lanes >= C: 0), and
// perm_at(p) gives perm[t, p, lane]. Every row's sign word first, then per
// permutation one ballot a row; lane r keeps row r's packed word,
// bit-reversed to MSB-first, so one store writes the warp's kRows hashes; a
// shuffle of |dot| gives the margins, one 128-byte store per (row,
// permutation).
template <class PermAt>
__device__ __forceinline__ void emit_hashes(const float (&acc)[kRows], PermAt perm_at, int lane,
                                            int nr, int row0, int t, int T, int C, int P,
                                            long long* __restrict__ hashes,
                                            float* __restrict__ margins) {
  const int L = T * P;
  unsigned signs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) signs[r] = __ballot_sync(kFull, lane < C && acc[r] > 0.f);
  for (int p = 0; p < P; ++p) {
    const int pj = perm_at(p);
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
    if (j < C) cp_async_z<4>(perm_s + i, perm + ((size_t)t * P + p) * C + j, true);
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

  emit_hashes(acc, [&](int p) { return perm_s[p * 32 + lane]; }, lane,
              min(kRows, rows - warp * kRows), r0 + warp * kRows, t, T, C, P, hashes, margins);
}

// ---------------------------------------------------------------------------
// The wide form (D from kWideMinD on); see the head of the file.

constexpr int kWideMinD = 384;              // the narrowest D the wide form takes (measured)
constexpr int kWRowsPT = 10;                // rows of a thread's register tile (x 8 functions)
constexpr int kWRowWarps = 4;               // warps along the rows of a CTA tile
constexpr int kWTables = 2;                 // tables of a CTA tile (one a warp column)
constexpr int kWRows = 8 * kWRowsPT * kWRowWarps;   // rows of a CTA tile (320)
constexpr int kWFuncs = 32 * kWTables;      // function slots of a CTA tile (64)
constexpr int kWK = 32;                     // columns of a k-slab
constexpr int kWPitch = kWK + 4;            // floats of a staged row: rows 4 banks apart
constexpr int kWStages = 3;                 // k-slabs in the ring
constexpr int kWThreads = kWRowWarps * kWTables * 32;
constexpr int kWMinSlabs = 2;               // the fewest k-slabs a split takes
constexpr int kWStageFloats = (kWRows + kWFuncs) * kWPitch;
constexpr int kWSmem = kWStages * kWStageFloats * (int)sizeof(float);
constexpr int kWGroups = kWK / 4;           // 4-column groups of a slab row
constexpr int kWRowStep = kWThreads / kWGroups;   // staged rows a pass of the CTA's threads covers
static_assert(kWRows % kWRowStep == 0 && kWFuncs % kWRowStep == 0,
              "a thread stages the same column group of every kWRowStep-th row");

// 4 columns from col on of one staged row (src: the row's start), zeros
// where !ok or past D
template <bool kVec>
__device__ __forceinline__ void stage_group4(float* dst, const float* src, bool ok, int col,
                                             int D) {
  if constexpr (kVec) {
    const bool in = ok && col < D;
    cp_async_z<16>(dst, in ? src + col : src, in);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = ok && col + e < D;
      cp_async_z<4>(dst + e, in ? src + col + e : src, in);
    }
  }
}

// k-slab `slab` of the CTA's x rows [r0, r0 + rows) and of the projection
// of tables [t0, t0 + kWTables) into one ring stage: x as [kWRows][kWPitch],
// then the projection as [kWFuncs][kWPitch] (function slot 32 (t - t0) + j);
// zeros past B, T, C and D. A thread stages column group threadIdx.x %
// kWGroups of rows threadIdx.x / kWGroups + kWRowStep n, so its source rows
// advance by a fixed stride. kVec: D % 4 == 0 and x, proj 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void stage_slab(float* dst, const float* __restrict__ x,
                                           const float* __restrict__ proj, int r0, int rows,
                                           int t0, int T, int C, int D, int slab) {
  const int rr = threadIdx.x / kWGroups, c = threadIdx.x % kWGroups;
  const int col = slab * kWK + 4 * c;
  float* d = dst + 4 * c;
#pragma unroll
  for (int n = 0; n < kWRows / kWRowStep; ++n) {
    const int r = rr + kWRowStep * n;
    const bool ok = r < rows;
    stage_group4<kVec>(d + r * kWPitch, x + (size_t)(ok ? r0 + r : 0) * D, ok, col, D);
  }
#pragma unroll
  for (int n = 0; n < kWFuncs / kWRowStep; ++n) {
    const int f = rr + kWRowStep * n, t = t0 + (f >> 5), j = f & 31;
    const bool ok = t < T && j < C;
    stage_group4<kVec>(d + (kWRows + f) * kWPitch, proj + (size_t)(ok ? t * C + j : 0) * D, ok,
                       col, D);
  }
}

// partial dots of split blockIdx.y (k-slabs [split * per, + per) of D) for
// a tile of kWRows rows x kWTables tables: part[split, b, 32 t + j]
template <bool kVec>
__global__ void __launch_bounds__(kWThreads, 1)
hash_wide_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                 float* __restrict__ part, int B, int D, int T, int C, int per) {
  extern __shared__ float4 wsm4[];
  float* wsm = reinterpret_cast<float*>(wsm4);
  const int ntt = (T + kWTables - 1) / kWTables;
  const int nt = blockIdx.x % ntt;          // table tiles fastest: a row tile's x meets in L2
  const int r0 = (blockIdx.x / ntt) * kWRows, t0 = nt * kWTables;
  const int rows = min(kWRows, B - r0);
  const int split = blockIdx.y;
  const int s0 = split * per;
  const int ns = min(per, (D + kWK - 1) / kWK - s0);   // k-slabs of this split (>= 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWTables, wt = warp - wm * kWTables;
  const int tr = lane & 7, tc = lane >> 3;
  const bool active = wm * 8 * kWRowsPT < rows && t0 + wt < T;   // warp-uniform

  float acc[kWRowsPT][8];
#pragma unroll
  for (int i = 0; i < kWRowsPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < ns) stage_slab<kVec>(wsm + s * kWStageFloats, x, proj, r0, rows, t0, T, C, D, s0 + s);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWStages - 2) : "memory");   // slab s landed
    __syncthreads();                        // for every thread; and slab s - 1 is consumed
    const int next = s + kWStages - 1;
    if (next < ns)
      stage_slab<kVec>(wsm + (next % kWStages) * kWStageFloats, x, proj, r0, rows, t0, T, C, D,
                       s0 + next);
    cp_async_commit();
    if (!active) continue;
    const float* stage = wsm + (s % kWStages) * kWStageFloats;
    const float* xr = stage + (wm * 8 * kWRowsPT + tr) * kWPitch;
    const float* pr = stage + (kWRows + wt * 32 + tc) * kWPitch;
    // two register sets: the next 4 columns' loads are issued before this
    // 4's FMAs, so shared-memory latency hides behind them
    float4 xv[2][kWRowsPT], pv[2][8];
#define RDF_WIDE_LOAD(S, KQ)                                                            \
    _Pragma("unroll") for (int i = 0; i < kWRowsPT; ++i)                              \
        xv[S][i] = *reinterpret_cast<const float4*>(xr + 8 * i * kWPitch + 4 * (KQ)); \
    _Pragma("unroll") for (int j = 0; j < 8; ++j)                                     \
        pv[S][j] = *reinterpret_cast<const float4*>(pr + 4 * j * kWPitch + 4 * (KQ));
#define RDF_WIDE_K(S, F)                                                                \
    _Pragma("unroll") for (int i = 0; i < kWRowsPT; ++i)                              \
    _Pragma("unroll") for (int j = 0; j < 8; ++j)                                     \
        acc[i][j] = fmaf(xv[S][i].F, pv[S][j].F, acc[i][j]);
    RDF_WIDE_LOAD(0, 0)
#pragma unroll
    for (int kq = 0; kq < kWGroups; ++kq) {
      if (kq + 1 < kWGroups) { RDF_WIDE_LOAD((kq + 1) & 1, kq + 1) }
      // column 4kq, then 4kq + 1, ...: every dot in ascending d
      RDF_WIDE_K(kq & 1, x)
      RDF_WIDE_K(kq & 1, y)
      RDF_WIDE_K(kq & 1, z)
      RDF_WIDE_K(kq & 1, w)
    }
#undef RDF_WIDE_LOAD
#undef RDF_WIDE_K
  }
  if (!active) return;
  const size_t ld = (size_t)T * 32;
  float* dst = part + ((size_t)split * B + r0) * ld + (size_t)(t0 + wt) * 32 + tc;
#pragma unroll
  for (int i = 0; i < kWRowsPT; ++i) {
    const int r = wm * 8 * kWRowsPT + tr + 8 * i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(size_t)r * ld + 4 * j] = acc[i][j];
    }
  }
}

// the wide form's second kernel: each dot the sum of its splits' partials
// in ascending split order, then the epilogue; a warp takes kRows rows of
// one table, as the narrow form's warps do
__global__ void __launch_bounds__(kWarps * 32)
hash_finish_kernel(const float* __restrict__ part, const int* __restrict__ perm,
                   long long* __restrict__ hashes, float* __restrict__ margins, int B, int T,
                   int C, int P, int splits) {
  constexpr int kAhead = 8;                 // splits loaded before their adds
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows + (threadIdx.x >> 5) * kRows;
  if (row0 >= B) return;                    // warp-uniform
  const int nr = min(kRows, B - row0);
  const size_t ld = (size_t)T * 32, plane = (size_t)B * ld;
  const float* src = part + (size_t)row0 * ld + (size_t)t * 32 + lane;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += kAhead) {
    float v[kAhead][kRows];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        v[u][r] = s0 + u < splits && r < nr ? src[(size_t)(s0 + u) * plane + r * ld] : 0.f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += v[u][r];
  }
  emit_hashes(acc, [&](int p) { return lane < C ? perm[((size_t)t * P + p) * C + lane] : 0; },
              lane, nr, row0, t, T, C, P, hashes, margins);
}

// the wide form's plan on the current device: its splits of D (0: the
// narrow form; -1: no device) and in *per the k-slabs each split takes (the
// last one fewer). One split where the row x table tiles fill the card,
// else about one CTA an SM, each split at least kWMinSlabs k-slabs.
int wide_plan(int B, int D, int T, int* per) {
  if (D < kWideMinD || B <= 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int tiles = ((B + kWRows - 1) / kWRows) * ((T + kWTables - 1) / kWTables);
  const int slabs = (D + kWK - 1) / kWK;
  const int s = min(sms / tiles, slabs / kWMinSlabs);
  *per = s <= 1 ? slabs : (slabs + s - 1) / s;
  return (slabs + *per - 1) / *per;
}

}  // namespace

// The scratch the wide form needs, in splits of [B, T*32] f32 (0: the
// narrow form, no scratch), on the current device: the wrapper allocates
// it and passes it to rdf_hash_dense.
extern "C" int rdf_hash_dense_splits(int B, int D, int T) {
  int per = 0;
  return wide_plan(B, D, T, &per);
}

// x f32[B, D], proj f32[T, C, D], perm i32[T, P, C] (all contiguous);
// hashes i64[B, T*P] (unsigned 32-bit values); margins f32[B, T*P, 32] or
// null; scratch f32[rdf_hash_dense_splits(B, D, T), B, T*32] (null for the
// narrow form). Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue when the wide form's scratch is missing).
extern "C" int rdf_hash_dense(const void* x, const void* proj, const void* perm,
                              void* hashes, void* margins, void* scratch, int B, int D, int T,
                              int C, int P, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = D % 4 == 0 && ((uintptr_t)x | (uintptr_t)proj) % 16 == 0;
  if (D >= kWideMinD) {   // the form by shape, never as a fallback
    int per = 0;
    const int splits = wide_plan(B, D, T, &per);
    if (splits < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const auto wide = vec ? hash_wide_kernel<true> : hash_wide_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(((B + kWRows - 1) / kWRows) * ((T + kWTables - 1) / kWTables), splits);
    wide<<<grid, kWThreads, kWSmem, st>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(proj),
                                          static_cast<float*>(scratch), B, D, T, C, per);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    hash_finish_kernel<<<dim3((B + kTileRows - 1) / kTileRows, T), kWarps * 32, 0, st>>>(
        static_cast<const float*>(scratch), static_cast<const int*>(perm),
        static_cast<long long*>(hashes), static_cast<float*>(margins), B, T, C, P, splits);
    return (int)cudaGetLastError();
  }
  const int gcap = min((D + 3) / 4, kChunkGroups);
  const size_t smem = (size_t)(32 + kTileRows) * gcap * sizeof(float4) +
                      (size_t)P * 32 * sizeof(int);
  const auto kernel = vec ? hash_dense_kernel<true> : hash_dense_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kTileRows - 1) / kTileRows, T);
  kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(proj),
      static_cast<const int*>(perm), static_cast<long long*>(hashes),
      static_cast<float*>(margins), B, D, T, C, P);
  return (int)cudaGetLastError();
}
