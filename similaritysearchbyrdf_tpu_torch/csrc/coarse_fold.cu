// K3: folded row-max kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of similaritysearchbyrdf_tpu/ops/pallas/
// coarse_fold.py (`pallas_coarse_rowmax` -> `_kernel`). The folded coarse
// tier i8[L, capf, lanes] holds fold = lanes / cs consecutive slots of one
// table per physical row. For every (query b, window m) that is live
// (row_start >= 0) it reads wpr physical rows of table t = clip(table, 0,
// L-1) from row rs = min(row_start, capf - wpr), scores every slot s of row
// r with the exact int32 dot of its cs int8 values against the query's cs
// int8 values, packs
//   pk = (score << mshift) | member,  member = ((r & (rpg - 1)) * fold) | s
// (rpg a power of two; the shift in unsigned arithmetic: the caller
// guarantees it does not overflow) and writes the row's maximum pk to
// out[b, m*wpr + r] and, with out2, the row's second-largest pk (kDead when
// the row has one slot). A dead window writes kDead to every row of both
// outputs and reads nothing. Every value is integer-exact, so the kernel
// equals its plain version (`coarse_rowmax_plain`, a transcription of
// `rowmax_fallback`) bit for bit.
//
// Bound: bytes. A live window's rows are one contiguous run of wpr * lanes
// bytes (64 KB at the folded query's wpr 512), scored at two integer
// operations per byte, far below the int8 rate; at B 64 x MB 128 windows a
// call gathers 537 MB and writes 16.8 MB per output.
//
// Design: a persistent grid of two CTAs per SM, each walking a contiguous
// range of the B*MB (query, window) items in order. One thread of a
// producer warp streams each live window's run into a ring of 16 KB
// shared-memory stages by 1-D bulk copy (TMA, no tensor map), one mbarrier
// per stage with the stage's bytes as its transaction count, keeping up to
// six stages (96 KB) in flight, across window boundaries; the next window's
// copies overlap this window's compute. Each consumer thread owns one row
// of a stage: it reads the row 16 bytes at a time, its first chunk rotated
// by row % 8 so that the eight rows of a quarter-warp hit distinct banks,
// takes the slot dots with __dp4a and keeps the row's top two packed values
// in registers, with no shuffle. Row maxima of consecutive rows go out as
// coalesced stores; dead windows are filled with 16-byte stores. The TPU
// kernel's block-diagonal [fold, 128] query matrix and its DMA run
// coalescing are Mosaic tactics with no counterpart here: walking one
// query's windows in order streams adjacent rows of one table already.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py's kernels_folded, the 8M folded query's real windows, B 64
// x MB 128 x wpr 512, fold 8, all live): 0.220 ms, 0.223 ms with the second
// output, against a bound of 0.117 ms (the 376 MB of distinct rows read
// once, 16.8 MB written) - 2.44 TB/s on the 537 MB gathered. The ring's
// shape (8-32 KB stages, 3-12 stages, 1-3 CTAs per SM) moved the time only
// within the run-to-run spread; what is left is reuse: windows of different
// queries overlap, and each reads its rows from memory again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kDead = -2147483647;    // -(2^31 - 1), the caller's I32_DEAD
constexpr int32_t kMin = -2147483647 - 1;
constexpr int kStageBytes = 16384;        // one ring stage
constexpr int kStages = 6;                // ring depth
constexpr int kCtasPerSm = 2;             // 2 x 96 KB of ring per SM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 1-D bulk copy global -> shared (16-byte aligned, a multiple of 16 bytes);
// completion lands on `bar` as `bytes` transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int dot16(uint4 v, uint4 w, int acc) {
  acc = __dp4a((int)v.x, (int)w.x, acc);
  acc = __dp4a((int)v.y, (int)w.y, acc);
  acc = __dp4a((int)v.z, (int)w.z, acc);
  return __dp4a((int)v.w, (int)w.w, acc);
}

__device__ __forceinline__ void push_top2(int dot, int mshift, unsigned member, int32_t& m1,
                                          int32_t& m2) {
  const int32_t pk = (int32_t)(((unsigned)dot << mshift) | member);
  m2 = max(m2, min(m1, pk));
  m1 = max(m1, pk);
}

// kDead into o[0, n): scalar up to 16-byte alignment, then 16-byte stores.
__device__ void fill_dead(int32_t* o, int n, int tid, int nthreads) {
  const int head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> 2));
  const int body = (n - head) >> 2;
  int4* o4 = reinterpret_cast<int4*>(o + head);
  const int4 d = make_int4(kDead, kDead, kDead, kDead);
  for (int k = tid; k < head; k += nthreads) o[k] = kDead;
  for (int k = tid; k < body; k += nthreads) o4[k] = d;
  for (int k = head + 4 * body + tid; k < n; k += nthreads) o[k] = kDead;
}

template <int CS, int LANES>
struct Shape {
  static constexpr int kRows = kStageBytes / LANES;   // rows per stage = consumer threads
  static constexpr int kConsumerWarps = kRows / 32;
  static constexpr int kThreads = kRows + 32;         // + one producer warp
  static constexpr int kFold = LANES / CS;
  static constexpr int kCps = CS >= 16 ? CS / 16 : 1; // 16-byte chunks per slot
};

template <int CS, int LANES>
__global__ void __launch_bounds__(Shape<CS, LANES>::kThreads, kCtasPerSm)
coarse_rowmax_kernel(const int8_t* __restrict__ folded, const int8_t* __restrict__ q,
                     const int* __restrict__ table, const int* __restrict__ row_start,
                     int32_t* __restrict__ out, int32_t* __restrict__ out2, int L, int capf,
                     int B, int MB, int wpr, int rpg, int mshift) {
  using S = Shape<CS, LANES>;
  constexpr int kRows = S::kRows;
  constexpr int kFold = S::kFold;
  constexpr int kCps = S::kCps;
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const long long n_items = (long long)B * MB;
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kRows) {  // producer warp: one thread issues every copy
    if (tid != kRows) return;
    int stage = 0;
    unsigned phase = 0;
    for (long long i = i0; i < i1; ++i) {
      const int rs = row_start[i];
      if (rs < 0) continue;
      const int t = min(max(table[i], 0), L - 1);
      const int8_t* src = folded + ((size_t)t * capf + min(rs, capf - wpr)) * LANES;
      for (int c0 = 0; c0 < wpr; c0 += kRows) {
        const unsigned bytes = (unsigned)min(kRows, wpr - c0) * LANES;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], bytes);
        bulk_load(ring + stage * kStageBytes, src + (size_t)c0 * LANES, bytes, &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread tid owns row c0 + tid of each stage
  const int rot = tid & 7;
  const unsigned rmask = (unsigned)rpg - 1;
  int stage = 0;
  unsigned phase = 0;
  for (long long i = i0; i < i1; ++i) {
    int32_t* o = out + i * wpr;
    int32_t* o2 = out2 ? out2 + i * wpr : nullptr;
    if (row_start[i] < 0) {
      fill_dead(o, wpr, tid, kRows);
      if (o2) fill_dead(o2, wpr, tid, kRows);
      continue;
    }
    const int8_t* qb = q + (i / MB) * CS;
    uint2 q8 = make_uint2(0, 0);
    uint4 q16 = make_uint4(0, 0, 0, 0);
    if constexpr (CS == 8) {
      q8 = __ldg(reinterpret_cast<const uint2*>(qb));
    } else if constexpr (CS == 16) {
      q16 = __ldg(reinterpret_cast<const uint4*>(qb));
    }
    for (int c0 = 0; c0 < wpr; c0 += kRows) {
      const int r = c0 + tid;
      mbar_wait(&full[stage], phase);
      if (r < wpr) {
        const unsigned char* row = ring + stage * kStageBytes + tid * LANES;
        const unsigned mbase = ((unsigned)r & rmask) * kFold;
        int32_t m1 = kMin, m2 = kDead;
        if constexpr (CS == 8) {  // a 16-byte chunk holds slots 2j and 2j + 1
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int j = (k + rot) & 7;
            const uint4 v = *reinterpret_cast<const uint4*>(row + j * 16);
            int d0 = __dp4a((int)v.x, (int)q8.x, 0);
            d0 = __dp4a((int)v.y, (int)q8.y, d0);
            int d1 = __dp4a((int)v.z, (int)q8.x, 0);
            d1 = __dp4a((int)v.w, (int)q8.y, d1);
            push_top2(d0, mshift, mbase | (2 * j), m1, m2);
            push_top2(d1, mshift, mbase | (2 * j + 1), m1, m2);
          }
        } else {
          // slot s = chunks [s * kCps, (s + 1) * kCps); with kFold * kCps
          // chunks of 16 bytes in a row, (slot, chunk) rotated by rot puts
          // the eight rows of a quarter-warp on distinct banks
#pragma unroll
          for (int k = 0; k < kFold; ++k) {
            const int s = (k + rot) & (kFold - 1);
            int acc = 0;
#pragma unroll
            for (int p = 0; p < kCps; ++p) {
              const int pp = (p + rot / kFold) & (kCps - 1);
              const uint4 v = *reinterpret_cast<const uint4*>(row + (s * kCps + pp) * 16);
              if constexpr (kCps == 1) {
                acc = dot16(v, q16, acc);
              } else {
                acc = dot16(v, __ldg(reinterpret_cast<const uint4*>(qb) + pp), acc);
              }
            }
            push_top2(acc, mshift, mbase | (unsigned)s, m1, m2);
          }
        }
        o[r] = m1;
        if (o2) o2[r] = m2;
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <int CS, int LANES>
int launch(const void* folded, const void* q, const void* table, const void* row_start,
           void* out, void* out2, int L, int capf, int B, int MB, int wpr, int rpg, int mshift,
           cudaStream_t stream) {
  using S = Shape<CS, LANES>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = kStages * kStageBytes + 2 * kStages * (int)sizeof(uint64_t);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(coarse_rowmax_kernel<CS, LANES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_items = (long long)B * MB;
  const long long ctas = (long long)kCtasPerSm * sms;
  const int grid = (int)(n_items < ctas ? n_items : ctas);
  coarse_rowmax_kernel<CS, LANES><<<grid, S::kThreads, smem, stream>>>(
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
// (128, 128), (256, 256); 0 < wpr <= capf, rpg a power of two,
// 0 <= mshift < 32. Launches on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unsupported width).
extern "C" int rdf_coarse_rowmax(const void* folded, const void* q, const void* table,
                                 const void* row_start, void* out, void* out2, int L,
                                 int capf, int lanes, int cs, int B, int MB, int wpr, int rpg,
                                 int mshift, void* stream) {
  if ((long long)B * MB == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define RDF_ROWMAX(CS, LANES) \
  launch<CS, LANES>(folded, q, table, row_start, out, out2, L, capf, B, MB, wpr, rpg, mshift, st)
  if (lanes == 128) {
    switch (cs) {
      case 8: return RDF_ROWMAX(8, 128);
      case 16: return RDF_ROWMAX(16, 128);
      case 32: return RDF_ROWMAX(32, 128);
      case 64: return RDF_ROWMAX(64, 128);
      case 128: return RDF_ROWMAX(128, 128);
      default: break;
    }
  } else if (lanes == 256 && cs == 256) {
    return RDF_ROWMAX(256, 256);
  }
#undef RDF_ROWMAX
  return (int)cudaErrorInvalidValue;
}
