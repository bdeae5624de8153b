// K4: flat group-max kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels of similaritysearchbyrdf_tpu/ops/pallas/
// flat_groupmax.py, all three entries with one kernel: `pallas_flat_groupmax`
// and `pallas_flat_groupmax_qmajor` (`_gmax_kernel`, transposed or
// query-major output) and `pallas_flat_groupmax_qlane` (`_gmax_qlane_kernel`,
// the strided-sketch variant with the fused supergroup tier). For a sketch
// S [Npad, D] and queries Q [B, D], both int8 or both bf16, it writes the
// query-major
//   out[b, j] = max over the G rows r of group j of  sum_d Q[b, d] * S[r, d]
// as f32, or, with `pack` (int8 only), the int32 key
//   (score << log2 G) | (r % G)
// of the group's best row (ties go to the highest member, as the max of the
// keys picks). With esg > 0 it also writes the maxima of every esg adjacent
// groups' keys, query-major [B, Npad/G/esg], with no mask, as the reference
// emits them. int8 dots are exact int32 sums, so the kernel equals its plain
// version (`flat_groupmax_plain`) bit for bit; bf16 dots accumulate in f32.
// The [B, Npad] scores never reach device memory.
//
// Bound: operations. At the Deep-8M shape (Npad 8,003,584, D 96, B 1024,
// int8) a call does 1.57e12 int8 operations (0.80 ms at 1,979 TOPS) and
// moves 768 MB of sketch and 512 MB of output (0.38 ms at 3.35 TB/s).
//
// Two forms, chosen by shape in `rdf_flat_groupmax`:
//
// The wgmma form (int8, D up to kWgMaxD = 192). A persistent grid, one CTA
// per SM, of five warpgroups: four consumers and a producer. Each CTA keeps
// a chunk of up to qc queries resident in shared memory (all 1,024 at D
// 96) and walks every gridDim.x-th 512-row sketch block; one producer thread
// keeps the next block in flight by TMA through a two-stage mbarrier ring,
// so the sketch is read from memory once per query chunk and the query
// batch once per CTA. Both operands land in wgmma's 32-byte swizzle: one
// TMA box of 32 bytes x 256 rows per k-step, a tile stored as [D/32][rows]
// [32] planes (descriptor: swizzle 32B, 256 bytes between 8-row groups).
// A consumer warpgroup scores 64 queries (the M operand) against a block's
// rows in four 128-row subtiles, each D/32 m64n128k32 s8 wgmma products
// issued back to back (k-steps a compile-time constant); the four consumers
// take every fourth 64-query tile, so while some wait on the tensor cores
// the others run their epilogues. A thread's accumulators hold two query
// rows x (2 columns of each n8 block), so a group max is a max over
// registers and a quad exchange: a packed key is one IMAD (score * G, G
// read at run time so the multiply lands on the FMA pipe and not on the
// integer pipe that runs the max tree, plus the member's compile-time
// offset; the thread's own offset 2 * (lane % 4) is added once after the
// max, as it is common to all its keys), then a tree of two-input maxima:
// about one IMAD and one max per packed score. The quad reduce-scatters the
// span's group maxima (a span: the subtiles that make at least 8 groups, or
// the whole block), so each lane holds consecutive groups and a quad
// writes 32 bytes or more of each query row per store (512 / G groups for
// G >= 128). The supergroup tier reduces within a lane and across the quad
// before its order-free atomicMax. No scratch round trip and no CTA barrier
// sit in the epilogue.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py,
// flat_8m's real operands, B 1024 x 8,003,584 x 96, G 64): 1.31 ms packed
// (61% of the 0.795 ms bound), 1.06 ms unpacked, 1.44 ms with the
// supergroup tier, from 3.4-3.7 ms on mma.sync. What holds it: the epilogue
// (one IMAD and one max per score on the integer and FMA pipes, about as
// much issue as the products take on the tensor cores) overlaps the other
// warpgroups' products only in part; two warpgroups, a strict turnstile
// between them, or three-way maxima were each slower.
//
// The mma.sync form (bf16, and int8 past D 192): the product runs on the
// tensor cores through mma.sync
// (m16n8k32 s8 -> s32, or m16n8k16 bf16 -> f32: both take a 32-byte slice
// of a row per step, so the fragments load alike), with the queries as the
// M operand and the sketch rows as N. A CTA of `nw` warps owns 64*nw
// consecutive sketch rows, staged once in shared memory, and walks all B
// queries in blocks of 128, each block staged by cp.async while the previous
// one is scored; a warp owns 64 of the rows and scores 32 queries at a time
// (rows padded by 16 bytes in shared memory, so every ldmatrix is free of
// bank conflicts). A 16x8 accumulator tile holds a query's scores for 8 rows
// across the 4 lanes of a quad, so a group's max is a max over registers
// and two shuffles; packing is one multiply-add per score. Per-64-row maxima
// of a 128-query block go through shared memory, one barrier per block,
// where groups wider than 64 rows and the supergroup tier are folded and
// written coalesced; the supergroup tier uses atomicMax on an output the
// wrapper fills with INT32_MIN, which is order-free and so deterministic.
// Where whole rows of a sketch tile of at least 4 warps (and of G rows) and
// of two query blocks do not fit in shared memory (int8 D past 416, bf16 D
// past 192), the sliced form stages D in 256-byte slices
// instead: for every 32 queries it stages each slice of the CTA's rows and
// of those queries in turn, and the accumulators stay in registers across
// slices, so any D works, at the cost of reading the sketch tile again for
// every 32 queries.
// mma.sync reaches only part of the tensor-core peak, and its operands
// pass through ldmatrix for every 32 queries.
// The TPU kernels' strided (halved) sketch copy, nsub pipelining, in-kernel
// transpose and lane-reduction variant were Mosaic layout tactics and have
// no counterpart.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 32;                 // queries per warp step (two m16 tiles)
constexpr int kSteps = 4;                  // warp steps per staged query block
constexpr int kQBlock = kQTile * kSteps;   // queries staged and reduced per barrier
constexpr int kRowsPerWarp = 64;           // sketch rows per warp (eight n8 tiles)
constexpr int kSlice = 256;                // bytes of D per staged slice (sliced form)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;           // 227 KB a block can opt into

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the first `width` bytes of `count` rows of `pitch` bytes from src row
// `first` (zeros past `limit`) into shared rows of `stride` bytes
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src, long long first,
                                           int count, long long limit, int pitch, int width,
                                           int stride) {
  const int cpr = width >> 4;
  for (int i = threadIdx.x; i < count * cpr; i += blockDim.x) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = first + r < limit;
    cp_async16(dst + (size_t)r * stride + c * 16,
               src + (size_t)(ok ? first + r : 0) * pitch + c * 16, ok);
  }
  cp_async_commit();
}

// the product and the reduction of one input type: a score's key (the
// packed key, the int score, or the bf16 path's f32 score), the max of
// keys, and the output word a key becomes
template <bool BF16, bool PACK>
struct Kind;

template <bool PACK>
struct Kind<false, PACK> {   // int8 x int8 -> int32
  using T = int;
  static __device__ __forceinline__ void mma(T (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // score * group + member: the shift of the reference, in unsigned
  // arithmetic (the caller guarantees it does not overflow)
  static __device__ __forceinline__ T key(T s, unsigned group, unsigned member) {
    if constexpr (PACK) {
      return (int)((unsigned)s * group + member);
    } else {
      return s;
    }
  }
  static __device__ __forceinline__ T max(T a, T b) { return a > b ? a : b; }
  static __device__ __forceinline__ T of_bits(int w) { return w; }
  static __device__ __forceinline__ int bits(T v) { return v; }
  static __device__ __forceinline__ int word(T v) {
    if constexpr (PACK) {
      return v;
    } else {
      return __float_as_int((float)v);   // exact below 2^24, else rounded to nearest
    }
  }
};

template <>
struct Kind<true, false> {   // bf16 x bf16 -> f32
  using T = float;
  static __device__ __forceinline__ void mma(T (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ T key(T s, unsigned, unsigned) { return s; }
  static __device__ __forceinline__ T max(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ T of_bits(int w) { return __int_as_float(w); }
  static __device__ __forceinline__ int bits(T v) { return __float_as_int(v); }
  static __device__ __forceinline__ int word(T v) { return __float_as_int(v); }
};

// acc += 32 staged queries x a warp's 64 staged rows over `ksteps` 32-byte
// steps of D; abase and bbase are this lane's ldmatrix addresses
template <class K, typename T>
__device__ __forceinline__ void mma_rows(T (&acc)[2][8][4], const uint8_t* abase,
                                         const uint8_t* bbase, int stride, int ksteps) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[2][4];
    ldmatrix_x4(a[0], abase + ks * 32);
    ldmatrix_x4(a[1], abase + 16 * stride + ks * 32);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, bbase + (size_t)n * 8 * stride + ks * 32);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        K::mma(acc[m][n], a[m], b[0], b[1]);
        K::mma(acc[m][n + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// UG = min(G, 64): rows per reduction unit inside a warp. A warp yields
// 64 / UG units per query; the store stage folds G / UG units per group.
// SLICED: D staged in kSlice-byte slices (see the head of the file).
template <bool BF16, bool PACK, int UG, bool SLICED>
__global__ void __launch_bounds__(256, SLICED ? 1 : 2)
flat_groupmax_kernel(const uint8_t* __restrict__ sk, const uint8_t* __restrict__ q,
                     int* __restrict__ out, int* __restrict__ sgout, int npad, int B,
                     int dbytes, int group, int esg) {
  using K = Kind<BF16, PACK>;
  using T = typename K::T;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = blockDim.x >> 5;
  const int rows = nw * kRowsPerWarp;                 // sketch rows of this CTA
  const int units = rows / UG;                        // reduction units of this CTA
  const int stride = (SLICED ? kSlice : dbytes) + 16; // bytes of a staged row
  const int qrows = SLICED ? kQTile : 2 * kQBlock;    // staged query rows
  uint8_t* sks = smem;                                               // [rows][stride]
  uint8_t* qs = smem + (size_t)rows * stride;                        // [qrows][stride]
  int* obuf = reinterpret_cast<int*>(qs + (size_t)qrows * stride);   // [2][kQBlock][units]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                            // row of a fragment (groupID)
  const int tig = lane & 3;                           // thread in the quad
  const long long row0 = (long long)blockIdx.x * rows;
  const int ng = npad / group;
  const int upg = group / UG;                         // units per group
  const int cta_groups = units / upg;
  const long long group0 = row0 / group;
  // a score's member is mbase + (its row within the warp's 64), wrapped to G
  const unsigned mbase = (unsigned)(tig * 2) + (group > 64 ? (warp * 64) & (group - 1) : 0);

  if constexpr (!SLICED) {
    stage_rows(sks, sk, row0, rows, npad, dbytes, dbytes, stride);
    stage_rows(qs, q, 0, kQBlock, B, dbytes, dbytes, stride);
    cp_async_wait_all();
    __syncthreads();
  }

  // ldmatrix.x4 addresses. B (sketch rows, two n8 tiles): matrices (tile,
  // bytes 0-15), (tile, 16-31), (tile+1, 0-15), (tile+1, 16-31) give b0, b1
  // of both tiles. A (queries, one m16 tile): (rows 0-7, 0-15), (8-15,
  // 0-15), (0-7, 16-31), (8-15, 16-31) give a0..a3. Lane l addresses row
  // l & 7 of matrix l >> 3.
  const uint8_t* bbase = sks + (size_t)(warp * kRowsPerWarp + ((lane >> 4) << 3) + (lane & 7)) *
                                   stride + ((lane >> 3) & 1) * 16;
  const int a_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * stride + (lane >> 4) * 16;
  const int nblk = (B + kQBlock - 1) / kQBlock;
  for (int blk = 0; blk < nblk; ++blk) {
    const int q0 = blk * kQBlock;
    if (!SLICED && blk + 1 < nblk) {   // the next block's queries arrive while this one is scored
      stage_rows(qs + (size_t)((blk + 1) & 1) * kQBlock * stride, q, q0 + kQBlock, kQBlock, B,
                 dbytes, dbytes, stride);
    }
    const uint8_t* qb = qs + (size_t)(SLICED ? 0 : blk & 1) * kQBlock * stride;
    int* ob = obuf + (blk & 1) * kQBlock * units;
    for (int st = 0; st < kSteps && q0 + st * kQTile < B; ++st) {   // CTA-uniform
      T acc[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
      if constexpr (SLICED) {
        // each slice of D: the CTA's rows and these 32 queries, staged once
        // the previous slice is consumed
        for (int d0 = 0; d0 < dbytes; d0 += kSlice) {
          const int w = min(kSlice, dbytes - d0);
          __syncthreads();
          stage_rows(sks, sk + d0, row0, rows, npad, dbytes, w, stride);
          stage_rows(qs, q + d0, q0 + st * kQTile, kQTile, B, dbytes, w, stride);
          cp_async_wait_all();
          __syncthreads();
          mma_rows<K>(acc, qs + a_off, bbase, stride, w >> 5);
        }
      } else {
        mma_rows<K>(acc, qb + (size_t)(st * kQTile) * stride + a_off, bbase, stride, dbytes >> 5);
      }

      // each unit of UG rows: a max over registers (2 rows per n8 tile,
      // UG/8 tiles), then over the quad's 4 lanes
      constexpr int kTilesPerUnit = UG / 8;
#pragma unroll
      for (int u = 0; u < 8 / kTilesPerUnit; ++u) {
        T v[2][2];
#pragma unroll
        for (int t = 0; t < kTilesPerUnit; ++t) {
          const int n = u * kTilesPerUnit + t;
          const unsigned m0 = mbase + ((n * 8) & (UG - 1));
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const T k = K::max(K::key(acc[m][n][2 * h], group, m0),
                                 K::key(acc[m][n][2 * h + 1], group, m0 + 1));
              v[m][h] = t == 0 ? k : K::max(v[m][h], k);
            }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            T w = v[m][h];
            w = K::max(w, __shfl_xor_sync(kFull, w, 1));
            w = K::max(w, __shfl_xor_sync(kFull, w, 2));
            if (tig == 0) {
              ob[(st * kQTile + m * 16 + h * 8 + g) * units + warp * (kRowsPerWarp / UG) + u] =
                  K::bits(w);
            }
          }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // ob and the next query block complete; the other buffers are free

    // groups: fold upg units each, write rows of cta_groups words
    for (int i = threadIdx.x; i < kQBlock * cta_groups; i += blockDim.x) {
      const int ql = i / cta_groups, j = i - ql * cta_groups;
      const long long grp = group0 + j;
      if (q0 + ql >= B || grp >= ng) continue;
      const int* src = ob + ql * units + j * upg;
      T v = K::of_bits(src[0]);
      for (int u = 1; u < upg; ++u) v = K::max(v, K::of_bits(src[u]));
      out[(size_t)(q0 + ql) * ng + grp] = K::word(v);
    }
    if (PACK && esg > 0) {   // supergroups of esg groups (packed keys only)
      const int span = min(esg * upg, units);        // units of one supergroup in this CTA
      const int nsg_cta = units / span;
      const int nsg = ng / esg;
      for (int i = threadIdx.x; i < kQBlock * nsg_cta; i += blockDim.x) {
        const int ql = i / nsg_cta, s = i - ql * nsg_cta;
        const long long grp = group0 + (long long)s * span / upg;
        if (q0 + ql >= B || grp >= ng) continue;
        const int* src = ob + ql * units + s * span;
        int v = src[0];
        for (int u = 1; u < span; ++u) {
          if (grp + u / upg < ng) v = max(v, src[u]);
        }
        atomicMax(sgout + (size_t)(q0 + ql) * nsg + grp / esg, v);
      }
    }
  }
}

// shared bytes of a CTA of nw warps: its staged sketch rows and query rows
// (whole rows, or kSlice-byte slices of them) and the [2][kQBlock][units] maxima
template <int UG>
size_t smem_bytes(int nw, int dbytes, bool sliced) {
  const size_t rows = (size_t)nw * kRowsPerWarp;
  const size_t staged = sliced ? (rows + kQTile) * (kSlice + 16)
                               : (rows + 2 * kQBlock) * (size_t)(dbytes + 16);
  return staged + 2u * kQBlock * (rows / UG) * sizeof(int);
}

template <bool BF16, bool PACK, int UG, bool SLICED>
int launch_form(const void* sk, const void* q, void* out, void* sgout, int npad, int B,
                int dbytes, int group, int esg, int nw, size_t smem, cudaStream_t stream) {
  auto kern = flat_groupmax_kernel<BF16, PACK, UG, SLICED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = nw * kRowsPerWarp;
  const unsigned grid = (unsigned)((npad + rows - 1) / rows);
  kern<<<grid, nw * 32, smem, stream>>>(static_cast<const uint8_t*>(sk),
                                        static_cast<const uint8_t*>(q), static_cast<int*>(out),
                                        static_cast<int*>(sgout), npad, B, dbytes, group, esg);
  return (int)cudaGetLastError();
}

template <bool BF16, bool PACK, int UG>
int launch(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int dbytes,
           int group, int esg, cudaStream_t stream) {
  // whole rows with 8 or 4 warps (512 or 256 rows) per CTA where they fit
  // and hold a group, else D in slices with the most warps that fit
  for (int nw = 8; nw >= 4; nw >>= 1) {
    const size_t smem = smem_bytes<UG>(nw, dbytes, false);
    if (smem <= (size_t)kMaxSmem && nw * kRowsPerWarp >= group)
      return launch_form<BF16, PACK, UG, false>(sk, q, out, sgout, npad, B, dbytes, group, esg,
                                                nw, smem, stream);
  }
  for (int nw = 8; nw >= 1; nw >>= 1) {
    const size_t smem = smem_bytes<UG>(nw, dbytes, true);
    if (smem <= (size_t)kMaxSmem && nw * kRowsPerWarp >= group)
      return launch_form<BF16, PACK, UG, true>(sk, q, out, sgout, npad, B, dbytes, group, esg,
                                               nw, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16, bool PACK>
int dispatch(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int dbytes,
             int group, int esg, cudaStream_t st) {
  switch (group < 64 ? group : 64) {
    case 8: return launch<BF16, PACK, 8>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
    case 16: return launch<BF16, PACK, 16>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
    case 32: return launch<BF16, PACK, 32>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
    default: return launch<BF16, PACK, 64>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  }
}

// ---------------------------------------------------------------------------
// The wgmma form (int8, D <= kWgMaxD); see the head of the file.

constexpr int kWgMaxD = 192;               // widest D: two stages and 128 queries fit
constexpr int kRB = 512;                   // sketch rows per ring stage (one block)
constexpr int kN = 128;                    // sketch rows per wgmma (N)
constexpr int kSubs = kRB / kN;            // subtiles per block
constexpr int kWgStages = 2;               // ring depth: a block serves every query tile
constexpr int kM = 64;                     // queries per wgmma (M)
constexpr int kConsumers = 4;              // consumer warpgroups (one more produces)
constexpr int kWgThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;          // setmaxnreg: the producer gives registers back
constexpr int kConsumerRegs = 104;         // and the consumers take them
constexpr int kBoxRows = 256;              // rows of a sketch TMA box (the TMA maximum)

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// a phase that never completes is a fault: trap (the launch then fails)
// rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  for (unsigned polls = 0;; ++polls) {
    if (polls == (1u << 26)) asm volatile("trap;");
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one 2-D TMA box (x = byte column, y = row) into shared memory; rows past
// the tensor are zero-filled, and the box's bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile in the 32-byte swizzle: rows of one
// 32-byte k-step, 256 bytes (8 rows) between 8-row groups; the tile starts
// on a 256-byte swizzle atom
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A[64 x 32] * B[128 x 32]^T in int8 -> int32; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// max of N registers, as a tree of two-input maxima
template <int N>
__device__ __forceinline__ int max_all(const int (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int M = (N + 1) / 2;
    int w[M];
#pragma unroll
    for (int j = 0; j < M; ++j) w[j] = 2 * j + 1 < N ? max(v[2 * j], v[2 * j + 1]) : v[2 * j];
    return max_all<M>(w);
  }
}

// the epilogue's shape for group width G
template <int G>
struct Span {
  static constexpr int U = G < 64 ? G : 64;                 // columns per reduction unit
  static constexpr int NU = kN / U;                         // units per subtile
  static constexpr int SS = G <= 16 ? 1 : (G == 32 ? 2 : kSubs);   // subtiles per span
  static constexpr int V = G <= 64 ? SS * kN / G : kRB / G; // groups per span
  static constexpr int W = V >= 4 ? V / 4 : 1;              // groups a lane holds
};

// what a consumer thread needs to place its results
struct Site {
  int* out;
  int* sgout;
  int B, ng, nsg, esg_shift;   // esg_shift < 0: no supergroup tier
  int group;                   // G, at run time
  int lane, tig, row;          // the lane, lane % 4, the query row of h = 0 (h = 1: + 8)
};

// pins the accumulators in place: the compiler sees the registers change
// here, so it moves no read of them above a wgmma wait, nor any write of them
// below a product's issue
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// one 128-row subtile: d = query tile * sketch subtile^T over KS 32-byte
// k-steps, as one committed wgmma group. KS is a compile-time constant: a
// branch between the products would make the compiler wait for each one.
template <int KS>
__device__ __forceinline__ void issue_subtile(int (&d)[64], uint64_t da, uint64_t db, int qc) {
  fence_acc(d);
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {   // k-step k is plane k of both tiles
    wgmma_s8(d, da + (uint64_t)((k * qc * 32) >> 4), db + (uint64_t)((k * kRB * 32) >> 4), k);
  }
  wg_commit();
}

// the span is complete: reduce-scatter its group maxima over the quad, then
// store them (and fold the supergroup tier); grp0 is the span's first group
template <int G, bool PACK>
__device__ __forceinline__ void flush_span(int (&span)[2][Span<G>::V], int grp0,
                                           const Site& s) {
  using S = Span<G>;
  constexpr int V = S::V, W = S::W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = span[h][j];
    // lane tig keeps groups [tig * W, tig * W + W) (V >= 4); with V == 2
    // every lane ends with group tig / 2, with V == 1 with group 0
    if constexpr (V >= 2) {
      constexpr int H = V / 2;
      const bool hi = s.tig & 2;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int keep = hi ? v[j + H] : v[j];
        const int send = hi ? v[j] : v[j + H];
        v[j] = max(keep, __shfl_xor_sync(kFull, send, 2));
      }
    } else {
      v[0] = max(v[0], __shfl_xor_sync(kFull, v[0], 2));
    }
    if constexpr (V >= 4) {
      constexpr int H = V / 4;
      const bool hi = s.tig & 1;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int keep = hi ? v[j + H] : v[j];
        const int send = hi ? v[j] : v[j + H];
        v[j] = max(keep, __shfl_xor_sync(kFull, send, 1));
      }
    } else {
      v[0] = max(v[0], __shfl_xor_sync(kFull, v[0], 1));
    }
    const int g0 = grp0 + (V >= 4 ? s.tig * W : (V == 2 ? s.tig >> 1 : 0));
    const bool writer = V >= 4 || (V == 2 ? !(s.tig & 1) : s.tig == 0);
    const int q = s.row + 8 * h;
    const bool row_ok = q < s.B;
    if (writer && row_ok) {
      int* o = s.out + (size_t)q * s.ng + g0;
      int w[W];
#pragma unroll
      for (int j = 0; j < W; ++j) w[j] = PACK ? v[j] : __float_as_int((float)v[j]);
      if (W == 4 && (s.ng & 3) == 0 && g0 + 4 <= s.ng) {
        *reinterpret_cast<int4*>(o) = make_int4(w[0], w[1], w[2], w[3]);
      } else if (W == 2 && (s.ng & 1) == 0 && g0 + 2 <= s.ng) {
        *reinterpret_cast<int2*>(o) = make_int2(w[0], w[1]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (g0 + j < s.ng) o[j] = w[j];
      }
    }
    if constexpr (PACK) {
      if (s.esg_shift >= 0) {   // supergroups of esg groups: within the lane, then the quad
        const int esg = 1 << s.esg_shift;
        constexpr int kMin = -2147483647 - 1;
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (g0 + j >= s.ng) v[j] = kMin;
        int* so = s.sgout + (size_t)q * s.nsg;
        if (V >= 4 && esg <= W) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j & (esg - 1)) continue;
            int m = v[j];
#pragma unroll
            for (int t = 1; j + t < W; ++t)
              if (t < esg) m = max(m, v[j + t]);
            if (row_ok && g0 + j < s.ng) atomicMax(so + ((g0 + j) >> s.esg_shift), m);
          }
        } else {
          // the supergroup spans lanes: W consecutive groups per lane
          // (V >= 4), or one group on lanes 0 and 2 (V == 2)
          int m = v[0];
#pragma unroll
          for (int j = 1; j < W; ++j) m = max(m, v[j]);
          int lanes = 1;
          if constexpr (V >= 4) {
            lanes = min(esg / W, 4);
            if (lanes >= 2) m = max(m, __shfl_xor_sync(kFull, m, 1));
            if (lanes >= 4) m = max(m, __shfl_xor_sync(kFull, m, 2));
          } else if constexpr (V == 2) {
            if (esg >= 2) {
              m = max(m, __shfl_xor_sync(kFull, m, 2));
              lanes = 4;
            }
          }
          if (writer && row_ok && (s.tig & (lanes - 1)) == 0 && g0 < s.ng)
            atomicMax(so + (g0 >> s.esg_shift), m);
        }
      }
    }
  }
}

// the epilogue of subtile SUB of a 512-row block: unit maxima of the
// thread's two rows into the span, and the span's flush when it is complete
template <int G, bool PACK, int SUB>
__device__ __forceinline__ void subtile_epilogue(const int (&acc)[64], int (&span)[2][Span<G>::V],
                                                 int rb, const Site& s) {
  using S = Span<G>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < S::NU; ++u) {
      // acc[4i + 2h + e] is column 8i + 2 tig + e of row h
      constexpr int kVals = S::U / 4;
      int v[kVals];
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int i = u * (S::U / 8) + (j >> 1), e = j & 1;
        const int sc = acc[4 * i + 2 * h + e];
        // the member's offset within the unit; the thread's 2 tig and the
        // unit's place in its group are added after the max. The multiplier
        // G is read at run time, so the key is one IMAD on the FMA pipe
        // rather than a shift-add on the integer pipe that runs the max tree.
        v[j] = PACK ? (int)((unsigned)sc * (unsigned)s.group + (unsigned)(8 * (j >> 1) + e)) : sc;
      }
      int m = max_all<kVals>(v);
      const int col = SUB * kN + u * S::U;   // the unit's first column in the block
      if constexpr (PACK) m += (col & (G - 1)) + 2 * s.tig;
      if constexpr (G > 64) {
        if (col % G) m = max(span[h][col / G], m);
      }
      // a value that outlives the next product passes through a shuffle
      // with the thread's own lane: the compiler cannot recompute it from
      // the accumulators, which that product overwrites (it was seen to)
      if constexpr (SUB % S::SS != S::SS - 1) m = __shfl_sync(kFull, m, s.lane);
      span[h][G <= 64 ? (SUB % S::SS) * S::NU + u : col / G] = m;
    }
  }
  if constexpr (SUB % S::SS == S::SS - 1)
    flush_span<G, PACK>(span, rb * (kRB / G) + (G <= 64 ? (SUB / S::SS) * S::V : 0), s);
}

template <int G, bool PACK, int KS>
__global__ void __launch_bounds__(kWgThreads, 1)
flat_groupmax_wgmma(const __grid_constant__ CUtensorMap sk_map,
                    const __grid_constant__ CUtensorMap q_map, int* __restrict__ out,
                    int* __restrict__ sgout, int npad, int B, int D, int group, int esg,
                    int qc) {
  extern __shared__ __align__(1024) uint8_t wsmem[];
  uint8_t* base = wsmem + ((1024 - (smem_addr(wsmem) & 1023)) & 1023);
  const int stage_bytes = kRB * D;
  uint8_t* qs = base + kWgStages * stage_bytes;                  // [D/32][qc][32], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + (size_t)qc * D);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;
  const int nrb = (npad + kRB - 1) / kRB;
  const int q0 = blockIdx.y * qc;
  const int nmt = (min(qc, B - q0) + kM - 1) / kM;                // query tiles of this chunk
  const int planes = D >> 5;                                      // one per k-step
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);                        // the consumer warps
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {   // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != 128 * kConsumers) return;
    mbar_expect_tx(qbar, (unsigned)(nmt * kM * D));
    for (int p = 0; p < planes; ++p)
      for (int t = 0; t < nmt; ++t)
        tma_load(qs + ((size_t)p * qc + t * kM) * 32, &q_map, p * 32, q0 + t * kM, qbar);
    int st = 0;
    unsigned phase = 0;
    for (int rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
      mbar_wait(&empty[st], phase ^ 1);
      mbar_expect_tx(&full[st], (unsigned)stage_bytes);
      uint8_t* dst = base + st * stage_bytes;
      for (int p = 0; p < planes; ++p)
        for (int h = 0; h < kRB / kBoxRows; ++h)
          tma_load(dst + ((size_t)p * kRB + h * kBoxRows) * 32, &sk_map, p * 32,
                   rb * kRB + h * kBoxRows, &full[st]);
      if (++st == kWgStages) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg takes query tiles wg, wg + 2, ...; warp w of it
  // rows 16w + (lane / 4) and + 8 of a tile. Two accumulator sets: the next
  // subtile's product runs while this one's epilogue does.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  Site site{out, sgout, B, npad / G, esg ? npad / G / esg : 0, esg ? __ffs(esg) - 1 : -1,
            group, lane, lane & 3, 0};
  const int row_in_tile = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  mbar_wait(qbar, 0);
  int st = 0;
  unsigned phase = 0;
  int acc[64];
  int span[2][Span<G>::V];
  for (int rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    mbar_wait(&full[st], phase);
    const uint8_t* stage = base + st * stage_bytes;
    auto da_of = [&](int mt) { return wg_desc(qs + (size_t)mt * kM * 32); };
    auto db_of = [&](int sub) { return wg_desc(stage + (size_t)sub * kN * 32); };
    for (int mt = wg; mt < nmt; mt += kConsumers) {
      const uint64_t da = da_of(mt);
      site.row = q0 + mt * kM + row_in_tile;
#define RDF_SUBTILE(SUB)                                      \
      issue_subtile<KS>(acc, da, db_of(SUB), qc);             \
      wg_wait<0>();                                           \
      fence_acc(acc);                                         \
      subtile_epilogue<G, PACK, SUB>(acc, span, rb, site);
      RDF_SUBTILE(0)
      RDF_SUBTILE(1)
      RDF_SUBTILE(2)
      RDF_SUBTILE(3)
#undef RDF_SUBTILE
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == kWgStages) {
      st = 0;
      phase ^= 1;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, reached through the runtime so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D map of an int8 [rows, D] matrix in boxes of 32 bytes x box_rows,
// written to shared memory in the 32-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

size_t wg_smem(int D, int qc) {
  return 1024 + (size_t)kWgStages * kRB * D + (size_t)qc * D + (2 * kWgStages + 1) * 8;
}

template <int G, bool PACK>
int launch_wgmma(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                 int esg, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // query chunks: as few as shared memory allows, more while the sketch has
  // fewer blocks than the card has SMs (each chunk keeps at least 128 queries)
  const long long qc_max =
      ((long long)kMaxSmem - (long long)wg_smem(D, 0)) / D / kM * kM;
  if (qc_max < kM) return (int)cudaErrorInvalidValue;
  const int nrb = (npad + kRB - 1) / kRB;
  int nch = (int)((B + qc_max - 1) / qc_max);
  nch = max(nch, min((B + 127) / 128, sms / nrb));
  const int qc = ((B + nch - 1) / nch + kM - 1) / kM * kM;
  nch = (B + qc - 1) / qc;
  const int gx = min(nrb, max(1, sms / nch));
  CUtensorMap sk_map, q_map;
  if (!make_map(&sk_map, sk, npad, D, kBoxRows) || !make_map(&q_map, q, B, D, kM))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem(D, qc);
  void (*kern)(CUtensorMap, CUtensorMap, int*, int*, int, int, int, int, int, int) = nullptr;
  switch (D >> 5) {   // k-steps: the widths the wgmma form takes
    case 1: kern = flat_groupmax_wgmma<G, PACK, 1>; break;
    case 2: kern = flat_groupmax_wgmma<G, PACK, 2>; break;
    case 3: kern = flat_groupmax_wgmma<G, PACK, 3>; break;
    case 4: kern = flat_groupmax_wgmma<G, PACK, 4>; break;
    case 5: kern = flat_groupmax_wgmma<G, PACK, 5>; break;
    case 6: kern = flat_groupmax_wgmma<G, PACK, 6>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(gx, nch), kWgThreads, smem, stream>>>(sk_map, q_map, static_cast<int*>(out),
                                                    static_cast<int*>(sgout), npad, B, D, G,
                                                    esg, qc);
  return (int)cudaGetLastError();
}

template <bool PACK>
int dispatch_wgmma(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                   int group, int esg, cudaStream_t st) {
  switch (group) {
    case 8: return launch_wgmma<8, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 16: return launch_wgmma<16, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 32: return launch_wgmma<32, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 64: return launch_wgmma<64, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 128: return launch_wgmma<128, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 256: return launch_wgmma<256, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    case 512: return launch_wgmma<512, PACK>(sk, q, out, sgout, npad, B, D, esg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sketch [npad, D] and q [B, D], both int8 (bf16 = 0) or both bf16 (bf16 =
// 1), contiguous and 16-byte aligned, D any multiple of 32; out [B, npad/group]
// i32 (pack) or f32; sgout [B, npad/group/esg] i32, filled with INT32_MIN by
// the caller, when esg > 0 (pack only), else null. group is a power of two
// in [8, 512] dividing npad; esg a power of two dividing npad/group. With
// pack, the caller guarantees D*127^2*group < 2^31. Launches on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int rdf_flat_groupmax(const void* sk, const void* q, void* out, void* sgout, int npad,
                                 int B, int D, int bf16, int group, int pack, int esg,
                                 void* stream) {
  if (npad == 0 || B == 0) return 0;
  if (group < 8 || group > 512 || (group & (group - 1)) || npad % group || D <= 0 || D % 32 ||
      (pack && bf16) || (esg && (!pack || (esg & (esg - 1)) || (npad / group) % esg)))
    return (int)cudaErrorInvalidValue;
  const int dbytes = bf16 ? 2 * D : D;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!bf16 && D <= kWgMaxD) {   // the wgmma form; by shape, never as a fallback
    if (pack) return dispatch_wgmma<true>(sk, q, out, sgout, npad, B, D, group, esg, st);
    return dispatch_wgmma<false>(sk, q, out, sgout, npad, B, D, group, esg, st);
  }
  if (bf16) return dispatch<true, false>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  if (pack) return dispatch<false, true>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  return dispatch<false, false>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
}
