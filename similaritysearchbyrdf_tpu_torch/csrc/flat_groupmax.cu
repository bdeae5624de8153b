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
// Design: the product runs on the tensor cores through mma.sync
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
// The TPU kernels' strided (halved) sketch copy, nsub pipelining, in-kernel
// transpose and lane-reduction variant were Mosaic layout tactics and have
// no counterpart.
//
// Bound: operations. At the Deep-8M shape (Npad 8,003,584, D 96, B 1024,
// int8) a call does 1.57e12 int8 operations (0.80 ms at 1,979 TOPS) and
// moves 768 MB of sketch and 512 MB of output (0.38 ms at 3.35 TB/s).
// mma.sync reaches only part of the wgmma peak, and at D 96 each score
// takes 3 mma steps against a fixed epilogue per score; wgmma, TMA and a
// persistent grid are left for a later tuning pass.

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
  if (bf16) return dispatch<true, false>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  if (pack) return dispatch<false, true>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  return dispatch<false, false>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
}
