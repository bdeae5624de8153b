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
// moves 768 MB of sketch and 512 MB of output (0.38 ms at 3.35 TB/s); at
// the sparse flat engine's (Npad 1,007,616, D 4096, B 1024) 8.45e12
// operations (4.27 ms) against 4.2 GB of sketch (1.26 ms); with a bf16
// sketch at Deep-8M 1.57e12 bf16 operations (1.59 ms at 989 TFLOPS) against
// 1.54 GB of sketch and 512 MB of output (0.61 ms).
//
// Two forms, chosen by the bytes of a row in `rdf_flat_groupmax`. Both take
// either type: a wgmma k-step is 32 bytes in both (32 int8 values, 16 bf16),
// so the geometry below is in bytes and a bf16 row of D values is an int8 row
// of 2D bytes. int8 runs m64nNk32 s8 products into s32 accumulators, bf16
// m64nNk16 bf16 products into f32 accumulators (the same registers, laid out
// alike); the epilogue's maxima are integer or f32 maxima, and bf16 never
// packs.
//
// The wgmma form (rows up to kWgMaxD = 192 bytes: int8 D 192, bf16 D 96). A
// persistent grid, one CTA per SM, of five warpgroups: four consumers and a
// producer. Each CTA keeps a chunk of up to qc queries resident in shared
// memory (all 1,024 at int8 D 96) and walks every gridDim.x-th 512-row
// sketch block (256 rows for bf16, below); one producer thread keeps the
// next block in flight by TMA through a two-stage mbarrier ring, so the
// sketch is read from memory once per query chunk and the query batch once
// per CTA. Both operands land in wgmma's 32-byte swizzle: one
// TMA box of 32 bytes x 256 rows per k-step, a tile stored as [D/32][rows]
// [32] planes (descriptor: swizzle 32B, 256 bytes between 8-row groups).
// A consumer warpgroup scores 64 queries (the M operand) against a block's
// rows in 128-row subtiles, each D/32 (bytes) m64n128 wgmma products
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
// The K-looped form (rows past kWgMaxD bytes): a GEMM with the wgmma form's
// epilogue. Its tile is 128 queries (M) x 256 sketch rows (N), held by two
// consumer warpgroups of 64 queries x 256 rows each: 128 s32 or f32 accumulators
// a thread (setmaxnreg gives the consumers 232 registers, the producer 40),
// which stay in registers across the whole D loop, so each sketch byte is
// staged once per 128 queries. One producer thread brings 128-byte D-slabs
// of both operands by TMA, in wgmma's 128-byte swizzle (descriptor: swizzle
// 128B, 1024 bytes between 8-row groups; a k-step is 32 bytes further into
// the swizzled row), through a 4-stage mbarrier ring; the consumers run
// four m64n256 products (k32 s8 or k16 bf16) on each slab as it lands and keep one slab's
// products in flight while they wait for the next, so copies overlap
// products. A persistent grid of one CTA per SM walks the tiles row block
// first: the query tiles of one 256-row block run on concurrent CTAs, so
// the sketch comes from HBM about once and its re-reads (one per 128
// queries) from L2, as the JAX kernel's docstring asks of its grid
// (`ops/pallas/flat_groupmax.py:15-19`). The epilogue is the wgmma form's:
// a max over registers and a quad exchange per group, keys by one IMAD,
// the supergroup tier by order-free atomicMax, query-major stores. G 512
// is wider than a consumer's 256 rows: there the two consumers take the
// same 64 queries against the two halves of a 512-row tile, and fold their
// group maxima through shared memory (a 3-stage ring of 72 KB stages).
// Any D that is a multiple of 32 works: TMA zero-fills the last slab past
// D, and rows past B or Npad. Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit (timing.py K4_sparse_1m, 5 pairs against the sliced
// mma.sync form it replaced, in one call: B 1024 x 1,007,616 x 4096, G 64,
// unpacked): 4.93-5.08 ms device, 84-87% of the 4.27 ms bound, from
// 45.7-46.0; cuBLAS's int8 product alone (`torch._int_mm`) takes 9.2-9.5
// ms on the same operands. The sketch's re-reads (one per 128 queries,
// about 47 GB a call) come from L2 and did not bound it, so no cluster
// multicast was added.
//
// bf16 at D 96 (192-byte rows) runs the wgmma form in blocks of 256 rows
// (wg_block): two stages of 512 such rows left room for 128 resident
// queries only, two of the four consumers idle and the sketch read once per
// 128 queries (3.91 ms of device time at Deep-8M); blocks of 256 hold 512
// queries. Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (timing.py K4_bf16_8m, 5 pairs in one call: B 1024 x 8,003,584 x 96, G
// 64): 2.084-2.103 ms device, 76% of the 1.59 ms bound, where the mma.sync
// m16n8k16 form it replaced took 6.520-6.566.
//
// The TPU kernels' strided (halved) sketch copy, nsub pipelining, in-kernel
// transpose and lane-reduction variant were Mosaic layout tactics and have
// no counterpart.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;           // 227 KB a block can opt into

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// The wgmma form (rows of at most kWgMaxD bytes); see the head of the file.

constexpr int kWgMaxD = 192;               // widest row in bytes (int8 D; bf16 D 96): two
                                           // stages and 128 queries fit
constexpr int kRB = 512;                   // sketch rows per ring stage (one block); bf16
                                           // at G <= 256 takes blocks of 256 (wg_block)
constexpr int kN = 128;                    // sketch rows per wgmma (N)
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

// d (+)= A[64 x 16] * B[128 x 16]^T in bf16 -> f32, both K-major (one 32-byte
// k-step, as wgmma_s8's); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// one 32-byte k-step of either type
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_s8(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_k32(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16(d, da, db, scale_d);
}

// the larger of two scores or keys (int8) or two f32 scores (bf16)
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

// the word a group maximum is stored as: the key (PACK), or the score as an
// f32 (an int8 sum converted, a bf16 sum's zero made +0, as int8's is)
template <bool PACK>
__device__ __forceinline__ int out_word(int v) {
  return PACK ? v : __float_as_int((float)v);
}
template <bool PACK>
__device__ __forceinline__ int out_word(float v) {
  return __float_as_int(v + 0.f);
}

// max of N registers, as a tree of two-input maxima
template <int N, typename T>
__device__ __forceinline__ T max_all(const T (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int M = (N + 1) / 2;
    T w[M];
#pragma unroll
    for (int j = 0; j < M; ++j) w[j] = 2 * j + 1 < N ? vmax(v[2 * j], v[2 * j + 1]) : v[2 * j];
    return max_all<M>(w);
  }
}

// the epilogue's shape for group width G in blocks of RB rows
template <int G, int RB>
struct Span {
  static constexpr int U = G < 64 ? G : 64;                 // columns per reduction unit
  static constexpr int NU = kN / U;                         // units per subtile
  static constexpr int SS = G <= 16 ? 1 : (G == 32 ? 2 : RB / kN);   // subtiles per span
  static constexpr int V = G <= 64 ? SS * kN / G : RB / G;  // groups per span
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
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one 128-row subtile: d = query tile * sketch subtile^T over KS 32-byte
// k-steps, as one committed wgmma group (s32 accumulators for int8, f32 for
// bf16). KS is a compile-time constant: a branch between the products would
// make the compiler wait for each one.
template <int KS, int RB, typename T>
__device__ __forceinline__ void issue_subtile(T (&d)[64], uint64_t da, uint64_t db, int qc) {
  fence_acc(d);
  wg_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {   // k-step k is plane k of both tiles
    wgmma_k32(d, da + (uint64_t)((k * qc * 32) >> 4), db + (uint64_t)((k * RB * 32) >> 4), k);
  }
  wg_commit();
}

// a span of V consecutive groups is complete: reduce-scatter its group
// maxima over the quad, then store them (and fold the supergroup tier);
// grp0 is the span's first group. Both wgmma forms end in it.
template <int V, bool PACK, typename T>
__device__ __forceinline__ void flush_span(T (&span)[2][V], int grp0, const Site& s) {
  constexpr int W = V >= 4 ? V / 4 : 1;                     // groups a lane holds
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = span[h][j];
    // lane tig keeps groups [tig * W, tig * W + W) (V >= 4); with V == 2
    // every lane ends with group tig / 2, with V == 1 with group 0
    if constexpr (V >= 2) {
      constexpr int H = V / 2;
      const bool hi = s.tig & 2;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const T keep = hi ? v[j + H] : v[j];
        const T send = hi ? v[j] : v[j + H];
        v[j] = vmax(keep, __shfl_xor_sync(kFull, send, 2));
      }
    } else {
      v[0] = vmax(v[0], __shfl_xor_sync(kFull, v[0], 2));
    }
    if constexpr (V >= 4) {
      constexpr int H = V / 4;
      const bool hi = s.tig & 1;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const T keep = hi ? v[j + H] : v[j];
        const T send = hi ? v[j] : v[j + H];
        v[j] = vmax(keep, __shfl_xor_sync(kFull, send, 1));
      }
    } else {
      v[0] = vmax(v[0], __shfl_xor_sync(kFull, v[0], 1));
    }
    const int g0 = grp0 + (V >= 4 ? s.tig * W : (V == 2 ? s.tig >> 1 : 0));
    const bool writer = V >= 4 || (V == 2 ? !(s.tig & 1) : s.tig == 0);
    const int q = s.row + 8 * h;
    const bool row_ok = q < s.B;
    if (writer && row_ok) {
      int* o = s.out + (size_t)q * s.ng + g0;
      int w[W];
#pragma unroll
      for (int j = 0; j < W; ++j) w[j] = out_word<PACK>(v[j]);
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

// the epilogue of subtile SUB of an RB-row block: unit maxima of the
// thread's two rows into the span, and the span's flush when it is complete
template <int G, bool PACK, int SUB, int RB, typename T>
__device__ __forceinline__ void subtile_epilogue(const T (&acc)[64], T (&span)[2][Span<G, RB>::V],
                                                 int rb, const Site& s) {
  using S = Span<G, RB>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < S::NU; ++u) {
      // acc[4i + 2h + e] is column 8i + 2 tig + e of row h
      constexpr int kVals = S::U / 4;
      T v[kVals];
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int i = u * (S::U / 8) + (j >> 1), e = j & 1;
        const T sc = acc[4 * i + 2 * h + e];
        // the member's offset within the unit; the thread's 2 tig and the
        // unit's place in its group are added after the max. The multiplier
        // G is read at run time, so the key is one IMAD on the FMA pipe
        // rather than a shift-add on the integer pipe that runs the max tree.
        if constexpr (PACK)
          v[j] = (int)((unsigned)sc * (unsigned)s.group + (unsigned)(8 * (j >> 1) + e));
        else
          v[j] = sc;
      }
      T m = max_all<kVals>(v);
      const int col = SUB * kN + u * S::U;   // the unit's first column in the block
      if constexpr (PACK) m += (col & (G - 1)) + 2 * s.tig;
      if constexpr (G > 64) {
        if (col % G) m = vmax(span[h][col / G], m);
      }
      // a value that outlives the next product passes through a shuffle
      // with the thread's own lane: the compiler cannot recompute it from
      // the accumulators, which that product overwrites (it was seen to)
      if constexpr (SUB % S::SS != S::SS - 1) m = __shfl_sync(kFull, m, s.lane);
      span[h][G <= 64 ? (SUB % S::SS) * S::NU + u : col / G] = m;
    }
  }
  if constexpr (SUB % S::SS == S::SS - 1)
    flush_span<S::V, PACK>(span, rb * (RB / G) + (G <= 64 ? (SUB / S::SS) * S::V : 0), s);
}

// D is the bytes of a row: its int8 or bf16 values as bytes; T the
// accumulator type (int for int8, float for bf16); RB the rows of a block
template <int G, bool PACK, int KS, typename T, int RB>
__global__ void __launch_bounds__(kWgThreads, 1)
flat_groupmax_wgmma(const __grid_constant__ CUtensorMap sk_map,
                    const __grid_constant__ CUtensorMap q_map, int* __restrict__ out,
                    int* __restrict__ sgout, int npad, int B, int D, int group, int esg,
                    int qc) {
  extern __shared__ __align__(1024) uint8_t wsmem[];
  uint8_t* base = wsmem + ((1024 - (smem_addr(wsmem) & 1023)) & 1023);
  const int stage_bytes = RB * D;
  uint8_t* qs = base + kWgStages * stage_bytes;                  // [D/32][qc][32], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + (size_t)qc * D);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;
  const int nrb = (npad + RB - 1) / RB;
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
        for (int h = 0; h < RB / kBoxRows; ++h)
          tma_load(dst + ((size_t)p * RB + h * kBoxRows) * 32, &sk_map, p * 32,
                   rb * RB + h * kBoxRows, &full[st]);
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
  T acc[64];
  T span[2][Span<G, RB>::V];
  for (int rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    mbar_wait(&full[st], phase);
    const uint8_t* stage = base + st * stage_bytes;
    auto da_of = [&](int mt) { return wg_desc(qs + (size_t)mt * kM * 32); };
    auto db_of = [&](int sub) { return wg_desc(stage + (size_t)sub * kN * 32); };
    for (int mt = wg; mt < nmt; mt += kConsumers) {
      const uint64_t da = da_of(mt);
      site.row = q0 + mt * kM + row_in_tile;
#define RDF_SUBTILE(SUB)                                      \
      issue_subtile<KS, RB>(acc, da, db_of(SUB), qc);         \
      wg_wait<0>();                                           \
      fence_acc(acc);                                         \
      subtile_epilogue<G, PACK, SUB, RB>(acc, span, rb, site);
      RDF_SUBTILE(0)
      RDF_SUBTILE(1)
      if constexpr (RB == 512) {
        RDF_SUBTILE(2)
        RDF_SUBTILE(3)
      }
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

// a 2-D map of an int8 [rows, D] matrix in boxes of box_cols bytes x
// box_rows, written to shared memory in the 32-byte swizzle (box_cols 32,
// the wgmma form) or the 128-byte swizzle (box_cols 128, the K-looped form)
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int D, int box_cols,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

size_t wg_smem(int D, int qc, int rb) {
  return 1024 + (size_t)kWgStages * rb * D + (size_t)qc * D + (2 * kWgStages + 1) * 8;
}

// rows of the wgmma form's blocks: 512, or 256 for bf16 up to G 256. A bf16
// row of D 96 is 192 bytes, and two stages of 512 such rows leave room for
// 128 resident queries only: two of the four consumers then score, and the
// sketch is read once per 128 queries. Blocks of 256 rows hold 512 queries
// (all four consumers busy, the sketch read twice for 1,024 queries); G 512
// needs a 512-row block for its span.
template <bool BF16, int G>
constexpr int wg_block() {
  return BF16 && G <= 256 ? 256 : kRB;
}

// D: bytes of a row; BF16: bf16 values (unpacked), else int8
template <int G, bool PACK, bool BF16>
int launch_wgmma(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                 int esg, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // query chunks: as few as shared memory allows, more while the sketch has
  // fewer blocks than the card has SMs (each chunk keeps at least 128 queries)
  constexpr int RB = wg_block<BF16, G>();
  const long long qc_max =
      ((long long)kMaxSmem - (long long)wg_smem(D, 0, RB)) / D / kM * kM;
  if (qc_max < kM) return (int)cudaErrorInvalidValue;
  const int nrb = (npad + RB - 1) / RB;
  int nch = (int)((B + qc_max - 1) / qc_max);
  nch = max(nch, min((B + 127) / 128, sms / nrb));
  const int qc = ((B + nch - 1) / nch + kM - 1) / kM * kM;
  nch = (B + qc - 1) / qc;
  const int gx = min(nrb, max(1, sms / nch));
  CUtensorMap sk_map, q_map;
  if (!make_map(&sk_map, sk, npad, D, 32, kBoxRows) || !make_map(&q_map, q, B, D, 32, kM))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem(D, qc, RB);
  using Acc = std::conditional_t<BF16, float, int>;
  void (*kern)(CUtensorMap, CUtensorMap, int*, int*, int, int, int, int, int, int) = nullptr;
  // k-steps: the widths the wgmma form takes (bf16 rows are a multiple of 64 bytes)
#define RDF_KS(KS)                                                   \
  case KS:                                                           \
    if constexpr (!BF16 || KS % 2 == 0) kern = flat_groupmax_wgmma<G, PACK, KS, Acc, RB>; \
    break;
  switch (D >> 5) {
    RDF_KS(1) RDF_KS(2) RDF_KS(3) RDF_KS(4) RDF_KS(5) RDF_KS(6)
    default: break;
  }
#undef RDF_KS
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(gx, nch), kWgThreads, smem, stream>>>(sk_map, q_map, static_cast<int*>(out),
                                                    static_cast<int*>(sgout), npad, B, D, G,
                                                    esg, qc);
  return (int)cudaGetLastError();
}

template <bool PACK, bool BF16>
int dispatch_wgmma(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                   int group, int esg, cudaStream_t st) {
  switch (group) {
    case 8: return launch_wgmma<8, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 16: return launch_wgmma<16, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 32: return launch_wgmma<32, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 64: return launch_wgmma<64, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 128: return launch_wgmma<128, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 256: return launch_wgmma<256, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 512: return launch_wgmma<512, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The K-looped form (int8, D past kWgMaxD); see the head of the file.

constexpr int kKlSlab = 128;               // bytes of D per ring stage: one 128-byte swizzle row
constexpr int kKlN = 256;                  // sketch rows per consumer (wgmma N)
constexpr int kKlThreads = 3 * 128;        // two consumer warpgroups and a producer
constexpr int kKlProducerRegs = 40;        // setmaxnreg: the producer gives registers back
constexpr int kKlConsumerRegs = 232;       // and the consumers take them (128 accumulators)

// RT = 1 (G up to 256): the consumers take 64 queries each of a 128-query
// tile, against the same 256 rows. RT = 2 (G 512): both take the tile's 64
// queries, against the two 256-row halves of a 512-row tile, and fold.
template <int RT>
struct KlTile {
  static constexpr int kQ = 128 / RT;                        // queries per tile
  static constexpr int kR = kKlN * RT;                       // sketch rows per tile
  static constexpr int kStageBytes = (kR + kQ) * kKlSlab;    // sketch rows, then queries
  static constexpr int kStages = RT == 1 ? 4 : 3;
  static constexpr int kFoldInts = RT == 1 ? 0 : 2 * 2 * 128;   // [tile parity][h][thread]
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  kFoldInts * sizeof(int) + 2 * kStages * sizeof(uint64_t);
};

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 1024 bytes (8 rows) between 8-row groups; the tile starts on a
// 1024-byte swizzle atom, and k-step k starts 32k bytes into its rows
__device__ __forceinline__ uint64_t kl_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A[64 x 32] * B[256 x 32]^T in int8 -> int32; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] * B[256 x 16]^T in bf16 -> f32, both K-major (one
// 32-byte k-step, as wgmma_s8_n256's); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// one 32-byte k-step of either type
__device__ __forceinline__ void wgmma_k32_n256(int (&d)[128], uint64_t da, uint64_t db,
                                               int scale_d) {
  wgmma_s8_n256(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_k32_n256(float (&d)[128], uint64_t da, uint64_t db,
                                               int scale_d) {
  wgmma_bf16_n256(d, da, db, scale_d);
}

// the two consumer warpgroups meet (named barrier 1; the producer is not in it)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// the epilogue's shape for group width G over spans of SW columns
template <int G, int SW>
struct KlSpan {
  static constexpr int U = G < 64 ? G : 64;          // columns per reduction unit
  static constexpr int V = SW >= G ? SW / G : 1;     // groups (or one group's part) per span
  static constexpr int NU = SW / U;                  // units per span
};

// span SP of a consumer's 256 rows: the group maxima (keys, with PACK) of
// the thread's two query rows; col0 is the rows' offset in their group when
// G is wider than 256 rows (else 0)
template <int G, bool PACK, int SW, int SP, typename Acc>
__device__ __forceinline__ void kl_span_max(const Acc (&acc)[128],
                                            Acc (&span)[2][KlSpan<G, SW>::V], int col0,
                                            const Site& s) {
  using S = KlSpan<G, SW>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < S::NU; ++u) {
      // acc[4i + 2h + e] is column 8i + 2 tig + e of row h
      constexpr int kVals = S::U / 4;
      Acc v[kVals];
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int i = (SP * SW + u * S::U) / 8 + (j >> 1), e = j & 1;
        const Acc sc = acc[4 * i + 2 * h + e];
        // as in subtile_epilogue: one IMAD by the run-time G, the member's
        // offset within the unit; the rest of the offset after the max
        if constexpr (PACK)
          v[j] = (int)((unsigned)sc * (unsigned)s.group + (unsigned)(8 * (j >> 1) + e));
        else
          v[j] = sc;
      }
      Acc m = max_all<kVals>(v);
      const int col = col0 + SP * SW + u * S::U;   // the unit's first row in the tile
      if constexpr (PACK) m += (col & (G - 1)) + 2 * s.tig;
      const int slot = (u * S::U) / G;
      if constexpr (S::U < G) {   // several units per group: fold into the group's slot
        if ((u * S::U) % (G < SW ? G : SW) != 0) m = vmax(span[h][slot], m);
      }
      span[h][slot] = m;
    }
  }
}

// D is the bytes of a row; Acc the accumulator type (int for int8, float
// for bf16)
template <int G, bool PACK, typename Acc>
__global__ void __launch_bounds__(kKlThreads, 1)
flat_groupmax_kloop(const __grid_constant__ CUtensorMap sk_map,
                    const __grid_constant__ CUtensorMap q_map, int* __restrict__ out,
                    int* __restrict__ sgout, int npad, int B, int D, int group, int esg) {
  constexpr int RT = G > kKlN ? 2 : 1;
  using T = KlTile<RT>;
  constexpr int SW = G <= 16 ? 128 : kKlN;           // columns per span: at least 8 groups
  constexpr int V = KlSpan<G, SW>::V;
  extern __shared__ __align__(1024) uint8_t ksmem[];
  uint8_t* base = ksmem + ((1024 - (smem_addr(ksmem) & 1023)) & 1023);
  Acc* fold = reinterpret_cast<Acc*>(base + (size_t)T::kStages * T::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(fold + T::kFoldInts);
  uint64_t* empty = full + T::kStages;
  const int mt = (B + T::kQ - 1) / T::kQ;
  const int tiles = mt * ((npad + T::kR - 1) / T::kR);
  const int slabs = (D + kKlSlab - 1) / kKlSlab;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                          // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {   // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kKlProducerRegs));
    if (threadIdx.x != 256) return;
    int st = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n = tile / mt, m = tile - n * mt;       // row block first
      for (int sl = 0; sl < slabs; ++sl) {
        mbar_wait(&empty[st], phase ^ 1);
        mbar_expect_tx(&full[st], (unsigned)T::kStageBytes);
        uint8_t* dst = base + (size_t)st * T::kStageBytes;
#pragma unroll
        for (int h = 0; h < RT; ++h)
          tma_load(dst + h * kKlN * kKlSlab, &sk_map, sl * kKlSlab, n * T::kR + h * kKlN,
                   &full[st]);
        tma_load(dst + T::kR * kKlSlab, &q_map, sl * kKlSlab, m * T::kQ, &full[st]);
        if (++st == T::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg scores 64 queries x 256 rows of each tile; warp
  // w of it rows 16w + (lane / 4) and + 8 of its queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kKlConsumerRegs));
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  Site site{out, sgout, B, npad / G, esg ? npad / G / esg : 0, esg ? __ffs(esg) - 1 : -1,
            group, lane, lane & 3, 0};
  const int row_in_wg = (tid >> 5) * 16 + (lane >> 2);
  const int a_off = (T::kR + (RT == 1 ? wg * 64 : 0)) * kKlSlab;   // this warpgroup's queries
  const int b_off = RT == 1 ? 0 : wg * kKlN * kKlSlab;              // and sketch rows
  int st = 0;
  unsigned phase = 0;
  int parity = 0;                                       // of the fold buffer (RT = 2)
  Acc acc[128];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / mt, m = tile - n * mt;
    int prev = 0;
    for (int sl = 0; sl < slabs; ++sl) {
      mbar_wait(&full[st], phase);
      const uint8_t* stage = base + (size_t)st * T::kStageBytes;
      const uint64_t da = kl_desc(stage + a_off), db = kl_desc(stage + b_off);
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kKlSlab / 32; ++k)   // k-step k: 32k bytes into the swizzled rows
        wgmma_k32_n256(acc, da + 2 * k, db + 2 * k, (sl > 0 || k > 0) ? 1 : 0);
      wg_commit();
      wg_wait<1>();                                     // the previous slab's products are done
      if (sl > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = st;
      if (++st == T::kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    site.row = m * T::kQ + (RT == 1 ? wg * 64 : 0) + row_in_wg;
    Acc span[2][V];
    if constexpr (RT == 1) {
      kl_span_max<G, PACK, SW, 0>(acc, span, 0, site);
      flush_span<V, PACK>(span, n * (kKlN / G), site);
      if constexpr (SW < kKlN) {
        kl_span_max<G, PACK, SW, 1>(acc, span, 0, site);
        flush_span<V, PACK>(span, n * (kKlN / G) + SW / G, site);
      }
    } else {
      // each consumer holds its 256 rows' part of the 512-row group; the
      // second hands its maxima to the first through shared memory
      kl_span_max<G, PACK, SW, 0>(acc, span, wg * kKlN, site);
      Acc* f = fold + parity * 256;
      if (wg == 1) {
        f[tid] = span[0][0];
        f[128 + tid] = span[1][0];
      }
      consumers_sync();
      parity ^= 1;
      if (wg == 0) {
        span[0][0] = vmax(span[0][0], f[tid]);
        span[1][0] = vmax(span[1][0], f[128 + tid]);
        flush_span<V, PACK>(span, n, site);
      }
    }
  }
}

// D: bytes of a row; BF16: bf16 values (unpacked), else int8
template <int G, bool PACK, bool BF16>
int launch_kloop(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                 int esg, cudaStream_t stream) {
  using T = KlTile<(G > kKlN ? 2 : 1)>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap sk_map, q_map;
  if (!make_map(&sk_map, sk, npad, D, kKlSlab, kKlN) ||
      !make_map(&q_map, q, B, D, kKlSlab, T::kQ))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((B + T::kQ - 1) / T::kQ) * ((npad + T::kR - 1) / T::kR);
  auto kern = flat_groupmax_kloop<G, PACK, std::conditional_t<BF16, float, int>>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(tiles < sms ? tiles : sms), kKlThreads, T::kSmem, stream>>>(
      sk_map, q_map, static_cast<int*>(out), static_cast<int*>(sgout), npad, B, D, G, esg);
  return (int)cudaGetLastError();
}

template <bool PACK, bool BF16>
int dispatch_kloop(const void* sk, const void* q, void* out, void* sgout, int npad, int B, int D,
                   int group, int esg, cudaStream_t st) {
  switch (group) {
    case 8: return launch_kloop<8, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 16: return launch_kloop<16, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 32: return launch_kloop<32, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 64: return launch_kloop<64, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 128: return launch_kloop<128, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 256: return launch_kloop<256, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
    case 512: return launch_kloop<512, PACK, BF16>(sk, q, out, sgout, npad, B, D, esg, st);
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
  const cudaStream_t st = (cudaStream_t)stream;
  // the form by shape, never as a fallback: rows of at most kWgMaxD bytes
  // take the wgmma form, wider ones the K-looped form, both types alike
  const int dbytes = bf16 ? 2 * D : D;
  if (dbytes <= kWgMaxD) {
    if (bf16) return dispatch_wgmma<false, true>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
    if (pack) return dispatch_wgmma<true, false>(sk, q, out, sgout, npad, B, D, group, esg, st);
    return dispatch_wgmma<false, false>(sk, q, out, sgout, npad, B, D, group, esg, st);
  }
  if (bf16) return dispatch_kloop<false, true>(sk, q, out, sgout, npad, B, dbytes, group, esg, st);
  if (pack) return dispatch_kloop<true, false>(sk, q, out, sgout, npad, B, D, group, esg, st);
  return dispatch_kloop<false, false>(sk, q, out, sgout, npad, B, D, group, esg, st);
}
