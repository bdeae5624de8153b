// Top-k select over rows of packed keys or of f32 scores, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package selects with full `lax.sort`s,
// which the port first mirrored as `torch.sort` (the forest's folded path,
// `index/forest.py` `_query_groupmax` and `_stage2`; every stable select of
// `ops/rerank.top_sorted`), where most of what a sort writes is thrown
// away. For each row b of in[B, n] the key forms write out[b, 0:kout] = the
// kout smallest keys of the row in ascending order, or the kout largest in
// descending order: torch.sort(in, dim=1, descending)[0][:, :kout], bit for
// bit. Keys are int32 or int64. Equal keys are equal bits, so which copies
// are taken does not matter and ties need no rule. With `pack` (int32
// only) the key of column c is built from the row's value v as the
// forest's one-operand group select packs it:
//   key = (clamp(v >> sh, lo, hi) << bits_w) | c,
//   lo = -2^(31 - bits_w), hi = 2^(31 - bits_w) - 1,
// so the caller's int64 pack never reaches device memory.
//
// The f32 form (`rdf_topk_select_f32`) writes a stable descending sort's
// prefix of f32 scores: out_s[b, 0:kout] and out_i[b, 0:kout] (int64)
// equal torch.sort(in, dim=1, descending=True, stable=True) cut to kout
// columns, bit for bit. Ties keep index order (-0.0 and +0.0 tie), -inf
// goes last, and a value keeps its input bits. A NaN goes where the card's
// sort puts it, at every width: without the sign bit first (above +inf),
// with it last (below -inf), each by its bits. Its key is the unique 64-bit
//   (ord(v) << 32) | (2^32 - 1 - c),
// ord the order-preserving image of the f32 bits with -0.0 taken as +0.0;
// the kernel never builds it in memory. The row holds
// only the 32-bit order image of each value (the complement of ord, so
// the wanted keys are the smallest), the column is known from position,
// and the select runs over the virtual key (order << 32) | c with the same
// radix passes as the int64 form: the value's four digits, then the
// column's only for the keys still tied at the threshold, and only the
// digits a column of this row can have. The winners' 64-bit keys are
// compacted and sorted as the int64 form's; each writes its column and
// the value read back from the input row. Its kernel is a copy of the key
// forms' select, not a second use of it, so that their compiled code stays
// as it was.
//
// Bound: bytes. The least the work needs is one read of each row and one
// write of kout keys: at the folded Deep cell's chunk, 128 x 32,768 int32
// in and 128 x 1,792 out (17.7 MB, 5.3 us at 3.35 TB/s) for the group
// select, 128 x 14,336 int64 in and 128 x 4,096 out (18.9 MB, 5.6 us) for
// stage2. The cub segmented radix sort it replaces makes several digit
// passes over keys and an int64 payload through device memory, one block a
// segment.
//
// Design: one block of 1,024 threads a row. The row (128 KB and 112 KB at
// those shapes) is read once, by 16-byte loads, into shared memory as
// order keys: the bits XOR a mask that makes the wanted keys the smallest
// unsigned values. A radix select on chip then finds the kout-th key, most
// significant 8-bit digit first (4 passes for int32, 8 for int64, fewer
// when a digit's bin holds exactly the keys still wanted): each pass
// counts the digits of the keys still matching the prefix into a
// 256-bin histogram a warp (one shared atomic a lane, or one a warp where
// its keys share the digit; `__match_any_sync` cost several times more on
// spread digits), and one warp scans their sums. Once the keys still
// matching fit the sort buffer, the next pass copies them there and the
// later passes scan only those. The winners are then compacted (warp
// ballots, one atomic a warp) into a buffer of pow2(kout) keys, sorted
// there by a bitonic network whose strides below 64 run in registers
// (a warp holds 64 keys and trades them by shuffles, no block barrier),
// and the first kout written out. A row or a buffer too wide for the
// 227 KB of shared memory stays in device memory (the row read again each
// pass; the buffer in scratch the caller allocates): slower, the same
// bits. The f32 form keeps 4 bytes a column in shared memory (39,023
// columns: 156 KB) and 8 a winner.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (ops/kernels/
// timing.py, device time): 0.040 ms for the group select and 0.061 ms for
// stage2's select at the shapes above, against 1.05 and 0.41 ms for the
// full sorts they replace and 0.126 and 0.171 ms for `torch.topk` (the
// first on keys already packed); 13% and 9% of the bytes bound. One block alone
// takes as long as 128 (0.038 against 0.040 ms): what is left is each
// block's serial work on chip, not device memory. Of it, about 8 us is any
// launch of 1,024 threads, the radix passes and the compaction about
// 23 us, the sort of 2,048 int32 keys about 8 us and of 4,096 int64 keys
// about 30 us. The first form (`__match_any_sync` histograms, a block
// barrier at every sort stage, every pass over the whole row) took 0.064
// and 0.068 ms; the sort's register stages and the narrowed passes 0.056
// and 0.058; the warp histograms give the times above.
//
// The f32 form, the same card and timer: 0.369 ms for the IVF cell's
// centroid select (32 of 1,024 x 39,023; 190 KB of shared memory, one
// block an SM), 0.319 ms for its window select (128 of 1,024 x 32,768, two
// thirds -inf) and 0.035 ms for the forest's `_select_rows` chunk (1,024
// of 128 x 16,384), against 3.28, 2.75 and 0.250 ms for the stable
// `torch.sort` they replace and 0.646, 0.501 and 0.107 ms for `torch.topk`;
// about 13% of the bytes bound (0.048 and 0.041 ms on the IVF cell's own
// operands, where it takes 0.353 and 0.303 ms). On rows of a few hundred
// columns it is slower than the sort (0.054 against 0.022 ms for 10 of
// 1,024 x 128): the block of 1,024 threads is mostly idle there. Tried and
// not kept: the first pass counted as the row lands, an unaligned row's
// head peeled off for 16-byte loads, one atomic a distinct digit of a
// warp, and narrowing into all the spare shared memory; together 0.51 and
// 0.39 ms at the two IVF selects, slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kCtrlWords = 8;
// a histogram a warp, their sums, and a few words of control
constexpr size_t kFixedSmem = (kWarps * kBins + kBins + kCtrlWords) * sizeof(unsigned);

template <typename U>
struct Args {
  int n;       // row width
  int kout;    // keys written a row, 1 <= kout <= n
  int p;       // pow2(kout): the sort buffer's length
  U flip;      // order key = key ^ flip; the wanted keys are the smallest
  int pack;    // build int32 keys from values (module note)
  int sh, lo, hi, bits_w;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

template <typename U>
__device__ __forceinline__ U order_key(U x, unsigned col, const Args<U>& a) {
  if constexpr (sizeof(U) == 4) {
    if (a.pack) {
      const int32_t q = min(max(static_cast<int32_t>(x) >> a.sh, a.lo), a.hi);
      x = (static_cast<uint32_t>(q) << a.bits_w) | col;
    }
  }
  return x ^ a.flip;
}

// The row's i-th order key: from shared memory, or read from device memory
// and made there.
template <typename U, bool kRowSmem>
__device__ __forceinline__ U read_key(const U* row, const U* src, int i, const Args<U>& a) {
  if constexpr (kRowSmem) {
    return row[i];
  } else {
    return order_key(__ldg(src + i), static_cast<unsigned>(i), a);
  }
}

// One compare-exchange of a bitonic sort into ascending order: pair t of
// the stage of `stride` in merges of `size` keys.
template <typename U>
__device__ __forceinline__ void bitonic_step(U* buf, int t, int size, int stride) {
  const int lo = 2 * t - (t & (stride - 1));
  const int hi = lo + stride;
  const U x = buf[lo], y = buf[hi];
  if ((x > y) == ((lo & size) == 0)) {
    buf[lo] = y;
    buf[hi] = x;
  }
}

// Keeps the smaller (or larger) of x and the key at index i ^ stride,
// held by lane ^ stride, as the merge of `size` at index i wants it.
template <typename U>
__device__ __forceinline__ U exchange(U x, int i, int size, int stride) {
  const U y = __shfl_xor_sync(0xFFFFFFFFu, x, stride);
  const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
  return keep_min ? (x < y ? x : y) : (x < y ? y : x);
}

// The bitonic stages of strides 32 .. 1 on every 64-key block of buf[0, p)
// (p a power of two >= 64), a warp a block at a time: lane l holds keys
// 64 blk + l and 64 blk + 32 + l. With size_from 2 it runs every merge of
// size 2 .. 64; with a size of 128 or more, that merge's small strides.
template <typename U>
__device__ __forceinline__ void warp_bitonic64(U* buf, int p, int warp, int lane,
                                               int size_from) {
  for (int blk = warp; blk < (p >> 6); blk += kThreads / 32) {
    const int i0 = blk * 64 + lane, i1 = i0 + 32;
    U x0 = buf[i0], x1 = buf[i1];
    for (int size = size_from; size <= (size_from == 2 ? 64 : size_from); size <<= 1) {
      for (int stride = (size < 64 ? size : 64) >> 1; stride > 0; stride >>= 1) {
        if (stride == 32) {
          const bool asc = (i0 & size) == 0;
          const U lo = x0 < x1 ? x0 : x1, hi = x0 < x1 ? x1 : x0;
          x0 = asc ? lo : hi;
          x1 = asc ? hi : lo;
        } else {
          x0 = exchange(x0, i0, size, stride);
          x1 = exchange(x1, i1, size, stride);
        }
      }
    }
    buf[i0] = x0;
    buf[i1] = x1;
  }
}

template <typename U, bool kRowSmem, bool kSortSmem>
__global__ void __launch_bounds__(kThreads, 1)
topk_select_kernel(const U* __restrict__ in, U* __restrict__ out, U* __restrict__ scratch,
                   Args<U> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned lane_lt = (1u << lane) - 1;
  const size_t row_b = kRowSmem ? align16((size_t)a.n * sizeof(U)) : 0;
  const size_t sort_b = kSortSmem ? align16((size_t)a.p * sizeof(U)) : 0;
  U* row = reinterpret_cast<U*>(smem);
  U* buf = kSortSmem ? reinterpret_cast<U*>(smem + row_b) : scratch + (size_t)blockIdx.x * a.p;
  unsigned* hist = reinterpret_cast<unsigned*>(smem + row_b + sort_b);
  unsigned* tot = hist + kWarps * kBins;
  unsigned* ctrl = tot + kBins;
  const U* src = in + (size_t)blockIdx.x * a.n;
  const int n = a.n;
  // loops over the row run every warp through the same number of steps, so
  // warp-wide votes see full warps
  const int steps = (n + kThreads - 1) / kThreads * kThreads;
  const int warp = tid >> 5;
  if (tid == 0) ctrl[5] = 0;     // the one narrowing pass's count

  if constexpr (kRowSmem) {
    // the row into shared memory as order keys: 16-byte loads, four in
    // flight a thread, when the row starts 16-byte aligned
    constexpr int kE = 16 / sizeof(U);
    constexpr int kBatch = 4;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int nv = n / kE;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* r4 = reinterpret_cast<uint4*>(row);
      for (int v0 = 0; v0 < nv; v0 += kBatch * kThreads) {
        uint4 w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int v = v0 + j * kThreads + tid;
          if (v < nv) w[j] = __ldg(s4 + v);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int v = v0 + j * kThreads + tid;
          if (v < nv) {
            U* e = reinterpret_cast<U*>(&w[j]);
#pragma unroll
            for (int t = 0; t < kE; ++t) e[t] = order_key(e[t], (unsigned)(v * kE + t), a);
            r4[v] = w[j];
          }
        }
      }
      done = nv * kE;
    }
    for (int i = done + tid; i < n; i += kThreads) row[i] = order_key(src[i], (unsigned)i, a);
  }

  // radix select: the kout-th smallest order key shares `prefix` on the
  // bits of `pmask`; `krem` keys with those bits are still wanted. Once
  // the keys still matching fit the sort buffer, the next pass also copies
  // them there (mode 1) and the passes after it scan only those (mode 2).
  U prefix = 0, pmask = 0;
  unsigned krem = (unsigned)a.kout;
  int mode = 0, cnt = n;
  for (int shift = 8 * (int)sizeof(U) - 8; shift >= 0; shift -= 8) {
    for (int j = tid; j < kWarps * kBins; j += kThreads) hist[j] = 0;
    __syncthreads();
    const int len = mode == 2 ? cnt : n;
    const int len_steps = (len + kThreads - 1) / kThreads * kThreads;
    for (int i = tid; i < len_steps; i += kThreads) {
      bool m = false;
      unsigned d = 0xFFFFFFFFu;
      U u = 0;
      if (i < len) {
        u = mode == 2 ? buf[i] : read_key<U, kRowSmem>(row, src, i, a);
        if ((u & pmask) == prefix) {
          m = true;
          d = (unsigned)(u >> shift) & (kBins - 1);
        }
      }
      // the warp's own histogram: one atomic where every matching lane
      // has the same digit (keys that share their leading bits), else one
      // a lane
      const unsigned bm = __ballot_sync(0xFFFFFFFFu, m);
      if (bm) {
        const int first = __ffs(bm) - 1;
        const unsigned d0 = __shfl_sync(0xFFFFFFFFu, d, first);
        if (__ballot_sync(0xFFFFFFFFu, m && d == d0) == bm) {
          if (lane == first) atomicAdd(&hist[warp * kBins + d0], (unsigned)__popc(bm));
        } else if (m) {
          atomicAdd(&hist[warp * kBins + d], 1u);
        }
      }
      if (mode == 1) {
        unsigned base = 0;
        if (lane == 0 && bm) base = atomicAdd(&ctrl[5], (unsigned)__popc(bm));
        base = __shfl_sync(0xFFFFFFFFu, base, 0);
        if (m) buf[base + __popc(bm & lane_lt)] = u;
      }
    }
    __syncthreads();
    if (tid < kBins) {
      unsigned sum = 0;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) sum += hist[w * kBins + tid];
      tot[tid] = sum;
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 8l .. 8l + 7; find the bin where the count
      // passes krem
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = tot[lane * 8 + j];
        s += c[j];
      }
      unsigned incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned acc = incl - s;
      if (acc < krem && krem <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc < krem && krem <= acc + c[j]) {
            ctrl[0] = lane * 8 + j;
            ctrl[1] = krem - acc;
            ctrl[2] = c[j];
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    const unsigned bin = ctrl[0];
    const unsigned in_bin = ctrl[2];
    krem = ctrl[1];
    prefix |= static_cast<U>(bin) << shift;
    pmask |= static_cast<U>(kBins - 1) << shift;
    if (in_bin == krem) break;   // every key of the bin is wanted: done
    if (mode == 1) {
      mode = 2;                  // buf holds the cnt keys this pass matched
    } else if (mode == 0 && in_bin <= (unsigned)a.p) {
      mode = 1;
      cnt = (int)in_bin;
    }
  }

  // compact: keys below the prefix fill [0, kout - krem) in any order, the
  // first krem keys equal to it on the prefix bits fill the rest
  if (tid == 0) ctrl[3] = ctrl[4] = 0;
  __syncthreads();
  const unsigned below = (unsigned)a.kout - krem;
  for (int i = tid; i < steps; i += kThreads) {
    bool lt = false, eq = false;
    U u = 0;
    if (i < n) {
      u = read_key<U, kRowSmem>(row, src, i, a);
      const U top = u & pmask;
      lt = top < prefix;
      eq = top == prefix;
    }
    const unsigned blt = __ballot_sync(0xFFFFFFFFu, lt);
    const unsigned beq = __ballot_sync(0xFFFFFFFFu, eq);
    unsigned base_lt = 0, base_eq = 0;
    if (lane == 0) {
      if (blt) base_lt = atomicAdd(&ctrl[3], (unsigned)__popc(blt));
      if (beq) base_eq = atomicAdd(&ctrl[4], (unsigned)__popc(beq));
    }
    base_lt = __shfl_sync(0xFFFFFFFFu, base_lt, 0);
    base_eq = __shfl_sync(0xFFFFFFFFu, base_eq, 0);
    if (lt) buf[base_lt + __popc(blt & lane_lt)] = u;
    if (eq) {
      const unsigned t = base_eq + __popc(beq & lane_lt);
      if (t < krem) buf[below + t] = u;
    }
  }
  for (int i = a.kout + tid; i < a.p; i += kThreads) buf[i] = ~static_cast<U>(0);
  __syncthreads();

  // bitonic sort of the p keys, ascending: strides of 64 and more through
  // the buffer, one block-wide barrier a stage; the strides below 64 of
  // each merge in registers, a warp holding 64 consecutive keys (two a
  // lane) and trading them by shuffles
  if (a.p < 64) {
    for (int size = 2; size <= a.p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (tid < (a.p >> 1)) bitonic_step(buf, tid, size, stride);
        __syncthreads();
      }
    }
  } else {
    warp_bitonic64(buf, a.p, warp, lane, 2);
    __syncthreads();
    for (int size = 128; size <= a.p; size <<= 1) {
      for (int stride = size >> 1; stride >= 64; stride >>= 1) {
        for (int t = tid; t < (a.p >> 1); t += kThreads) bitonic_step(buf, t, size, stride);
        __syncthreads();
      }
      warp_bitonic64(buf, a.p, warp, lane, size);
      __syncthreads();
    }
  }

  U* o = out + (size_t)blockIdx.x * a.kout;
  for (int i = tid; i < a.kout; i += kThreads) o[i] = buf[i] ^ a.flip;
}

// The f32 form. Its select is the key forms' radix select over the 64-bit
// key (order image << 32) | column, which is never stored; it is written
// out apart from topk_select_kernel so that the key forms' compiled code
// stays what it was.

struct F32Args {
  int n;        // row width
  int kout;     // entries written a row, 1 <= kout <= n
  int p;        // pow2(kout): the sort buffer's length
};

// The order image of an f32's bits, smallest for the largest value: the
// complement of ord (module note), -0.0 taken as +0.0.
__device__ __forceinline__ unsigned f32_order(unsigned b) {
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? b : ~(b | 0x80000000u);
}

// The select's key of column i from its order image: unique in the row,
// and the smaller of two equal images belongs to the earlier column.
__device__ __forceinline__ unsigned long long f32_key(unsigned r, int i) {
  return (static_cast<unsigned long long>(r) << 32) | static_cast<unsigned>(i);
}

// Column i's key: its image from shared memory, or read from device memory
// and made there.
template <bool kRowSmem>
__device__ __forceinline__ unsigned long long read_f32_key(const unsigned* row,
                                                           const unsigned* src, int i) {
  if constexpr (kRowSmem) {
    return f32_key(row[i], i);
  } else {
    return f32_key(f32_order(__ldg(src + i)), i);
  }
}

template <bool kRowSmem, bool kSortSmem>
__global__ void __launch_bounds__(kThreads, 1)
topk_select_f32_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out_s,
                       long long* __restrict__ out_i, unsigned long long* __restrict__ scratch,
                       F32Args a) {
  using U = unsigned long long;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned lane_lt = (1u << lane) - 1;
  const size_t row_b = kRowSmem ? align16((size_t)a.n * sizeof(unsigned)) : 0;
  const size_t sort_b = kSortSmem ? align16((size_t)a.p * sizeof(U)) : 0;
  unsigned* row = reinterpret_cast<unsigned*>(smem);
  U* buf = kSortSmem ? reinterpret_cast<U*>(smem + row_b) : scratch + (size_t)blockIdx.x * a.p;
  unsigned* hist = reinterpret_cast<unsigned*>(smem + row_b + sort_b);
  unsigned* tot = hist + kWarps * kBins;
  unsigned* ctrl = tot + kBins;
  const unsigned* src = in + (size_t)blockIdx.x * a.n;
  const int n = a.n;
  // loops over the row run every warp through the same number of steps, so
  // warp-wide votes see full warps
  const int steps = (n + kThreads - 1) / kThreads * kThreads;
  const int warp = tid >> 5;
  if (tid == 0) ctrl[5] = 0;     // the one narrowing pass's count

  if constexpr (kRowSmem) {
    // the row into shared memory as order images: 16-byte loads, four in
    // flight a thread, when the row starts 16-byte aligned
    constexpr int kE = 4;
    constexpr int kBatch = 4;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int nv = n / kE;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* r4 = reinterpret_cast<uint4*>(row);
      for (int v0 = 0; v0 < nv; v0 += kBatch * kThreads) {
        uint4 w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int v = v0 + j * kThreads + tid;
          if (v < nv) w[j] = __ldg(s4 + v);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int v = v0 + j * kThreads + tid;
          if (v < nv) {
            w[j].x = f32_order(w[j].x);
            w[j].y = f32_order(w[j].y);
            w[j].z = f32_order(w[j].z);
            w[j].w = f32_order(w[j].w);
            r4[v] = w[j];
          }
        }
      }
      done = nv * kE;
    }
    for (int i = done + tid; i < n; i += kThreads) row[i] = f32_order(src[i]);
  }

  // the column digits at and above this shift are 0 in every column of the
  // row, so their passes are skipped
  int col_top = 0;
  for (unsigned m = (unsigned)(n - 1); m != 0; m >>= 8) col_top += 8;

  // radix select, as topk_select_kernel's over 64-bit keys
  U prefix = 0, pmask = 0;
  unsigned krem = (unsigned)a.kout;
  int mode = 0, cnt = n;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && shift >= col_top) continue;
    for (int j = tid; j < kWarps * kBins; j += kThreads) hist[j] = 0;
    __syncthreads();
    const int len = mode == 2 ? cnt : n;
    const int len_steps = (len + kThreads - 1) / kThreads * kThreads;
    for (int i = tid; i < len_steps; i += kThreads) {
      bool m = false;
      unsigned d = 0xFFFFFFFFu;
      U u = 0;
      if (i < len) {
        u = mode == 2 ? buf[i] : read_f32_key<kRowSmem>(row, src, i);
        if ((u & pmask) == prefix) {
          m = true;
          d = (unsigned)(u >> shift) & (kBins - 1);
        }
      }
      const unsigned bm = __ballot_sync(0xFFFFFFFFu, m);
      if (bm) {
        const int first = __ffs(bm) - 1;
        const unsigned d0 = __shfl_sync(0xFFFFFFFFu, d, first);
        if (__ballot_sync(0xFFFFFFFFu, m && d == d0) == bm) {
          if (lane == first) atomicAdd(&hist[warp * kBins + d0], (unsigned)__popc(bm));
        } else if (m) {
          atomicAdd(&hist[warp * kBins + d], 1u);
        }
      }
      if (mode == 1) {
        unsigned base = 0;
        if (lane == 0 && bm) base = atomicAdd(&ctrl[5], (unsigned)__popc(bm));
        base = __shfl_sync(0xFFFFFFFFu, base, 0);
        if (m) buf[base + __popc(bm & lane_lt)] = u;
      }
    }
    __syncthreads();
    if (tid < kBins) {
      unsigned sum = 0;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) sum += hist[w * kBins + tid];
      tot[tid] = sum;
    }
    __syncthreads();
    if (tid < 32) {
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = tot[lane * 8 + j];
        s += c[j];
      }
      unsigned incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned acc = incl - s;
      if (acc < krem && krem <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc < krem && krem <= acc + c[j]) {
            ctrl[0] = lane * 8 + j;
            ctrl[1] = krem - acc;
            ctrl[2] = c[j];
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    const unsigned bin = ctrl[0];
    const unsigned in_bin = ctrl[2];
    krem = ctrl[1];
    prefix |= static_cast<U>(bin) << shift;
    pmask |= static_cast<U>(kBins - 1) << shift;
    if (in_bin == krem) break;
    if (mode == 1) {
      mode = 2;
    } else if (mode == 0 && in_bin <= (unsigned)a.p) {
      mode = 1;
      cnt = (int)in_bin;
    }
  }

  // compact, as topk_select_kernel does; the keys are unique, so exactly
  // krem equal the prefix on its bits
  if (tid == 0) ctrl[3] = ctrl[4] = 0;
  __syncthreads();
  const unsigned below = (unsigned)a.kout - krem;
  for (int i = tid; i < steps; i += kThreads) {
    bool lt = false, eq = false;
    U u = 0;
    if (i < n) {
      u = read_f32_key<kRowSmem>(row, src, i);
      const U top = u & pmask;
      lt = top < prefix;
      eq = top == prefix;
    }
    const unsigned blt = __ballot_sync(0xFFFFFFFFu, lt);
    const unsigned beq = __ballot_sync(0xFFFFFFFFu, eq);
    unsigned base_lt = 0, base_eq = 0;
    if (lane == 0) {
      if (blt) base_lt = atomicAdd(&ctrl[3], (unsigned)__popc(blt));
      if (beq) base_eq = atomicAdd(&ctrl[4], (unsigned)__popc(beq));
    }
    base_lt = __shfl_sync(0xFFFFFFFFu, base_lt, 0);
    base_eq = __shfl_sync(0xFFFFFFFFu, base_eq, 0);
    if (lt) buf[base_lt + __popc(blt & lane_lt)] = u;
    if (eq) {
      const unsigned t = base_eq + __popc(beq & lane_lt);
      if (t < krem) buf[below + t] = u;
    }
  }
  for (int i = a.kout + tid; i < a.p; i += kThreads) buf[i] = ~static_cast<U>(0);
  __syncthreads();

  // bitonic sort of the p keys, ascending, as topk_select_kernel's
  if (a.p < 64) {
    for (int size = 2; size <= a.p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (tid < (a.p >> 1)) bitonic_step(buf, tid, size, stride);
        __syncthreads();
      }
    }
  } else {
    warp_bitonic64(buf, a.p, warp, lane, 2);
    __syncthreads();
    for (int size = 128; size <= a.p; size <<= 1) {
      for (int stride = size >> 1; stride >= 64; stride >>= 1) {
        for (int t = tid; t < (a.p >> 1); t += kThreads) bitonic_step(buf, t, size, stride);
        __syncthreads();
      }
      warp_bitonic64(buf, a.p, warp, lane, size);
      __syncthreads();
    }
  }

  // each winner's column, and its value read back from the row, so it
  // keeps its bits
  const size_t o = (size_t)blockIdx.x * a.kout;
  for (int i = tid; i < a.kout; i += kThreads) {
    const unsigned col = static_cast<unsigned>(buf[i]);
    out_i[o + i] = col;
    out_s[o + i] = __ldg(src + col);
  }
}

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// 0: row and sort buffer in shared memory; 1: the row read from device
// memory, the buffer in shared memory; 2: both in device memory (scratch).
// A row keeps row_bytes a column, the buffer key_bytes a key.
int form_of(int n, int kout, int row_bytes, int key_bytes, int optin) {
  const size_t row_b = align16((size_t)n * row_bytes);
  const size_t sort_b = align16((size_t)pow2_at_least(kout) * key_bytes);
  if (row_b + sort_b + kFixedSmem <= (size_t)optin) return 0;
  if (sort_b + kFixedSmem <= (size_t)optin) return 1;
  return 2;
}

// A row keeps a Row a column, the sort buffer a Key a winner.
template <typename Row, typename Key, bool kRowSmem, bool kSortSmem>
size_t smem_of(int n, int p) {
  return (kRowSmem ? align16((size_t)n * sizeof(Row)) : 0) +
         (kSortSmem ? align16((size_t)p * sizeof(Key)) : 0) + kFixedSmem;
}

// Lets a form's instantiation take all the shared memory a block may opt
// in to on the current device (its only shared memory is dynamic), so one
// setting serves every shape of that form. It is a per-device setting: the
// caller makes it once per device and shape (`rdf_topk_select_form`,
// `rdf_topk_select_f32_form`), not at every launch.
template <typename K>
int allow_smem(K kernel, int optin) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

template <typename U>
int allow_form(int form, int optin) {
  switch (form) {
    case 0: return allow_smem(topk_select_kernel<U, true, true>, optin);
    case 1: return allow_smem(topk_select_kernel<U, false, true>, optin);
    default: return allow_smem(topk_select_kernel<U, false, false>, optin);
  }
}

int allow_f32_form(int form, int optin) {
  switch (form) {
    case 0: return allow_smem(topk_select_f32_kernel<true, true>, optin);
    case 1: return allow_smem(topk_select_f32_kernel<false, true>, optin);
    default: return allow_smem(topk_select_f32_kernel<false, false>, optin);
  }
}

template <typename U, bool kRowSmem, bool kSortSmem>
int launch(const void* in, void* out, void* scratch, int B, const Args<U>& a,
           cudaStream_t stream) {
  topk_select_kernel<U, kRowSmem, kSortSmem>
      <<<B, kThreads, smem_of<U, U, kRowSmem, kSortSmem>(a.n, a.p), stream>>>(
          static_cast<const U*>(in), static_cast<U*>(out), static_cast<U*>(scratch), a);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_form(int form, const void* in, void* out, void* scratch, int B, const Args<U>& a,
                cudaStream_t stream) {
  switch (form) {
    case 0: return launch<U, true, true>(in, out, scratch, B, a, stream);
    case 1: return launch<U, false, true>(in, out, scratch, B, a, stream);
    default: return launch<U, false, false>(in, out, scratch, B, a, stream);
  }
}

template <bool kRowSmem, bool kSortSmem>
int launch_f32(const void* in, void* out_s, void* out_i, void* scratch, int B,
               const F32Args& a, cudaStream_t stream) {
  topk_select_f32_kernel<kRowSmem, kSortSmem>
      <<<B, kThreads, smem_of<unsigned, unsigned long long, kRowSmem, kSortSmem>(a.n, a.p),
         stream>>>(
          static_cast<const unsigned*>(in), static_cast<unsigned*>(out_s),
          static_cast<long long*>(out_i), static_cast<unsigned long long*>(scratch), a);
  return (int)cudaGetLastError();
}

// The form for rows of n columns, kout kept (1 <= kout <= n), on the
// current device, with row_bytes a column in shared memory and key_bytes a
// key in the sort buffer; lets it take the shared memory it may need there
// (allow). Negative: a cudaError_t.
template <typename Allow>
int form_for(int n, int kout, int row_bytes, int key_bytes, Allow allow) {
  int optin = 0;
  int err = smem_optin(&optin);
  if (err != 0) return -err;
  const int form = form_of(n, kout, row_bytes, key_bytes, optin);
  err = allow(form, optin);
  return err != 0 ? -err : form;
}

}  // namespace

// Which form rdf_topk_select takes for rows of n keys of key_bytes (4 or
// 8), kout of them kept (1 <= kout <= n), on the current device (see
// form_of); form 2 needs scratch of B * pow2(kout) keys. It also lets that
// form take the shared memory it may need on this device (allow_smem), so
// call it once per device and shape before the first launch there. Negative: a
// cudaError_t.
extern "C" int rdf_topk_select_form(int n, int kout, int key_bytes) {
  if (n < 1 || kout < 1 || kout > n || (key_bytes != 4 && key_bytes != 8))
    return -(int)cudaErrorInvalidValue;
  return key_bytes == 4
             ? form_for(n, kout, 4, 4, allow_form<unsigned>)
             : form_for(n, kout, 8, 8, allow_form<unsigned long long>);
}

// in [B, n] int32 (key_bytes 4) or int64 (8), contiguous; out [B, kout]
// of the same type, 1 <= kout <= n; `form` as rdf_topk_select_form gave it
// for this shape on this device; scratch of B * pow2(kout) keys when the
// form is 2, else unused. descending: the kout largest first, else the
// kout smallest. pack (int32 only): keys built from values as the module
// note says, 0 <= sh < 32, 1 <= bits_w < 32, n <= 2^bits_w. Launches on
// `stream`; returns the cudaError_t of the launch (cudaErrorInvalidValue
// for arguments outside these).
extern "C" int rdf_topk_select(const void* in, void* out, void* scratch, int B, int n, int kout,
                               int key_bytes, int form, int descending, int pack, int sh,
                               int bits_w, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || n < 1 || kout < 1 || kout > n || (key_bytes != 4 && key_bytes != 8) ||
      form < 0 || form > 2 || (form == 2 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pack && (key_bytes != 4 || sh < 0 || sh > 31 || bits_w < 1 || bits_w > 31 ||
               (long long)n > (1ll << bits_w)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4) {
    Args<unsigned> a{n, kout, pow2_at_least(kout),
                     descending ? 0x7FFFFFFFu : 0x80000000u, pack, sh,
                     pack ? -(1 << (31 - bits_w)) : 0, pack ? (1 << (31 - bits_w)) - 1 : 0,
                     bits_w};
    return launch_form<unsigned>(form, in, out, scratch, B, a, st);
  }
  Args<unsigned long long> a{n, kout, pow2_at_least(kout),
                   descending ? 0x7FFFFFFFFFFFFFFFull : 0x8000000000000000ull, 0, 0, 0, 0, 0};
  return launch_form<unsigned long long>(form, in, out, scratch, B, a, st);
}

// Which form rdf_topk_select_f32 takes for rows of n f32 scores, kout of
// them kept (1 <= kout <= n), on the current device: 4 bytes a column in
// shared memory, 8 a winner; form 2 needs scratch of B * pow2(kout)
// 8-byte keys. Lets that form take its shared memory on this device, as
// rdf_topk_select_form does. Negative: a cudaError_t.
extern "C" int rdf_topk_select_f32_form(int n, int kout) {
  if (n < 1 || kout < 1 || kout > n) return -(int)cudaErrorInvalidValue;
  return form_for(n, kout, 4, 8, allow_f32_form);
}

// in f32[B, n], contiguous; out_s f32[B, kout] and out_i int64[B, kout]:
// each row's first kout entries of a stable descending sort (module note),
// 1 <= kout <= n; `form` as rdf_topk_select_f32_form gave it for this
// shape on this device; scratch of B * pow2(kout) 8-byte keys when the
// form is 2, else unused. Launches on `stream`; returns the cudaError_t of
// the launch (cudaErrorInvalidValue for arguments outside these).
extern "C" int rdf_topk_select_f32(const void* in, void* out_s, void* out_i, void* scratch,
                                   int B, int n, int kout, int form, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || n < 1 || kout < 1 || kout > n || form < 0 || form > 2 ||
      (form == 2 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const F32Args a{n, kout, pow2_at_least(kout)};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case 0: return launch_f32<true, true>(in, out_s, out_i, scratch, B, a, st);
    case 1: return launch_f32<false, true>(in, out_s, out_i, scratch, B, a, st);
    default: return launch_f32<false, false>(in, out_s, out_i, scratch, B, a, st);
  }
}
