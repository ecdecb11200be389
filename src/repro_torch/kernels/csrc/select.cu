// The candidate selection: (Q, L) f32 bounds -> the k smallest of each row,
// ties toward the lower column. Two C entries share its kernels:
//   select_launch        the k pairs in column order, unsorted: ((Q, k)
//                        int32 columns, (Q, k) f32 bounds), and each
//                        row's k-th smallest bound (the engine's
//                        phase 1: what the exactness fallback needs);
//   order_range_launch   ranks [lo, hi) of such a column-order list in
//                        (bound bits, column) order (phase 2: the engine
//                        orders only the prefix its round loop reaches).
//
// Replaces the TPU kernel: none. The reference selects its candidate list
// with jax.lax.top_k (repro/core/search.py:592), which XLA lowers itself.
// Added because torch.topk over int64 keys (bits << 32) | column, the
// oracle (kernels/ref.py::smallest), builds an 8.6 GB key tensor at (64,
// 2^24) and takes 61 ms a batch to select over and sort 8-byte keys; these
// entries give its answers bit for bit, one prefix of them at a time.
//
// Keys. A bound's 32 bits, read as a signed integer, order the int64 key's
// high half; u = bits ^ 0x80000000 orders the same way as an unsigned
// integer (non-negative bounds: bit 31 set, the rest the float's own
// order). The k smallest (u, column) pairs are every u < T and the first
// k - count(u < T) columns with u == T, where T is the k-th smallest u.
//
// Bound on the H100: memory. At Q = 64, L = 2^24, k = 2^20 one read of the
// bounds is 4.29 GB and the output 0.54 GB: 1.44 ms at 3.35 TB/s. A range
// of a (Q, k) list reads its k bounds (0.27 GB) and writes hi - lo pairs.
//
// Design. No int64 tensor and no host readback; every size is known before
// the launch, so the wrapper allocates one int32 scratch and the C entry
// queues these kernels on the caller's stream:
//   1. Radix select on u, digits of 11, 11 and 10 bits. Each pass reads the
//      row in chunks of kChunk bounds, one block a (chunk, row), counts the
//      digit of the bounds that share the prefix found so far into a
//      shared-memory histogram and adds it to the row's; a one-block-a-row
//      kernel then finds the digit where the k-th key falls. The first pass also takes each row's least u. The
//      last pass keeps each chunk's histogram and its count of bounds below
//      the 22-bit prefix, so that the last find kernel knows, per chunk,
//      how many bounds lie below T and how many equal it, and scans them
//      into each chunk's output offset and its quota of ties.
//   2. One stable compaction: each block writes its chunk's (u, column)
//      pairs with u < T, and the first `quota` with u == T, in column order
//      (ballots and a scan over the block's warps), at its chunk's offset.
//      A chunk with nothing to write reads nothing.
//   3. A stable LSD radix sort of each row's pairs by u, 8 bits a pass,
//      over only the bits below the highest bit where the row's least u
//      and T differ (above it every selected key agrees). A pass counts each
//      tile's digits, scans the (digit, tile) counts of the row, and
//      scatters: each warp ranks its own contiguous 256 pairs in order
//      (__match_any_sync), so equal digits keep their order and ties keep
//      column order, and the tile is staged in shared memory in digit
//      order so that it goes out in runs. Passes a row does not need
//      return at once. The pairs ping-pong between the scratch and the
//      outputs so that the last pass a row needs lands in the outputs,
//      where keys are stored as float bits.
// With k == L (the whole row selected) step 1 only takes each row's least
// and largest u, and step 2 copies the row. select_launch stops after step
// 2 and writes T. order_range_launch runs all three on the list with k = hi, its
// entries' columns taken from the list, and drops ranks below lo from the
// compaction: those are the pairs (u, column) <= the rank lo - 1 pair,
// which the caller passes (the last entry of the prefix it already holds),
// so that no state is kept between calls. The last find kernel subtracts
// each chunk's count of them, counted in pass 3, from its output offset,
// and the sort starts from the bits where that pair's u and T differ.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFlip = 0x80000000u;
constexpr uint32_t kFull = 0xffffffffu;

// Select and compaction: a block reads one chunk of one row.
constexpr int kSelThreads = 512;
constexpr int kSelUnroll = 8;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelTile = kSelThreads * kSelUnroll;  // bounds a block step
constexpr long long kChunk = 16LL * kSelTile;      // bounds a block reads
constexpr int kBins1 = 2048;                        // u bits 31..21
constexpr int kBins2 = 2048;                        // u bits 20..10
constexpr int kBins3 = 1024;                        // u bits 9..0
constexpr int kFindThreads = 256;

// Sort: a block ranks one tile of kSortTile pairs (512 threads of 47
// registers: two blocks an SM).
constexpr int kSortThreads = 512;
constexpr int kCountThreads = 256;  // == kRadix: one digit a thread
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;  // pairs a lane
constexpr long long kSortTile = kSortThreads * kSortItems;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kMaxPasses = 32 / kRadixBits;
constexpr int kScanThreads = 1024;
static_assert(kCountThreads == kRadix && kSortThreads >= kRadix,
              "the sort's kernels give a thread each digit");
static_assert(kSortTile < 65536, "a tile's counts fit 16 bits");
static_assert(kSelUnroll * kSelWarps % 32 == 0 && kBins3 <= 1024,
              "the compaction's scan and sel_last_kernel's block");

// Per-row fields of the meta block.
constexpr int kNotMin = 0;  // ~(least u), by atomicMax from 0
constexpr int kMax = 1;     // largest u (full sort only)
constexpr int kPrefix = 2;  // digits of T found so far
constexpr int kRem = 3;     // rank of the k-th key among those sharing it
constexpr int kT = 4;       // the k-th smallest u
constexpr int kPasses = 5;  // sort passes the row needs
constexpr int kMeta = 8;

// The int32 scratch, in words: the zeroed head (meta, the two row
// histograms), then the per-chunk tables, the sort's counts and the
// ping-pong pairs (n a row: the pairs the sort orders; none for
// select_launch, which does not sort).
struct Layout {
  long long nch, tiles;
  long long meta, hist1, hist2, zeroed;
  long long chist, lt, lo, cmeta, counts, keys, vals, total;
};

Layout layout(long long Q, long long L, long long n) {
  Layout a;
  a.nch = (L + kChunk - 1) / kChunk;
  a.tiles = (n + kSortTile - 1) / kSortTile;
  a.meta = 0;
  a.hist1 = a.meta + Q * kMeta;
  a.hist2 = a.hist1 + Q * kBins1;
  a.zeroed = a.hist2 + Q * kBins2;
  a.chist = a.zeroed;
  a.lt = a.chist + Q * a.nch * kBins3;
  a.lo = a.lt + Q * a.nch;
  a.cmeta = a.lo + Q * a.nch;
  a.counts = a.cmeta + Q * a.nch * 3;
  a.keys = a.counts + Q * kRadix * a.tiles;
  a.vals = a.keys + Q * n;
  a.total = a.vals + Q * n;
  return a;
}

// The rank lo - 1 pair of an order_range call: the pairs at or below it
// in (u, column) order are the ranks below lo, which the call drops. Off
// where the call passes none (lo == 0, and the other entries).
struct Cut {
  bool on;
  uint32_t u;
  int32_t col;

  __device__ __forceinline__ Cut(const uint32_t* bits, const int32_t* cols,
                                 int q)
      : on(bits != nullptr),
        u(bits != nullptr ? bits[q] ^ kFlip : 0u),
        col(bits != nullptr ? cols[q] : 0) {}

  // Whether the pair (v, *col_of) is dropped; reads the column only on a
  // tie with the cut's u.
  __device__ __forceinline__ bool below(uint32_t v,
                                        const int32_t* col_of) const {
    return on && (v < u || (v == u && __ldg(col_of) <= col));
  }
};

// Exclusive prefix of v over the block's threads, in thread order; the
// block's total to *total when given. s holds 33 words; every thread calls.
template <int T>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* s,
                                                         uint32_t* total) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? s[lane] : 0;
    uint32_t inc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < kWarps) s[lane] = inc - w;
    if (lane == 31) s[32] = inc;
  }
  __syncthreads();
  const uint32_t out = s[warp] + x - v;
  if (total) *total = s[32];
  __syncthreads();  // s is free again
  return out;
}

// The kSelUnroll bounds of one block step, as keys u; valid where < e.
__device__ __forceinline__ void load_step(const uint32_t* __restrict__ row,
                                          long long base, long long e,
                                          uint32_t (&v)[kSelUnroll]) {
#pragma unroll
  for (int j = 0; j < kSelUnroll; ++j) {
    const long long i = base + j * kSelThreads + threadIdx.x;
    v[j] = i < e ? __ldg(row + i) ^ kFlip : 0u;
  }
}

// Add a block's shared histogram to the row's (nonzero bins only).
template <int kBins>
__device__ __forceinline__ void flush_hist(const uint32_t* h, uint32_t* row) {
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kSelThreads)
    if (h[i]) atomicAdd(row + i, h[i]);
}

// Pass 1: the row's least (and, for a full sort, largest) u and, when
// selecting, the histogram of u's top 11 bits.
template <bool kSelect>
__global__ void __launch_bounds__(kSelThreads)
sel_top_kernel(const uint32_t* __restrict__ lb, long long L,
               uint32_t* __restrict__ meta, uint32_t* __restrict__ hist1) {
  __shared__ uint32_t h[kSelect ? kBins1 : 1];
  __shared__ uint32_t s_min[kSelWarps], s_max[kSelWarps];
  const int q = blockIdx.y;
  if (kSelect)
    for (int i = threadIdx.x; i < kBins1; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const uint32_t* row = lb + (long long)q * L;
  const long long s = blockIdx.x * kChunk;
  const long long e = min(s + kChunk, L);
  uint32_t mn = kFull, mx = 0;
  for (long long base = s; base < e; base += kSelTile) {
    uint32_t v[kSelUnroll];
    load_step(row, base, e, v);
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      if (base + j * kSelThreads + threadIdx.x < e) {
        mn = min(mn, v[j]);
        mx = max(mx, v[j]);
        if (kSelect) atomicAdd(&h[v[j] >> 21], 1u);
      }
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_min[warp] = mn;
    s_max[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = __reduce_min_sync(kFull, lane < kSelWarps ? s_min[lane] : kFull);
    mx = __reduce_max_sync(kFull, lane < kSelWarps ? s_max[lane] : 0u);
    if (lane == 0) {
      atomicMax(meta + q * kMeta + kNotMin, ~mn);
      if (!kSelect) atomicMax(meta + q * kMeta + kMax, mx);
    }
  }
  if (kSelect) flush_hist<kBins1>(h, hist1 + (long long)q * kBins1);
}

// Pass 2: the histogram of u's bits 20..10 among the bounds whose top 11
// bits are the prefix.
__global__ void __launch_bounds__(kSelThreads)
sel_mid_kernel(const uint32_t* __restrict__ lb, long long L,
               const uint32_t* __restrict__ meta,
               uint32_t* __restrict__ hist2) {
  __shared__ uint32_t h[kBins2];
  const int q = blockIdx.y;
  for (int i = threadIdx.x; i < kBins2; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const uint32_t p = meta[q * kMeta + kPrefix];
  const uint32_t* row = lb + (long long)q * L;
  const long long s = blockIdx.x * kChunk;
  const long long e = min(s + kChunk, L);
  for (long long base = s; base < e; base += kSelTile) {
    uint32_t v[kSelUnroll];
    load_step(row, base, e, v);
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j)
      if (base + j * kSelThreads + threadIdx.x < e && (v[j] >> 21) == p)
        atomicAdd(&h[(v[j] >> 10) & (kBins2 - 1)], 1u);
  }
  flush_hist<kBins2>(h, hist2 + (long long)q * kBins2);
}

// Pass 3: per chunk, the histogram of u's low 10 bits among the bounds
// whose top 22 bits are the prefix, and the count of bounds below it; for
// a range (kRange with a previous pair), the count of pairs at or below
// that pair.
template <bool kRange>
__global__ void __launch_bounds__(kSelThreads)
sel_low_kernel(const uint32_t* __restrict__ lb,
               const int32_t* __restrict__ cols, long long L, long long nch,
               const uint32_t* __restrict__ meta,
               const uint32_t* __restrict__ cut_bits,
               const int32_t* __restrict__ cut_cols,
               uint32_t* __restrict__ chist, uint32_t* __restrict__ lt,
               uint32_t* __restrict__ lo) {
  __shared__ uint32_t h[kBins3];
  __shared__ uint32_t s_lt[kSelWarps], s_lo[kSelWarps];
  const int q = blockIdx.y;
  const long long c = blockIdx.x;
  for (int i = threadIdx.x; i < kBins3; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const uint32_t p = meta[q * kMeta + kPrefix];
  const uint32_t* row = lb + (long long)q * L;
  const int32_t* crow = kRange ? cols + (long long)q * L : nullptr;
  const Cut cut(kRange ? cut_bits : nullptr, cut_cols, q);
  const long long s = c * kChunk;
  const long long e = min(s + kChunk, L);
  uint32_t below = 0, n_lo = 0;
  for (long long base = s; base < e; base += kSelTile) {
    uint32_t v[kSelUnroll];
    load_step(row, base, e, v);
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      const long long i = base + j * kSelThreads + threadIdx.x;
      if (i < e) {
        const uint32_t top = v[j] >> 10;
        if (top == p)
          atomicAdd(&h[v[j] & (kBins3 - 1)], 1u);
        else
          below += top < p;
        if (kRange) n_lo += cut.below(v[j], crow + i);
      }
    }
  }
  below = __reduce_add_sync(kFull, below);
  if (kRange) n_lo = __reduce_add_sync(kFull, n_lo);
  if ((threadIdx.x & 31) == 0) {
    s_lt[threadIdx.x >> 5] = below;
    s_lo[threadIdx.x >> 5] = n_lo;
  }
  __syncthreads();
  uint32_t* out = chist + ((long long)q * nch + c) * kBins3;
  for (int i = threadIdx.x; i < kBins3; i += kSelThreads) out[i] = h[i];
  if (threadIdx.x < 32) {
    const bool w = threadIdx.x < kSelWarps;
    below = __reduce_add_sync(kFull, w ? s_lt[threadIdx.x] : 0u);
    n_lo = __reduce_add_sync(kFull, w ? s_lo[threadIdx.x] : 0u);
    if (threadIdx.x == 0) {
      lt[(long long)q * nch + c] = below;
      if (kRange) lo[(long long)q * nch + c] = n_lo;
    }
  }
}

// After pass 1 or 2: the digit of the row's histogram where its k-th key
// (k itself after pass 1, the remaining rank after pass 2) falls.
template <bool kFirst>
__global__ void __launch_bounds__(kFindThreads)
sel_find_kernel(const uint32_t* __restrict__ hist, uint32_t* __restrict__ meta,
                uint32_t k) {
  constexpr int kBins = kFirst ? kBins1 : kBins2;
  constexpr int kPer = kBins / kFindThreads;
  __shared__ uint32_t s[33];
  const int q = blockIdx.x;
  const uint32_t* h = hist + (long long)q * kBins;
  uint32_t* m = meta + q * kMeta;
  const uint32_t want = kFirst ? k : m[kRem];
  uint32_t c[kPer];
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = h[threadIdx.x * kPer + j];
    sum += c[j];
  }
  uint32_t cum = block_exclusive_scan<kFindThreads>(sum, s, nullptr);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (cum < want && want <= cum + c[j]) {
      const uint32_t d = threadIdx.x * kPer + j;
      m[kPrefix] = kFirst ? d : (m[kPrefix] << 11) | d;
      m[kRem] = want - cum;
    }
    cum += c[j];
  }
}

// The sort passes a row needs for keys in [least, t]: none if `sort` is
// off (the compaction then writes the outputs); T to kth when given.
__device__ __forceinline__ void set_t(uint32_t* m, uint32_t least,
                                      uint32_t t, bool sort, uint32_t* kth) {
  const int bits = least == t ? 0 : 32 - __clz(least ^ t);
  m[kT] = t;
  m[kPasses] = sort ? (bits + kRadixBits - 1) / kRadixBits : 0;
  if (kth) *kth = t ^ kFlip;
}

// After pass 3: T; per chunk, its output offset, its quota of bounds equal
// to T (the ties left after the chunks before it, in column order) and its
// count of pairs to write, less the pairs at or below the cut (lo, when
// given); the sort passes the row needs.
__global__ void __launch_bounds__(kBins3)
sel_last_kernel(const uint32_t* __restrict__ chist,
                const uint32_t* __restrict__ lt,
                const uint32_t* __restrict__ lo, uint32_t* __restrict__ cmeta,
                uint32_t* __restrict__ meta, long long nch,
                const uint32_t* __restrict__ cut_bits, bool sort,
                uint32_t* __restrict__ kth) {
  __shared__ uint32_t s[33];
  __shared__ uint32_t s_digit, s_below;
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* m = meta + q * kMeta;
  const uint32_t* ch = chist + (long long)q * nch * kBins3;
  uint32_t cnt = 0;  // the row's count of digit threadIdx.x
  for (long long c = 0; c < nch; ++c) cnt += ch[c * kBins3 + threadIdx.x];
  const uint32_t want = m[kRem];
  const uint32_t cum = block_exclusive_scan<kBins3>(cnt, s, nullptr);
  if (cum < want && want <= cum + cnt) {
    s_digit = threadIdx.x;
    s_below = cum;
  }
  __syncthreads();
  const uint32_t dt = s_digit;
  const uint32_t keq = want - s_below;  // ties of T the row takes
  uint32_t* cm = cmeta + (long long)q * nch * 3;
  for (long long c = warp; c < nch; c += kBins3 / 32) {
    const uint32_t* hc = ch + c * kBins3;
    uint32_t below = 0;
    for (uint32_t j = lane; j < dt; j += 32) below += hc[j];
    below = __reduce_add_sync(kFull, below);
    if (lane == 0) {
      cm[c * 3] = lt[(long long)q * nch + c] + below;
      cm[c * 3 + 1] = hc[dt];
    }
  }
  __syncthreads();
  uint32_t carry_eq = 0, carry_out = 0;
  for (long long c0 = 0; c0 < nch; c0 += kBins3) {
    const long long c = c0 + threadIdx.x;
    uint32_t n_lt = 0, n_eq = 0;
    if (c < nch) {
      n_lt = cm[c * 3];
      n_eq = cm[c * 3 + 1];
    }
    uint32_t tot;
    const uint32_t eq_before =
        carry_eq + block_exclusive_scan<kBins3>(n_eq, s, &tot);
    carry_eq += tot;
    const uint32_t quota = keq > eq_before ? keq - eq_before : 0u;
    const uint32_t n_out = n_lt + min(n_eq, quota) -
                           (lo && c < nch ? lo[(long long)q * nch + c] : 0u);
    const uint32_t off =
        carry_out + block_exclusive_scan<kBins3>(n_out, s, &tot);
    carry_out += tot;
    if (c < nch) {
      cm[c * 3] = off;
      cm[c * 3 + 1] = quota;
      cm[c * 3 + 2] = n_out;
    }
  }
  if (threadIdx.x == 0) {
    // A range's pairs lie above the cut: its u is their least.
    const uint32_t least =
        cut_bits ? max(~m[kNotMin], cut_bits[q] ^ kFlip) : ~m[kNotMin];
    set_t(m, least, (m[kPrefix] << 10) | dt, sort, kth ? kth + q : nullptr);
  }
}

// A full sort (k == L): T is the largest u.
__global__ void sel_all_kernel(uint32_t* __restrict__ meta, int Q, bool sort,
                               uint32_t* __restrict__ kth) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  uint32_t* m = meta + q * kMeta;
  set_t(m, ~m[kNotMin], m[kMax], sort, kth ? kth + q : nullptr);
}

// Where the pairs of pass `pass` (0 = the compaction's output) lie: the
// outputs when the passes left after it are even in number.
__device__ __forceinline__ bool in_outputs(uint32_t passes, int pass) {
  return ((passes - pass) & 1) == 0;
}

// The stable compaction (see the top). kAll copies the whole row. kRange:
// a pair's column is cols[i] (the list's), pairs at or below the cut are
// dropped, and the chunk's offset already counts only the pairs kept. The
// pairs go to rows of `n` (the outputs or the sort's scratch).
template <bool kAll, bool kRange>
__global__ void __launch_bounds__(kSelThreads)
sel_compact_kernel(const uint32_t* __restrict__ lb,
                   const int32_t* __restrict__ cols, long long L, long long n,
                   long long nch, const uint32_t* __restrict__ meta,
                   const uint32_t* __restrict__ cmeta,
                   const uint32_t* __restrict__ cut_bits,
                   const int32_t* __restrict__ cut_cols, uint32_t* keys,
                   int32_t* vals, uint32_t* out_bits, int32_t* out_cols) {
  constexpr int kScans = kRange ? 3 : 2;  // below T, ties, dropped
  constexpr int kSteps = kSelUnroll * kSelWarps;
  __shared__ uint32_t s_cnt[kScans][kSteps];
  __shared__ uint32_t s_carry[kScans];
  const int q = blockIdx.y;
  const long long c = blockIdx.x;
  const uint32_t* m = meta + q * kMeta;
  const bool to_out = in_outputs(m[kPasses], 0);
  uint32_t* dk = (to_out ? out_bits : keys) + (long long)q * n;
  int32_t* dv = (to_out ? out_cols : vals) + (long long)q * n;
  const uint32_t flip = to_out ? kFlip : 0u;  // outputs hold float bits
  const uint32_t* row = lb + (long long)q * L;
  const int32_t* crow = kRange ? cols + (long long)q * L : nullptr;
  const long long s = c * kChunk;
  const long long e = min(s + kChunk, L);
  if (kAll) {
    for (long long i = s + threadIdx.x; i < e; i += kSelThreads) {
      dk[i] = __ldg(row + i) ^ kFlip ^ flip;
      dv[i] = (int32_t)i;
    }
    return;
  }
  const uint32_t* cm = cmeta + ((long long)q * nch + c) * 3;
  const uint32_t off = cm[0], quota = cm[1];
  if (cm[2] == 0) return;  // nothing of this chunk is selected
  const uint32_t t = m[kT];
  const Cut cut(kRange ? cut_bits : nullptr, cut_cols, q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lower = (1u << lane) - 1u;
  if (threadIdx.x < kScans) s_carry[threadIdx.x] = 0;
  for (long long base = s; base < e; base += kSelTile) {
    uint32_t v[kSelUnroll], b[kScans][kSelUnroll];
    int32_t col[kSelUnroll];  // kRange: the list's column, where selected
    load_step(row, base, e, v);
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      const long long i = base + j * kSelThreads + threadIdx.x;
      const bool ok = i < e;
      b[0][j] = __ballot_sync(kFull, ok && v[j] < t);
      b[1][j] = __ballot_sync(kFull, ok && v[j] == t);
      if (kRange) {
        const bool cut_here = ok && cut.below(v[j], crow + i);
        b[kScans - 1][j] = __ballot_sync(kFull, cut_here);
        // loaded here, so that the load's latency hides behind the scan
        col[j] = ok && v[j] <= t && !cut_here ? __ldg(crow + i) : 0;
      }
    }
    __syncthreads();  // the last step is done with s_cnt, s_carry
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < kScans; ++a)
#pragma unroll
        for (int j = 0; j < kSelUnroll; ++j)
          s_cnt[a][j * kSelWarps + warp] = __popc(b[a][j]);
    }
    __syncthreads();
    if (warp < kScans) {  // warp a scans counts a over the block's steps
      constexpr int kPerLane = kSteps / 32;
      uint32_t* a = s_cnt[warp];
      uint32_t x[kPerLane];
      uint32_t sum = 0;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        x[r] = a[lane * kPerLane + r];
        sum += x[r];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      uint32_t run = s_carry[warp] + inc - sum;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        a[lane * kPerLane + r] = run;
        run += x[r];
      }
      const uint32_t total = __shfl_sync(kFull, inc, 31);
      __syncwarp();
      if (lane == 0) s_carry[warp] += total;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSelUnroll; ++j) {
      const int st = j * kSelWarps + warp;
      const uint32_t n_lt = s_cnt[0][st] + __popc(b[0][j] & lower);
      const uint32_t n_eq = s_cnt[1][st] + __popc(b[1][j] & lower);
      const bool is_lt = (b[0][j] >> lane) & 1u;
      const bool is_eq = ((b[1][j] >> lane) & 1u) && n_eq < quota;
      // the pairs dropped before this one, all of them selected too
      const uint32_t n_cut =
          kRange ? s_cnt[kScans - 1][st] + __popc(b[kScans - 1][j] & lower)
                 : 0u;
      const bool cut_here = kRange && ((b[kScans - 1][j] >> lane) & 1u);
      if ((is_lt || is_eq) && !cut_here) {
        const uint32_t pos = off + n_lt + min(n_eq, quota) - n_cut;
        const long long i = base + j * kSelThreads + threadIdx.x;
        if (pos < n) {  // holds unless the cut is not the rank lo - 1 pair
          dk[pos] = v[j] ^ flip;
          dv[pos] = kRange ? col[j] : (int32_t)i;
        }
      }
    }
  }
}

// Sort pass `pass`, step 1: each tile's count of every digit, stored
// (row, digit, tile) so that one scan of the row gives every offset.
__global__ void __launch_bounds__(kCountThreads)
sort_count_kernel(const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ out_bits, long long k,
                  long long tiles, const uint32_t* __restrict__ meta,
                  uint32_t* __restrict__ counts, int pass) {
  __shared__ uint32_t h[kRadix];
  const int q = blockIdx.y;
  const uint32_t passes = meta[q * kMeta + kPasses];
  if (pass >= (int)passes) return;
  const bool src_out = in_outputs(passes, pass);
  const uint32_t* src = (src_out ? out_bits : keys) + (long long)q * k;
  const uint32_t flip = src_out ? kFlip : 0u;
  const int shift = pass * kRadixBits;
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long t0 = blockIdx.x * kSortTile;
  const long long e = min(t0 + kSortTile, k);
  for (long long i = t0 + threadIdx.x; i < e; i += kCountThreads)
    atomicAdd(&h[((src[i] ^ flip) >> shift) & (kRadix - 1)], 1u);
  __syncthreads();
  counts[((long long)q * kRadix + threadIdx.x) * tiles + blockIdx.x] =
      h[threadIdx.x];
}

// Step 2: the exclusive scan of a row's counts, digit-major.
__global__ void __launch_bounds__(kScanThreads)
sort_scan_kernel(uint32_t* __restrict__ counts, long long tiles,
                 const uint32_t* __restrict__ meta, int pass) {
  __shared__ uint32_t s[33];
  const int q = blockIdx.x;
  if (pass >= (int)meta[q * kMeta + kPasses]) return;
  uint32_t* a = counts + (long long)q * kRadix * tiles;
  const long long n = kRadix * tiles;
  uint32_t carry = 0;
  for (long long b = 0; b < n; b += 4 * kScanThreads) {
    const long long i0 = b + 4 * threadIdx.x;
    uint32_t x[4], sum = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = i0 + r < n ? a[i0 + r] : 0u;
      sum += x[r];
    }
    uint32_t tot;
    uint32_t run = carry + block_exclusive_scan<kScanThreads>(sum, s, &tot);
    carry += tot;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r < n) a[i0 + r] = run;
      run += x[r];
    }
  }
}

// Step 3: the stable scatter of one tile. Warp w holds pairs
// [w * 256, (w + 1) * 256) of the tile. A first walk counts each warp's
// digits; the counts give each (warp, digit) its place in the tile sorted
// by digit; a second walk ranks each pair among the equal digits of its
// warp, in order (__match_any_sync), and stages it in shared memory at
// that place; the tile then goes out in order, each digit's run at the
// digit's offset for the tile, so neighbouring threads write neighbouring
// words.
__global__ void __launch_bounds__(kSortThreads, 2)
sort_scatter_kernel(uint32_t* keys, int32_t* vals, uint32_t* out_bits,
                    int32_t* out_cols, long long k, long long tiles,
                    const uint32_t* __restrict__ meta,
                    const uint32_t* __restrict__ counts, int pass) {
  // (warp, digit) counts, then places: under kSortTile, so 16 bits (and 16
  // warps of 32-bit counts would pass the 48 KB of static shared memory).
  __shared__ uint16_t s_cnt[kSortWarps][kRadix];
  __shared__ uint32_t s_out[kRadix];  // digit offset for the tile, less
                                      // the digit's start in the tile
  __shared__ uint32_t s_key[kSortTile];
  __shared__ int32_t s_val[kSortTile];
  __shared__ uint32_t s_scan[33];
  const int q = blockIdx.y;
  const uint32_t passes = meta[q * kMeta + kPasses];
  if (pass >= (int)passes) return;
  const bool src_out = in_outputs(passes, pass);
  const uint32_t* sk = (src_out ? out_bits : keys) + (long long)q * k;
  const int32_t* sv = (src_out ? out_cols : vals) + (long long)q * k;
  uint32_t* dk = (src_out ? keys : out_bits) + (long long)q * k;
  int32_t* dv = (src_out ? vals : out_cols) + (long long)q * k;
  const uint32_t sflip = src_out ? kFlip : 0u;
  const uint32_t dflip = src_out ? 0u : kFlip;
  const int shift = pass * kRadixBits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kSortWarps * kRadix; i += kSortThreads)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const long long t0 = blockIdx.x * kSortTile;
  const long long w0 = t0 + (long long)warp * (kSortItems * 32);
  uint32_t key[kSortItems];
  int32_t val[kSortItems];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const long long idx = w0 + i * 32 + lane;
    const bool ok = idx < k;
    key[i] = ok ? sk[idx] ^ sflip : 0u;
    val[i] = ok ? sv[idx] : 0;
  }
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {  // each warp's digit counts
    const bool ok = w0 + i * 32 + lane < k;
    const uint32_t d = ok ? (key[i] >> shift) & (kRadix - 1) : kRadix;
    const uint32_t peers = __match_any_sync(kFull, d);
    if (ok && lane == __ffs(peers) - 1)
      s_cnt[warp][d] = (uint16_t)(s_cnt[warp][d] + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  {  // thread d: digit d's start in the tile and each warp's place in it
    const uint32_t d = threadIdx.x;
    uint32_t n = 0;
    if (d < kRadix)
      for (int w = 0; w < kSortWarps; ++w) n += s_cnt[w][d];
    const uint32_t start = block_exclusive_scan<kSortThreads>(n, s_scan,
                                                              nullptr);
    if (d < kRadix) {
      uint32_t run = start;
      for (int w = 0; w < kSortWarps; ++w) {
        const uint32_t c = s_cnt[w][d];
        s_cnt[w][d] = (uint16_t)run;
        run += c;
      }
      s_out[d] =
          counts[((long long)q * kRadix + d) * tiles + blockIdx.x] - start;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {  // rank and stage, in order
    const bool ok = w0 + i * 32 + lane < k;
    const uint32_t d = ok ? (key[i] >> shift) & (kRadix - 1) : kRadix;
    const uint32_t peers = __match_any_sync(kFull, d);
    const uint32_t before = ok ? s_cnt[warp][d] : 0u;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1)
      s_cnt[warp][d] = (uint16_t)(before + __popc(peers));
    __syncwarp();
    if (ok) {
      const uint32_t p = before + __popc(peers & lower);
      s_key[p] = key[i];
      s_val[p] = val[i];
    }
  }
  __syncthreads();
  const int n_tile = (int)min(kSortTile, k - t0);
  for (int i = threadIdx.x; i < n_tile; i += kSortThreads) {
    const uint32_t x = s_key[i];
    const uint32_t pos = s_out[(x >> shift) & (kRadix - 1)] + i;
    dk[pos] = x ^ dflip;
    dv[pos] = s_val[i];
  }
}

// What one C entry asks of the shared kernels.
struct Call {
  const uint32_t* in;      // (Q, L) bounds as float bits
  const int32_t* cols;     // (Q, L) columns of a range's list; else null
  const uint32_t* cut_bits;  // (Q,) the rank lo - 1 pair, or null
  const int32_t* cut_cols;
  uint32_t* out_bits;      // (Q, n)
  int32_t* out_cols;
  uint32_t* kth;           // (Q,) T as float bits, or null
  int Q;
  long long L, k, n;       // k: ranks selected; n: pairs written a row
  bool sort;
};

int queue(const Call& c, uint32_t* w, const Layout& a, cudaStream_t st) {
  uint32_t* meta = w + a.meta;
  uint32_t* keys = w + a.keys;
  int32_t* vals = (int32_t*)(w + a.vals);
  cudaError_t err = cudaMemsetAsync(w, 0, a.zeroed * 4, st);
  if (err != cudaSuccess) return (int)err;
#define PARIS_CHECK_LAUNCH()                       \
  do {                                             \
    const cudaError_t e = cudaGetLastError();      \
    if (e != cudaSuccess) return (int)e;           \
  } while (0)
  const dim3 rows_grid((unsigned)a.nch, (unsigned)c.Q);
  if (c.k == c.L && !c.cols) {
    sel_top_kernel<false><<<rows_grid, kSelThreads, 0, st>>>(c.in, c.L, meta,
                                                              w + a.hist1);
    PARIS_CHECK_LAUNCH();
    sel_all_kernel<<<(c.Q + 255) / 256, 256, 0, st>>>(meta, c.Q, c.sort,
                                                       c.kth);
    PARIS_CHECK_LAUNCH();
    sel_compact_kernel<true, false><<<rows_grid, kSelThreads, 0, st>>>(
        c.in, nullptr, c.L, c.n, a.nch, meta, w + a.cmeta, nullptr, nullptr,
        keys, vals, c.out_bits, c.out_cols);
    PARIS_CHECK_LAUNCH();
  } else {
    sel_top_kernel<true><<<rows_grid, kSelThreads, 0, st>>>(c.in, c.L, meta,
                                                             w + a.hist1);
    PARIS_CHECK_LAUNCH();
    sel_find_kernel<true><<<c.Q, kFindThreads, 0, st>>>(w + a.hist1, meta,
                                                        (uint32_t)c.k);
    PARIS_CHECK_LAUNCH();
    sel_mid_kernel<<<rows_grid, kSelThreads, 0, st>>>(c.in, c.L, meta,
                                                      w + a.hist2);
    PARIS_CHECK_LAUNCH();
    sel_find_kernel<false><<<c.Q, kFindThreads, 0, st>>>(w + a.hist2, meta,
                                                         (uint32_t)c.k);
    PARIS_CHECK_LAUNCH();
    if (c.cols)
      sel_low_kernel<true><<<rows_grid, kSelThreads, 0, st>>>(
          c.in, c.cols, c.L, a.nch, meta, c.cut_bits, c.cut_cols,
          w + a.chist, w + a.lt, w + a.lo);
    else
      sel_low_kernel<false><<<rows_grid, kSelThreads, 0, st>>>(
          c.in, nullptr, c.L, a.nch, meta, nullptr, nullptr, w + a.chist,
          w + a.lt, nullptr);
    PARIS_CHECK_LAUNCH();
    sel_last_kernel<<<c.Q, kBins3, 0, st>>>(
        w + a.chist, w + a.lt, c.cut_bits ? w + a.lo : nullptr, w + a.cmeta,
        meta, a.nch, c.cut_bits, c.sort, c.kth);
    PARIS_CHECK_LAUNCH();
    if (c.cols)
      sel_compact_kernel<false, true><<<rows_grid, kSelThreads, 0, st>>>(
          c.in, c.cols, c.L, c.n, a.nch, meta, w + a.cmeta, c.cut_bits,
          c.cut_cols, keys, vals, c.out_bits, c.out_cols);
    else
      sel_compact_kernel<false, false><<<rows_grid, kSelThreads, 0, st>>>(
          c.in, nullptr, c.L, c.n, a.nch, meta, w + a.cmeta, nullptr,
          nullptr, keys, vals, c.out_bits, c.out_cols);
    PARIS_CHECK_LAUNCH();
  }
  if (!c.sort) return (int)cudaSuccess;
  const dim3 tiles_grid((unsigned)a.tiles, (unsigned)c.Q);
  for (int pass = 0; pass < kMaxPasses; ++pass) {
    sort_count_kernel<<<tiles_grid, kCountThreads, 0, st>>>(
        keys, c.out_bits, c.n, a.tiles, meta, w + a.counts, pass);
    PARIS_CHECK_LAUNCH();
    sort_scan_kernel<<<c.Q, kScanThreads, 0, st>>>(w + a.counts, a.tiles,
                                                   meta, pass);
    PARIS_CHECK_LAUNCH();
    sort_scatter_kernel<<<tiles_grid, kSortThreads, 0, st>>>(
        keys, vals, c.out_bits, c.out_cols, c.n, a.tiles, meta,
        w + a.counts, pass);
    PARIS_CHECK_LAUNCH();
  }
#undef PARIS_CHECK_LAUNCH
  return (int)cudaSuccess;
}

bool bad_shape(int Q, long long L, long long k) {
  return Q <= 0 || L <= 0 || k <= 0 || k > L || Q > 65535;
}

}  // namespace

// Words of int32 scratch that select_launch needs for (Q, L) bounds.
extern "C" long long select_scratch_words(int Q, long long L) {
  return layout(Q, L, 0).total;
}

// lb: (Q, L) f32; cols, bounds: (Q, k) outputs, the k smallest (u, column)
// pairs in column order, unsorted; kth: (Q,) f32, each row's k-th smallest
// bound; scratch: `words` int32 words (select_scratch_words). Queues every
// kernel on `stream` and returns the first launch error, or 0.
extern "C" int select_launch(const void* lb, void* cols, void* bounds,
                             void* kth, void* scratch, long long words, int Q,
                             long long L, long long k, void* stream) {
  if (bad_shape(Q, L, k)) return (int)cudaErrorInvalidValue;
  const Layout a = layout(Q, L, 0);
  if (words < a.total) return (int)cudaErrorInvalidValue;
  const Call c{(const uint32_t*)lb, nullptr, nullptr, nullptr,
               (uint32_t*)bounds, (int32_t*)cols, (uint32_t*)kth, Q, L, k, k,
               false};
  return queue(c, (uint32_t*)scratch, a, (cudaStream_t)stream);
}

// Words of int32 scratch that order_range_launch needs for a (Q, L) list
// and n = hi - lo pairs a row.
extern "C" long long order_range_scratch_words(int Q, long long L,
                                               long long n) {
  return layout(Q, L, n).total;
}

// list_bounds, list_cols: (Q, L) a list in column order (select_launch's);
// cut_bounds, cut_cols: (Q,) its rank lo - 1 pairs, or null for lo == 0;
// out_cols, out_bounds: (Q, n) ranks [hi - n, hi) in (bound bits, column)
// order.
extern "C" int order_range_launch(const void* list_bounds,
                                  const void* list_cols,
                                  const void* cut_bounds,
                                  const void* cut_cols, void* out_cols,
                                  void* out_bounds, void* scratch,
                                  long long words, int Q, long long L,
                                  long long hi, long long n, void* stream) {
  if (bad_shape(Q, L, hi) || n <= 0 || n > hi ||
      (cut_bounds == nullptr) != (n == hi) || (cut_bounds && !cut_cols))
    return (int)cudaErrorInvalidValue;
  const Layout a = layout(Q, L, n);
  if (words < a.total) return (int)cudaErrorInvalidValue;
  const Call c{(const uint32_t*)list_bounds, (const int32_t*)list_cols,
               (const uint32_t*)cut_bounds, (const int32_t*)cut_cols,
               (uint32_t*)out_bounds, (int32_t*)out_cols, nullptr, Q, L, hi,
               n, true};
  return queue(c, (uint32_t*)scratch, a, (cudaStream_t)stream);
}
