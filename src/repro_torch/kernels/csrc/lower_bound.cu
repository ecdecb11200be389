// The squared PAA-to-iSAX lower bound,
// (n/w) * sum_j max(q_j - hi_j, lo_j - q_j, 0)^2, of (Q, w) f32 query PAA
// against (N, w) uint8 SAX rows -> (Q, N) f32. Three C entries, each with
// its own wrapper and launch count; the two batch entries share one
// templated kernel, lb_kernel, and the single query has its own,
// lb_single_kernel:
//
//   lower_bound_sq_batch_launch  Q queries x N rows. Replaces the TPU kernel
//       repro/kernels/lower_bound.py::_lb_kernel_batch
//       (lower_bound_sq_batch_pallas, pallas_call at :200).
//   lower_bound_sq_launch        one query x N rows. Replaces the TPU kernels
//       _lb_kernel_rows (:26) and _lb_kernel_cols (:42) (lower_bound_sq_pallas,
//       pallas_call at :270). The TPU needed two layouts, (N, w) and the
//       transposed (w, N), because a w = 16 row wastes 7/8 of its 128 lanes;
//       here a thread reads whole (N, w) rows, so one layout serves both.
//   lower_bound_sq_multi_launch  Q queries x N_pad rows of a packed multi-
//       component buffer. Replaces _lb_kernel_batch_masked (:77,
//       lower_bound_sq_multi_pallas, pallas_call at :150): row r is real iff
//       r % block_n < block_len[r / block_n]; every other row (component
//       pads, dead tail blocks with block_len == 0) gets +inf for every query.
//
// The TPU kernels took the SAX transposed, (w, N), so that candidates fill
// the 128-wide lanes; here the index's own (N, w) row layout is read
// directly, one 16-byte row per load, and no transposed copy exists.
//
// Bound on the H100: at Q = 64, N = 2^24, w = 16 the batch forms write 4.3 GB
// and read 0.27 GB (1.36 ms at 3.35 TB/s) and do 6w + 1 = 97 fp32 operations
// per (query, row) pair (104 G ops, 1.55 ms at 67 TFLOP/s). That peak counts
// a fused multiply-add as two operations, and none of these can be fused:
// the plain version rounds acc + d * d as a product and a sum, and candidate
// order depends on exact ties between bounds. So the batch forms are bound
// by the rate at which the SMs issue instructions, not by bytes: one warp
// instruction per clock in each of 528 sub-partitions. The single-query
// form is bound by bytes: 16 B read and 4 B written per row (0.34 GB at
// N = 2^24, 0.10 ms) against 97 operations per row (1.6 G ops, 0.024 ms).
//
// Design, for the issue rate: every instruction of the inner loop is one
// the algorithm needs, 5 per (query, row, segment):
//   - two subtractions, q - hi and lo - q;
//   - max(q - hi, lo - q, 0) as ONE Hopper DPX instruction on the bit
//     patterns, __vimax_s32_relu (two FMNMX in a float form). It is exact
//     here: lo <= hi, so at most one of the two differences is positive; a
//     positive float's bits are a positive int of the same order, and a
//     negative float (-0.0 included) has a negative int pattern, which relu
//     turns into +0.0. Neither is NaN: q and the +/-BIG pads are finite;
//   - the product d * d and the sum acc + d * d, rounded separately
//     (__fmul_rn / __fadd_rn, no contraction), in the plain version's order
//     of j, and scale * acc last: every result is bit-identical to it. (The
//     first segment needs no sum: 0 + d * d is d * d exactly.)
// In the batch forms each thread owns R rows (by default 4 for w <= 16, 2
// for w = 32: 2w bound registers a row) of a T-thread block (by default
// 128), at base + t + i * T, so every warp store still covers 128
// contiguous bytes; each row's (lo, hi)
// bounds are looked up once, from the breakpoint table in shared memory,
// into registers. Queries are staged in shared memory block_q at a time
// (by default 64); each
// query's w values are read as float4 broadcasts once for all R rows, and
// the R accumulators give the issue slots independent work. The output
// pointer advances by N a query. A thread with a row past N or (masked
// form) a pad row takes a guarded copy of the loop in which such rows do
// no arithmetic.
//
// The single-query form has a kernel of its own, lb_single_kernel: it is
// bound by bytes, not issue, and in the batch geometry (one block a tile,
// the table and the query staged in every block, one shared table) it
// reached 43% of its bound on an H100. Two costs set that time, as timed
// with its symbols varied: the block prologue (0.19 ms with all 32 lanes
// of a warp on one symbol, no conflicts) and bank conflicts on the table
// (0.23 ms on an index's leaf-ordered rows, 0.30 ms on uniform symbols,
// 0.60 ms with every symbol on one bank). The design removes both:
//   - A persistent grid. As many T-thread blocks (by default 512) as the
//     SMs hold at once (from the occupancy calculator: 4 an SM at w = 16
//     and T = 512; blocks_per_sm can cap it lower) fill the table
//     and load the query's w values into registers once, then walk the
//     rows with a grid-stride loop, one row a thread a step, with no
//     barrier inside the loop. A block a 256-row tile paid three
//     dependent memory latencies (table, query, row) and three barriers
//     for 4 KB of loads.
//   - Loads in flight: a register double buffer. Each thread issues the
//     16-byte load of its next row before the lookups and arithmetic of
//     the current one, so an SM keeps one row a thread in flight while it
//     computes (32 KB at w = 16).
//   - Conflict-free lookups. With one shared table, a warp's 32 lookups
//     land on the banks sym % 32 of their symbols, and distinct symbols on
//     one bank are served one after another. Here the table is replicated
//     once per lane: entry s of lane l is s_bp[s * 32 + l], so every
//     lookup of a warp hits bank l in one wavefront, whatever the symbols;
//     hi is the same address plus 128 B. 257 x 32 floats, 32.9 KB of
//     static shared memory, filled from the n_bpp entries given (so a
//     cardinality below 256 works). A per-query table of squared gaps
//     (w x 256 floats, half the instructions a row) ran 4% faster on
//     leaf-ordered rows but kept the conflicts: 2.3x slower with every
//     symbol on one bank. This one's time does not depend on the symbols.
// The arithmetic is the batch forms' (region_gap, then __fmul_rn /
// __fadd_rn in the order of j from the first square, scale last), so its
// bits are the plain version's; rows past N store nothing.
//
// Launch shapes. Every knob above (block_q, T and R of the batch forms; T
// and the cap on blocks an SM of the single query) is chosen at each launch
// by the wrapper, from the H100 table of repro_torch/core/tuning.py or the
// caller; the defaults are the shapes written above. Only shapes that leave
// each output's arithmetic unchanged are admitted (the same segments, in
// the same order, for one row in one thread), so every admitted shape gives
// the default's bits. The admitted (T, R) pairs are instantiated below;
// anything else is refused with cudaErrorInvalidValue.
//
// Build: this file is compiled once per width, with -DPARIS_LB_W=4, 8, 16
// or 32, each object holding that width's kernels and paris_lb::launch_w,
// and once without, for the three C entries, which dispatch on w. The
// widths' objects compile in parallel (kernels/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace paris_lb {

constexpr int kBatch = 0, kMasked = 1, kSingle = 2;  // the entries' forms

// One launch as the entries hand it to the object of its width.
struct Launch {
  const void* qpaa;
  const void* sax;
  const void* bpp;
  const void* block_len;  // kMasked only
  void* out;
  int Q;
  long long N;
  int n_bpp;
  int block_n;  // kMasked only
  float scale;
  int block_q;  // batch forms: queries staged a block
  int threads;  // T
  int rows;  // batch forms: R, 0 for the width's default
  int blocks_per_sm;  // kSingle: cap on blocks an SM, 0 for none
  cudaStream_t stream;
};

// Defined in the object built with PARIS_LB_W = W.
template <int W>
int launch_w(int form, const Launch& a);

}  // namespace paris_lb

#ifdef PARIS_LB_W

namespace {

using paris_lb::kBatch;
using paris_lb::kMasked;
using paris_lb::Launch;

constexpr int kMaxQueryBlock = 64;  // block_q's capacity in shared memory
constexpr int kSymbols = 256;  // uint8 symbols: at most 257 padded breakpoints

// Rows a thread of the batch forms by default. They are bound by the issue
// rate and share each query's overhead over R rows (2w bound registers a
// row).
template <int W>
constexpr int kRows = W == 32 ? 2 : 4;
// Blocks an SM must hold in the batch forms, passed to ptxas through
// __launch_bounds__ as a register cap, from a budget of registers a thread:
// 2wR bounds, w query values and 24 for the sums, pointers and loop state
// (168 at w = 16, R = 4: 3 blocks of 128 threads, 12 warps an SM). Left to
// itself ptxas took 183 for one of the two batch forms, room for only 2
// blocks, and that form ran 5% slower than the other at 168.
template <int W, int T, int R>
constexpr int kMinBlocks = 65536 / (T * (2 * W * R + W + 24));

// The lanes of a warp, each with its own copy of the single query's
// breakpoint table.
constexpr int kLanes = 32;

template <int W>
__device__ __forceinline__ void load_symbols(const uint8_t* __restrict__ row,
                                             uint8_t (&sym)[W]) {
  if constexpr (W % 16 == 0) {
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) sym[c * 16 + k] = b[k];
    }
  } else if constexpr (W == 8) {
    uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) sym[k] = b[k];
  } else {
    static_assert(W == 4, "w must be 4, 8, 16 or 32");
    uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(row));
#pragma unroll
    for (int k = 0; k < 4; ++k) sym[k] = (uint8_t)(v >> (8 * k));
  }
}

// max(q - hi, lo - q, 0) in one DPX instruction; exact because lo <= hi
// (see the note at the top).
__device__ __forceinline__ float region_gap(float q, float lo, float hi) {
  return __int_as_float(__vimax_s32_relu(__float_as_int(__fsub_rn(q, hi)),
                                         __float_as_int(__fsub_rn(lo, q))));
}

// The bounds of one block of nq staged queries for a thread's R rows, T
// rows apart; o points at the first row's output for the first query.
// kGuarded: some rows are past N (live bit clear: no store) or pads (real
// bit clear: +inf, no arithmetic).
template <int W, int R, int T, bool kGuarded>
__device__ __forceinline__ void bound_rows(const float* s_q, int nq,
                                           const float (&lo)[R][W],
                                           const float (&hi)[R][W], float* o,
                                           long long N, float scale,
                                           unsigned real, unsigned live) {
  for (int qi = 0; qi < nq; ++qi, o += N) {
    float q[W];
    const float4* q4 = reinterpret_cast<const float4*>(s_q + qi * W);
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const float4 v = q4[c];
      q[4 * c] = v.x;
      q[4 * c + 1] = v.y;
      q[4 * c + 2] = v.z;
      q[4 * c + 3] = v.w;
    }
    // Each sum starts at its first square: the plain version's 0 + d * d
    // is d * d exactly, since a square is never -0.0.
    if constexpr (!kGuarded) {
      float acc[R];
#pragma unroll
      for (int j = 0; j < W; ++j) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float d = region_gap(q[j], lo[i][j], hi[i][j]);
          acc[i] = j ? __fadd_rn(acc[i], __fmul_rn(d, d)) : __fmul_rn(d, d);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) o[i * T] = __fmul_rn(scale, acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (real >> i & 1u) {
          float acc;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const float d = region_gap(q[j], lo[i][j], hi[i][j]);
            acc = j ? __fadd_rn(acc, __fmul_rn(d, d)) : __fmul_rn(d, d);
          }
          o[i * T] = __fmul_rn(scale, acc);
        } else if (live >> i & 1u) {
          o[i * T] = __int_as_float(0x7f800000);
        }
      }
    }
  }
}

// kForm: kBatch, or kMasked, the packed multi-component form with
// block_len / block_n. T threads, R rows a thread, block_q queries staged.
template <int W, int kForm, int T, int R>
__global__ void __launch_bounds__(T, (kMinBlocks<W, T, R>))
lb_kernel(const float* __restrict__ qpaa, const uint8_t* __restrict__ sax,
          const float* __restrict__ bpp, const int32_t* __restrict__ block_len,
          float* __restrict__ out, int Q, long long N, int n_bpp, int block_n,
          float scale, int block_q) {
  __shared__ float s_bp[kSymbols + 1];  // bp[s] .. bp[s + 1] bound symbol s
  __shared__ __align__(16) float s_q[kMaxQueryBlock * W];
  for (int i = threadIdx.x; i < n_bpp; i += T) s_bp[i] = bpp[i];
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * (T * R) + threadIdx.x;
  unsigned live = 0, real = 0;
  float lo[R][W], hi[R][W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = row0 + (long long)i * T;
    bool is_real = row < N;
    live |= (unsigned)is_real << i;
    if (kForm == kMasked && is_real)
      is_real = (int)(row % block_n) < __ldg(block_len + row / block_n);
    real |= (unsigned)is_real << i;
    uint8_t sym[W] = {};
    if (is_real) load_symbols<W>(sax + row * W, sym);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      lo[i][j] = s_bp[sym[j]];
      hi[i][j] = s_bp[sym[j] + 1];
    }
  }

  float* o = out + row0;
  for (int q0 = 0; q0 < Q; q0 += block_q, o += (long long)block_q * N) {
    const int nq = min(block_q, Q - q0);
    __syncthreads();  // the previous block of queries is no longer read
    for (int i = threadIdx.x; i < nq * W; i += T)
      s_q[i] = qpaa[(long long)q0 * W + i];
    __syncthreads();
    if (real == (1u << R) - 1)
      bound_rows<W, R, T, false>(s_q, nq, lo, hi, o, N, scale, real, live);
    else if (live)
      bound_rows<W, R, T, true>(s_q, nq, lo, hi, o, N, scale, real, live);
  }
}

// A row's w uint8 symbols as w / 4 words, one vector load.
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ row,
                                           uint32_t (&v)[W / 4]) {
  if constexpr (W % 16 == 0) {
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + c);
      v[4 * c] = x.x;
      v[4 * c + 1] = x.y;
      v[4 * c + 2] = x.z;
      v[4 * c + 3] = x.w;
    }
  } else if constexpr (W == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(row));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    static_assert(W == 4, "w must be 4, 8, 16 or 32");
    v[0] = __ldg(reinterpret_cast<const uint32_t*>(row));
  }
}

// lo and hi of symbol sym in the calling lane's copy of the table. lane_bp
// is the 32-bit shared-memory address of the lane's entry 0; entry s lies
// s * kLanes floats on, so hi (entry sym + 1) is 128 B after lo. The address
// is one instruction from the symbol; written as a float* index the same
// lookup became 64-bit generic-address arithmetic, 30 more instructions a
// row at w = 16. volatile keeps the loads after the barrier that ends the
// table fill.
__device__ __forceinline__ void lane_bounds(uint32_t lane_bp, unsigned sym,
                                            float& lo, float& hi) {
  static_assert(kLanes * sizeof(float) == 128, "hi is 128 B after lo");
  asm volatile(
      "ld.shared.f32 %0, [%2];\n\t"
      "ld.shared.f32 %1, [%2+128];"
      : "=f"(lo), "=f"(hi)
      : "r"(lane_bp + sym * (kLanes * (unsigned)sizeof(float))));
}

// One query against rows [0, N), a persistent grid of T-thread blocks (see
// the note at the top).
template <int W, int T>
__global__ void __launch_bounds__(T)
lb_single_kernel(const float* __restrict__ qpaa,
                 const uint8_t* __restrict__ sax,
                 const float* __restrict__ bpp, float* __restrict__ out,
                 long long N, int n_bpp, float scale) {
  // Entry s of lane l at s_bp[s * kLanes + l]. Thread s writes entry s's
  // copies, lane (l + s) % kLanes at step l, so a warp's stores of one
  // step land on 32 banks.
  __shared__ float s_bp[(kSymbols + 1) * kLanes];
  for (int s = threadIdx.x; s < n_bpp; s += T) {
    const float v = __ldg(bpp + s);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s_bp[s * kLanes + (l + s) % kLanes] = v;
  }
  float q[W];
#pragma unroll
  for (int j = 0; j < W; ++j) q[j] = __ldg(qpaa + j);
  const long long stride = (long long)gridDim.x * T;
  long long row = (long long)blockIdx.x * T + threadIdx.x;
  uint32_t cur[W / 4] = {};
  if (row < N) load_words<W>(sax + row * W, cur);
  __syncthreads();

  const uint32_t lane_bp =
      (uint32_t)__cvta_generic_to_shared(s_bp + threadIdx.x % kLanes);
  for (; row < N; row += stride) {
    uint32_t next[W / 4] = {};
    if (row + stride < N) load_words<W>(sax + (row + stride) * W, next);
    float acc;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      // Symbol j, zero-extended byte j % 4 of its word (one PRMT).
      const unsigned sym = __byte_perm(cur[j / 4], 0, 0x4440 | (j % 4));
      float lo, hi;
      lane_bounds(lane_bp, sym, lo, hi);
      const float d = region_gap(q[j], lo, hi);
      acc = j ? __fadd_rn(acc, __fmul_rn(d, d)) : __fmul_rn(d, d);
    }
    out[row] = __fmul_rn(scale, acc);
#pragma unroll
    for (int c = 0; c < W / 4; ++c) cur[c] = next[c];
  }
}

// The single query's grid: as many blocks as the card holds at once (at
// most blocks_per_sm an SM, where that is set), or one a row tile where N
// is smaller.
template <int W, int T>
int launch_single(const Launch& a) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lb_single_kernel<W, T>, T, 0);
  if (err != cudaSuccess) return (int)err;
  if (a.blocks_per_sm > 0 && a.blocks_per_sm < per_sm)
    per_sm = a.blocks_per_sm;
  const long long tiles = (a.N + T - 1) / T;
  const long long blocks = tiles < (long long)sms * per_sm
                               ? tiles : (long long)sms * per_sm;
  lb_single_kernel<W, T><<<(unsigned)blocks, T, 0, a.stream>>>(
      (const float*)a.qpaa, (const uint8_t*)a.sax, (const float*)a.bpp,
      (float*)a.out, a.N, a.n_bpp, a.scale);
  return (int)cudaGetLastError();
}

template <int W, int kForm, int T, int R>
int launch_batch(const Launch& a) {
  constexpr long long tile = (long long)T * R;
  const long long blocks = (a.N + tile - 1) / tile;
  lb_kernel<W, kForm, T, R><<<(unsigned)blocks, T, 0, a.stream>>>(
      (const float*)a.qpaa, (const uint8_t*)a.sax, (const float*)a.bpp,
      (const int32_t*)a.block_len, (float*)a.out, a.Q, a.N, a.n_bpp,
      a.block_n, a.scale, a.block_q);
  return (int)cudaGetLastError();
}

// The admitted (T, R) of the batch forms: T in {128, 256}, R in {2, the
// width's default}.
template <int W, int kForm>
int launch_batch_shape(const Launch& a) {
  const int rows = a.rows ? a.rows : kRows<W>;
  if (a.block_q < 1 || a.block_q > kMaxQueryBlock)
    return (int)cudaErrorInvalidValue;
  if (rows == kRows<W>) {
    if (a.threads == 128) return launch_batch<W, kForm, 128, kRows<W>>(a);
    if (a.threads == 256) return launch_batch<W, kForm, 256, kRows<W>>(a);
  }
  if constexpr (kRows<W> != 2) {
    if (rows == 2) {
      if (a.threads == 128) return launch_batch<W, kForm, 128, 2>(a);
      if (a.threads == 256) return launch_batch<W, kForm, 256, 2>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace paris_lb {

template <int W>
int launch_w(int form, const Launch& a) {
  if (form == kSingle) {  // T in {256, 512}
    if (a.threads == 256) return launch_single<W, 256>(a);
    if (a.threads == 512) return launch_single<W, 512>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (form == kMasked) return launch_batch_shape<W, kMasked>(a);
  return launch_batch_shape<W, kBatch>(a);
}

template int launch_w<PARIS_LB_W>(int form, const Launch& a);

}  // namespace paris_lb

#else  // the C entries

namespace {

using paris_lb::kBatch;
using paris_lb::kMasked;
using paris_lb::kSingle;
using paris_lb::launch_w;

int launch(int form, const paris_lb::Launch& a, int w) {
  if (a.Q == 0 || a.N == 0) return (int)cudaGetLastError();
  if (a.n_bpp < 2 || a.n_bpp > 257 || (form == kMasked && a.block_n <= 0))
    return (int)cudaErrorInvalidValue;
  switch (w) {
    case 4:
      return launch_w<4>(form, a);
    case 8:
      return launch_w<8>(form, a);
    case 16:
      return launch_w<16>(form, a);
    case 32:
      return launch_w<32>(form, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lower_bound_sq_batch_launch(const void* qpaa, const void* sax,
                                           const void* bpp, void* out, int Q,
                                           long long N, int w, int n_bpp,
                                           float scale, int block_q,
                                           int threads, int rows,
                                           void* stream) {
  return launch(kBatch,
                {qpaa, sax, bpp, nullptr, out, Q, N, n_bpp, 0, scale, block_q,
                 threads, rows, 0, (cudaStream_t)stream},
                w);
}

extern "C" int lower_bound_sq_launch(const void* qpaa, const void* sax,
                                     const void* bpp, void* out, long long N,
                                     int w, int n_bpp, float scale,
                                     int threads, int blocks_per_sm,
                                     void* stream) {
  return launch(kSingle,
                {qpaa, sax, bpp, nullptr, out, 1, N, n_bpp, 0, scale, 1,
                 threads, 0, blocks_per_sm, (cudaStream_t)stream},
                w);
}

extern "C" int lower_bound_sq_multi_launch(const void* qpaa, const void* sax,
                                           const void* bpp,
                                           const void* block_len, void* out,
                                           int Q, long long N, int w,
                                           int n_bpp, int block_n, float scale,
                                           int block_q, int threads, int rows,
                                           void* stream) {
  return launch(kMasked,
                {qpaa, sax, bpp, block_len, out, Q, N, n_bpp, block_n, scale,
                 block_q, threads, rows, 0, (cudaStream_t)stream},
                w);
}

#endif  // PARIS_LB_W
