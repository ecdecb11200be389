// The squared PAA-to-iSAX lower bound,
// (n/w) * sum_j max(q_j - hi_j, lo_j - q_j, 0)^2, of (Q, w) f32 query PAA
// against (N, w) uint8 SAX rows -> (Q, N) f32. One templated kernel serves
// three C entries, each with its own wrapper and launch count:
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
// In the batch forms each thread owns R rows (4 for w <= 16, 2 for w = 32:
// 2w bound registers a row) of a 128-thread block, at base + t + i * 128,
// so every warp store still covers 128 contiguous bytes; each row's (lo, hi)
// bounds are looked up once, from the breakpoint table in shared memory,
// into registers. Queries are staged in shared memory 64 at a time; each
// query's w values are read as float4 broadcasts once for all R rows, and
// the R accumulators give the issue slots independent work. The output
// pointer advances by N a query. A thread with a row past N or (masked
// form) a pad row takes a guarded copy of the loop in which such rows do
// no arithmetic. The single-query form is the same code at one row a thread
// in 256-thread blocks: it is bound by bytes, and four rows' bound registers
// would cut the occupancy that hides its load latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueryBlock = 64;
constexpr int kSymbols = 256;  // uint8 symbols: at most 257 padded breakpoints

// The three entries' forms of the kernel.
constexpr int kBatch = 0, kMasked = 1, kSingle = 2;

// Rows a thread and threads a block. The batch forms are bound by the issue
// rate and share each query's overhead over R rows (2w bound registers a
// row); the single query is bound by bytes and keeps one row a thread in
// 256-thread blocks, for the occupancy that hides its load latency.
template <int W, int kForm>
constexpr int kRows = kForm == kSingle ? 1 : W == 32 ? 2 : 4;
template <int kForm>
constexpr int kThreads = kForm == kSingle ? 256 : 128;
// Blocks an SM must hold in the batch forms, passed to ptxas through
// __launch_bounds__ as a register cap, from a budget of registers a thread:
// 2wR bounds, w query values and 24 for the sums, pointers and loop state
// (168 at w = 16: 3 blocks, 12 warps an SM). Left to itself ptxas took 183
// for one of the two batch forms, room for only 2 blocks, and that form ran
// 5% slower than the other at 168. The single-query form has no such cap:
// with one, ptxas chose a schedule that ran 13-20% slower.
template <int W, int kForm>
constexpr int kMinBlocks =
    65536 / (kThreads<kForm> * (2 * W * kRows<W, kForm> + W + 24));

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

// kForm: kBatch, kSingle, or kMasked, the packed multi-component form with
// block_len / block_n.
template <int W, int kForm>
__device__ __forceinline__ void lb_block(
    const float* __restrict__ qpaa, const uint8_t* __restrict__ sax,
    const float* __restrict__ bpp, const int32_t* __restrict__ block_len,
    float* __restrict__ out, int Q, long long N, int n_bpp, int block_n,
    float scale) {
  constexpr int R = kRows<W, kForm>, T = kThreads<kForm>;
  __shared__ float s_bp[kSymbols + 1];  // bp[s] .. bp[s + 1] bound symbol s
  __shared__ __align__(16) float s_q[kQueryBlock * W];
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
  for (int q0 = 0; q0 < Q; q0 += kQueryBlock, o += kQueryBlock * N) {
    const int nq = min(kQueryBlock, Q - q0);
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

template <int W, int kForm>
__global__ void __launch_bounds__(kThreads<kForm>, kMinBlocks<W, kForm>)
lb_kernel(const float* __restrict__ qpaa, const uint8_t* __restrict__ sax,
          const float* __restrict__ bpp, const int32_t* __restrict__ block_len,
          float* __restrict__ out, int Q, long long N, int n_bpp, int block_n,
          float scale) {
  lb_block<W, kForm>(qpaa, sax, bpp, block_len, out, Q, N, n_bpp, block_n,
                     scale);
}

template <int W>
__global__ void __launch_bounds__(kThreads<kSingle>)
lb_single_kernel(const float* __restrict__ qpaa,
                 const uint8_t* __restrict__ sax,
                 const float* __restrict__ bpp, float* __restrict__ out,
                 long long N, int n_bpp, float scale) {
  lb_block<W, kSingle>(qpaa, sax, bpp, nullptr, out, 1, N, n_bpp, 0, scale);
}

template <int W, int kForm>
int launch_w(const void* qpaa, const void* sax, const void* bpp,
             const void* block_len, void* out, int Q, long long N, int n_bpp,
             int block_n, float scale, cudaStream_t s) {
  constexpr long long tile = (long long)kThreads<kForm> * kRows<W, kForm>;
  const long long blocks = (N + tile - 1) / tile;
  if constexpr (kForm == kSingle)
    lb_single_kernel<W><<<(unsigned)blocks, kThreads<kForm>, 0, s>>>(
        (const float*)qpaa, (const uint8_t*)sax, (const float*)bpp,
        (float*)out, N, n_bpp, scale);
  else
    lb_kernel<W, kForm><<<(unsigned)blocks, kThreads<kForm>, 0, s>>>(
        (const float*)qpaa, (const uint8_t*)sax, (const float*)bpp,
        (const int32_t*)block_len, (float*)out, Q, N, n_bpp, block_n, scale);
  return (int)cudaGetLastError();
}

template <int kForm>
int launch(const void* qpaa, const void* sax, const void* bpp,
           const void* block_len, void* out, int Q, long long N, int w,
           int n_bpp, int block_n, float scale, void* stream) {
  if (Q == 0 || N == 0) return (int)cudaGetLastError();
  if (n_bpp < 2 || n_bpp > kSymbols + 1 || (kForm == kMasked && block_n <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 4:
      return launch_w<4, kForm>(qpaa, sax, bpp, block_len, out, Q, N, n_bpp,
                                block_n, scale, s);
    case 8:
      return launch_w<8, kForm>(qpaa, sax, bpp, block_len, out, Q, N, n_bpp,
                                block_n, scale, s);
    case 16:
      return launch_w<16, kForm>(qpaa, sax, bpp, block_len, out, Q, N,
                                 n_bpp, block_n, scale, s);
    case 32:
      return launch_w<32, kForm>(qpaa, sax, bpp, block_len, out, Q, N,
                                 n_bpp, block_n, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lower_bound_sq_batch_launch(const void* qpaa, const void* sax,
                                           const void* bpp, void* out, int Q,
                                           long long N, int w, int n_bpp,
                                           float scale, void* stream) {
  return launch<kBatch>(qpaa, sax, bpp, nullptr, out, Q, N, w, n_bpp, 0, scale,
                        stream);
}

extern "C" int lower_bound_sq_launch(const void* qpaa, const void* sax,
                                     const void* bpp, void* out, long long N,
                                     int w, int n_bpp, float scale,
                                     void* stream) {
  return launch<kSingle>(qpaa, sax, bpp, nullptr, out, 1, N, w, n_bpp, 0,
                         scale, stream);
}

extern "C" int lower_bound_sq_multi_launch(const void* qpaa, const void* sax,
                                           const void* bpp,
                                           const void* block_len, void* out,
                                           int Q, long long N, int w,
                                           int n_bpp, int block_n, float scale,
                                           void* stream) {
  return launch<kMasked>(qpaa, sax, bpp, block_len, out, Q, N, w, n_bpp,
                         block_n, scale, stream);
}
