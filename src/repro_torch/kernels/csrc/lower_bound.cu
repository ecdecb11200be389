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
//       here one thread reads one (N, w) row, so one layout serves both.
//   lower_bound_sq_multi_launch  Q queries x N_pad rows of a packed multi-
//       component buffer. Replaces _lb_kernel_batch_masked (:77,
//       lower_bound_sq_multi_pallas, pallas_call at :150): row r is real iff
//       r % block_n < block_len[r / block_n]; every other row (component
//       pads, dead tail blocks with block_len == 0) gets +inf for every query.
//
// The TPU kernels took the SAX transposed, (w, N), so that candidates fill
// the 128-wide lanes; here the index's own (N, w) row layout is read
// directly, one 16-byte row per thread, and no transposed copy exists.
//
// Bound on the H100: at Q = 64, N = 2^24, w = 16 the batch forms write 4.3 GB
// and read 0.27 GB (1.36 ms at 3.35 TB/s) and do 6w + 1 = 97 fp32 operations
// per (query, row) pair (104 G ops, 1.55 ms at 67 TFLOP/s), so the two bounds
// are within 15% of each other. The single-query form is bound by bytes:
// 16 B read and 4 B written per row (0.34 GB at N = 2^24, 0.10 ms) against
// 97 operations per row (1.6 G ops, 0.024 ms).
//
// Design: one thread per SAX row loads its w symbols with vector loads and
// looks up the row's (lo, hi) region bounds once, from the padded breakpoint
// table in shared memory, into registers; then it loops over the queries,
// which are staged in shared memory 64 at a time, and writes one bound per
// query. Consecutive threads write consecutive floats of one (Q, N) row, so
// every store is coalesced. The products and sums use __fmul_rn / __fadd_rn,
// so no multiply-add is contracted: each term is rounded as the plain
// version's acc + d * d, and the result is bit-identical to it. Candidate
// order (and so the engines' rounds and reads) depends on exact ties between
// these bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueryBlock = 64;

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
#pragma unroll
    for (int k = 0; k < W; ++k) sym[k] = __ldg(row + k);
  }
}

// kMasked: the packed multi-component form, with block_len / block_n.
template <int W, bool kMasked>
__global__ void __launch_bounds__(kThreads)
lb_kernel(const float* __restrict__ qpaa, const uint8_t* __restrict__ sax,
          const float* __restrict__ bpp, const int32_t* __restrict__ block_len,
          float* __restrict__ out, int Q, long long N, int n_bpp, int block_n,
          float scale) {
  extern __shared__ float smem[];
  float* s_bp = smem;                      // n_bpp padded breakpoints
  float* s_q = smem + ((n_bpp + 3) & ~3);  // kQueryBlock * W query values
  for (int i = threadIdx.x; i < n_bpp; i += blockDim.x) s_bp[i] = bpp[i];
  __syncthreads();

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < N;
  bool real = live;
  if (kMasked && live)
    real = (int)(row % block_n) < __ldg(block_len + row / block_n);
  float lo[W], hi[W];
  if (real) {
    uint8_t sym[W];
    load_symbols<W>(sax + row * W, sym);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      lo[j] = s_bp[sym[j]];
      hi[j] = s_bp[sym[j] + 1];
    }
  }

  for (int q0 = 0; q0 < Q; q0 += kQueryBlock) {
    const int nq = min(kQueryBlock, Q - q0);
    __syncthreads();  // the previous block of queries is no longer read
    for (int i = threadIdx.x; i < nq * W; i += blockDim.x)
      s_q[i] = qpaa[(long long)q0 * W + i];
    __syncthreads();
    if (!live) continue;
    if (kMasked && !real) {
      for (int qi = 0; qi < nq; ++qi)
        out[(long long)(q0 + qi) * N + row] = __int_as_float(0x7f800000);
      continue;
    }
    for (int qi = 0; qi < nq; ++qi) {
      const float* q = s_q + qi * W;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float d = fmaxf(fmaxf(__fsub_rn(q[j], hi[j]), __fsub_rn(lo[j], q[j])),
                        0.f);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
      out[(long long)(q0 + qi) * N + row] = __fmul_rn(scale, acc);
    }
  }
}

template <int W, bool kMasked>
int launch_w(const void* qpaa, const void* sax, const void* bpp,
             const void* block_len, void* out, int Q, long long N, int n_bpp,
             int block_n, float scale, cudaStream_t s) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  const size_t smem =
      (size_t)(((n_bpp + 3) & ~3) + kQueryBlock * W) * sizeof(float);
  lb_kernel<W, kMasked><<<(unsigned)blocks, kThreads, smem, s>>>(
      (const float*)qpaa, (const uint8_t*)sax, (const float*)bpp,
      (const int32_t*)block_len, (float*)out, Q, N, n_bpp, block_n, scale);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int launch(const void* qpaa, const void* sax, const void* bpp,
           const void* block_len, void* out, int Q, long long N, int w,
           int n_bpp, int block_n, float scale, void* stream) {
  if (Q == 0 || N == 0) return (int)cudaGetLastError();
  if (n_bpp > 257 || (kMasked && block_n <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 4:
      return launch_w<4, kMasked>(qpaa, sax, bpp, block_len, out, Q, N, n_bpp,
                                  block_n, scale, s);
    case 8:
      return launch_w<8, kMasked>(qpaa, sax, bpp, block_len, out, Q, N, n_bpp,
                                  block_n, scale, s);
    case 16:
      return launch_w<16, kMasked>(qpaa, sax, bpp, block_len, out, Q, N,
                                   n_bpp, block_n, scale, s);
    case 32:
      return launch_w<32, kMasked>(qpaa, sax, bpp, block_len, out, Q, N,
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
  return launch<false>(qpaa, sax, bpp, nullptr, out, Q, N, w, n_bpp, 0, scale,
                       stream);
}

extern "C" int lower_bound_sq_launch(const void* qpaa, const void* sax,
                                     const void* bpp, void* out, long long N,
                                     int w, int n_bpp, float scale,
                                     void* stream) {
  return launch<false>(qpaa, sax, bpp, nullptr, out, 1, N, w, n_bpp, 0, scale,
                       stream);
}

extern "C" int lower_bound_sq_multi_launch(const void* qpaa, const void* sax,
                                           const void* bpp,
                                           const void* block_len, void* out,
                                           int Q, long long N, int w,
                                           int n_bpp, int block_n, float scale,
                                           void* stream) {
  return launch<true>(qpaa, sax, bpp, block_len, out, Q, N, w, n_bpp, block_n,
                      scale, stream);
}
