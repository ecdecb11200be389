// Squared Euclidean distances by the direct difference sum (not the
// |a|^2 - 2ab + |b|^2 matrix form). Two C entries, each with its own wrapper
// and launch count.
//
// euclid_sq_gather: (Q, n) f32 queries x raw (N, n) f32 rows at (Q, R) int32
// positions -> (Q, R) f32 squared distances.
//
// Replaces the TPU kernel repro/kernels/euclidean.py::_euclid_kernel
// (euclid_sq_pallas, pallas_call at :40). On the TPU the RDC rounds gather
// the candidate rows with an XLA take and then run the kernel once per query
// under vmap; here the gather is fused in, so the (Q, R, n) gathered copy
// never exists. Positions shared by every query (the ADS+ serial scan and
// the exactness fallback) come with pos_row_stride = 0. A position is
// clamped to [0, N - 1], as the reference's take(..., mode="clip"): the
// NO_POS = -1 sentinel reads row 0.
//
// Bound on the H100: memory. One RDC round at Q = 64, R = 4096, n = 256
// reads 268 MB of scattered rows (80 us at 3.35 TB/s) for 3n fp32 operations
// per row. Design: a block of T threads (by default 256) serves one query,
// whose n values are staged in shared memory; each warp takes RPW
// candidate rows (by default 4) and each lane reads 16-byte pieces of
// them, so one row is read as whole 512-byte segments, and the loads of all
// RPW rows are in flight together. Lanes sum their pieces, then a butterfly
// of warp shuffles sums the lanes. The summation order differs from the
// plain version's, so the two agree to rounding (relative error near 1e-7),
// not bit for bit. T and RPW are chosen at each launch by the wrapper (from
// the H100 table of repro_torch/core/tuning.py or the caller) among the
// pairs instantiated below: each row is still summed by one warp, its lane
// l taking pieces l, l + 32, ..., in the same shuffle tree, so every
// admitted shape gives the default's bits.
//
// euclid_min: (n,) f32 query x (B, n) f32 rows -> the smallest squared
// distance and its row, the first row winning ties. Replaces the TPU kernel
// repro/kernels/euclidean.py::_euclid_min_kernel (euclid_min_pallas,
// pallas_call at :83), the brute-force (UCR-Suite) scan. The TPU kernel
// wrote one (min, argmin) per tile and left the argmin over tiles to XLA;
// here nothing carries between blocks, so the reduction ends in one 64-bit
// atomicMin on the key (distance bits << 32) | row. Distances are
// non-negative, so the bits order as the values do, and the lower row wins
// an exact tie: the result is deterministic. The (B,) distance vector never
// reaches device memory.
//
// Bound on the H100: memory. At B = 2^24, n = 256 the scan reads 17.2 GB
// (5.1 ms at 3.35 TB/s) for 3n fp32 operations per row. Design: a grid of at
// most kMaxGrid blocks of kThreads threads strides over the rows; each warp
// takes kRowsPerWarp rows at a time and reads them as euclid_sq_gather
// does (16-byte pieces per lane, all rows' loads in flight together), keeps
// its running minimum key in a register, and each block makes one
// atomicMin. The sums run in another order than the plain version's, so
// distances agree to rounding. Its shape stays fixed (kThreads = 256,
// kRowsPerWarp = 4).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kVec4, int T, int RPW>
__global__ void __launch_bounds__(T)
euclid_gather_kernel(const float* __restrict__ queries,
                     const float* __restrict__ raw,
                     const int32_t* __restrict__ positions,
                     float* __restrict__ out, int R, long long N, int n,
                     long long pos_row_stride) {
  constexpr int kWarps = T / 32;
  extern __shared__ float s_q[];
  const int q = blockIdx.y;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_q[i] = queries[(long long)q * n + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + warp) * RPW;
  if (r0 >= R) return;  // warp-uniform: the shuffles below stay full-warp

  const float* rows[RPW];
  float acc[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = min(r0 + k, R - 1);  // a tail warp recomputes row R - 1
    long long p = positions[(long long)q * pos_row_stride + r];
    p = p < 0 ? 0 : (p >= N ? N - 1 : p);
    rows[k] = raw + p * n;
    acc[k] = 0.f;
  }

  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(s_q);
    for (int c = lane; c < n / 4; c += 32) {
      const float4 qv = q4[c];
      float4 x[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k)
        x[k] = __ldg(reinterpret_cast<const float4*>(rows[k]) + c);
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const float dx = x[k].x - qv.x, dy = x[k].y - qv.y;
        const float dz = x[k].z - qv.z, dw = x[k].w - qv.w;
        acc[k] += dx * dx + dy * dy + dz * dz + dw * dw;
      }
    }
  } else {
    for (int c = lane; c < n; c += 32) {
      const float qv = s_q[c];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const float d = __ldg(rows[k] + c) - qv;
        acc[k] += d * d;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < RPW; ++k)
      if (r0 + k < R) out[(long long)q * R + r0 + k] = acc[k];
  }
}

template <int T, int RPW>
int launch_gather(const void* queries, const void* raw, const void* positions,
                  void* out, int Q, int R, long long N, int n,
                  long long pos_row_stride, cudaStream_t s) {
  constexpr int rows_per_block = T / 32 * RPW;
  dim3 grid((R + rows_per_block - 1) / rows_per_block, Q);
  const size_t smem = (size_t)n * sizeof(float);
  const bool vec4 = n % 4 == 0 && ((uintptr_t)raw & 15) == 0 &&
                    ((uintptr_t)queries & 15) == 0;
  if (vec4)
    euclid_gather_kernel<true, T, RPW><<<grid, T, smem, s>>>(
        (const float*)queries, (const float*)raw, (const int32_t*)positions,
        (float*)out, R, N, n, pos_row_stride);
  else
    euclid_gather_kernel<false, T, RPW><<<grid, T, smem, s>>>(
        (const float*)queries, (const float*)raw, (const int32_t*)positions,
        (float*)out, R, N, n, pos_row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int euclid_sq_gather_launch(const void* queries, const void* raw,
                                       const void* positions, void* out,
                                       int Q, int R, long long N, int n,
                                       long long pos_row_stride,
                                       int threads, int rows_per_warp,
                                       void* stream) {
  if (Q == 0 || R == 0) return (int)cudaGetLastError();
  if (N <= 0 || n <= 0 || Q > 65535 || (size_t)n * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // The admitted shapes: T in {128, 256} x RPW in {2, 4, 8}.
#define PARIS_GATHER(T, RPW)                                               \
  if (threads == T && rows_per_warp == RPW)                                \
    return launch_gather<T, RPW>(queries, raw, positions, out, Q, R, N, n, \
                                 pos_row_stride, s);
  PARIS_GATHER(128, 2)
  PARIS_GATHER(128, 4)
  PARIS_GATHER(128, 8)
  PARIS_GATHER(256, 2)
  PARIS_GATHER(256, 4)
  PARIS_GATHER(256, 8)
#undef PARIS_GATHER
  return (int)cudaErrorInvalidValue;
}

namespace {

// euclid_min's fixed shape: kThreads a block, kRowsPerWarp rows a warp.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxGrid = 2048;  // grid-stride: a few waves of 132 SMs

__device__ __forceinline__ unsigned long long min_key(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
euclid_min_kernel(const float* __restrict__ query,
                  const float* __restrict__ data,
                  unsigned long long* __restrict__ best, long long B, int n) {
  extern __shared__ __align__(16) float s_qmin[];  // read as float4
  __shared__ unsigned long long s_best[kWarps];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_qmin[i] = query[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps * kRowsPerWarp;
  unsigned long long mine = ~0ull;
  for (long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp;
       r0 < B; r0 += step) {  // warp-uniform: the shuffles stay full-warp
    const float* rows[kRowsPerWarp];
    float acc[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const long long r = r0 + k < B ? r0 + k : B - 1;
      rows[k] = data + r * n;
      acc[k] = 0.f;
    }
    if (kVec4) {
      const float4* q4 = reinterpret_cast<const float4*>(s_qmin);
      for (int c = lane; c < n / 4; c += 32) {
        const float4 qv = q4[c];
        float4 x[kRowsPerWarp];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k)
          x[k] = __ldg(reinterpret_cast<const float4*>(rows[k]) + c);
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const float dx = x[k].x - qv.x, dy = x[k].y - qv.y;
          const float dz = x[k].z - qv.z, dw = x[k].w - qv.w;
          acc[k] += dx * dx + dy * dy + dz * dz + dw * dw;
        }
      }
    } else {
      for (int c = lane; c < n; c += 32) {
        const float qv = s_qmin[c];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const float d = __ldg(rows[k] + c) - qv;
          acc[k] += d * d;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(acc[k]) << 32) |
          (unsigned long long)(r0 + k);
      if (r0 + k < B) mine = min_key(mine, key);
    }
  }
  if (lane == 0) s_best[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = s_best[0];
    for (int i = 1; i < kWarps; ++i) m = min_key(m, s_best[i]);
    if (m != ~0ull) atomicMin(best, m);
  }
}

}  // namespace

// best must hold ~0 (all bits set) before the launch; afterwards it holds
// (distance bits << 32) | row of the first row at the smallest distance.
extern "C" int euclid_min_launch(const void* query, const void* data,
                                 void* best, long long B, int n,
                                 void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (B < 0 || B > 0xFFFFFFFFll || n <= 0 ||
      (size_t)n * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long rows_per_block = kWarps * kRowsPerWarp;
  const long long need = (B + rows_per_block - 1) / rows_per_block;
  const unsigned grid = (unsigned)(need < kMaxGrid ? need : kMaxGrid);
  const size_t smem = (size_t)n * sizeof(float);
  const bool vec4 = n % 4 == 0 && ((uintptr_t)data & 15) == 0 &&
                    ((uintptr_t)query & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    euclid_min_kernel<true><<<grid, kThreads, smem, s>>>(
        (const float*)query, (const float*)data, (unsigned long long*)best, B,
        n);
  else
    euclid_min_kernel<false><<<grid, kThreads, smem, s>>>(
        (const float*)query, (const float*)data, (unsigned long long*)best, B,
        n);
  return (int)cudaGetLastError();
}

extern "C" const char* paris_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
