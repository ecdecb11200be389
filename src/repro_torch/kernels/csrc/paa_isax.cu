// paa_isax: (B, n) f32 series -> (B, w) uint8 iSAX symbols + (B, w) f32 PAA.
//
// Replaces the TPU kernel repro/kernels/paa_isax.py::_paa_isax_kernel
// (paa_isax_pallas, pallas_call at :62), which reads a (block_b, n) tile into
// VMEM and reduces it there.
//
// Bound on the H100: memory. The kernel reads every series once (B*n*4 bytes,
// 17.2 GB at B = 2^24, n = 256) and writes 5 bytes per segment; the work per
// byte read is one add. Design: one thread per (series, segment), in blocks
// of T threads (by default 256; the wrapper picks T among 128, 256, 512 and
// 1024, from the H100 table of repro_torch/core/tuning.py or the caller: a
// thread's sums do not depend on T, so every T gives the same bits). The
// thread sums its n/w values in the order the plain version and the
// reference use (windows of 32 left to right, then the window totals), so
// PAA and symbols are bit-identical to both; the segment is read with
// 16-byte loads when the segment length allows, and a warp covers 32/w whole
// series, so each warp reads contiguous memory. The symbol is a binary search
// (count of breakpoints strictly below the value) over the breakpoint table
// staged in shared memory. With normalize != 0 the w threads of one series
// (w a power of two <= 32, so they sit in one warp) combine their sums by
// warp shuffles into the series' mean and variance and z-normalize as the TPU
// kernel does, (x - mean) * rsqrt(var + 1e-16); the main path z-norms before
// the kernel and passes normalize = 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float group_sum(float v, int w) {
  // Butterfly over the w lanes of one series (w divides 32, groups aligned).
  for (int off = w >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kVec4>
__device__ __forceinline__ float segment_sum(const float* __restrict__ seg_ptr,
                                             int seg, float shift,
                                             float scale, bool live) {
  // Sum of (x - shift) * scale over one segment, in the plain version's
  // order (isax.sum_last): windows of 32 values left to right, then the
  // window totals left to right. With shift = 0 and scale = 1 the products
  // are exact. Segments up to 32 * 32 values (checked by the wrapper).
  if (!live) return 0.f;
  float total = 0.f, acc = 0.f;
  auto add = [&](int i, float v) {
    const float x = __fmul_rn(__fsub_rn(v, shift), scale);
    acc = (i % 32 == 0) ? x : __fadd_rn(acc, x);
    if (i % 32 == 31 || i == seg - 1) total = i < 32 ? acc : __fadd_rn(total, acc);
  };
  if (kVec4) {
    const float4* p4 = reinterpret_cast<const float4*>(seg_ptr);
    for (int c = 0; c < seg / 4; ++c) {
      const float4 v = __ldg(p4 + c);
      add(4 * c, v.x);
      add(4 * c + 1, v.y);
      add(4 * c + 2, v.z);
      add(4 * c + 3, v.w);
    }
  } else {
    for (int i = 0; i < seg; ++i) add(i, __ldg(seg_ptr + i));
  }
  return total;
}

__device__ __forceinline__ float segment_sq_dev(const float* __restrict__ seg_ptr,
                                                int seg, float mu, bool live) {
  if (!live) return 0.f;
  float acc = 0.f;
  for (int i = 0; i < seg; ++i) {
    float d = __fsub_rn(__ldg(seg_ptr + i), mu);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  return acc;
}

template <bool kVec4, int T>
__global__ void __launch_bounds__(T)
paa_isax_kernel(const float* __restrict__ series, const float* __restrict__ bp,
                uint8_t* __restrict__ sax, float* __restrict__ paa,
                long long total, int n, int w, int n_bp, int normalize) {
  extern __shared__ float s_bp[];
  for (int i = threadIdx.x; i < n_bp; i += blockDim.x) s_bp[i] = bp[i];
  __syncthreads();

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < total;  // dead lanes still join the shuffles below
  const long long b = t / w;
  const int j = (int)(t - b * w);
  const int seg = n / w;
  const float* seg_ptr = series + b * (long long)n + (long long)j * seg;

  float shift = 0.f, scale = 1.f;
  if (normalize) {
    float s = group_sum(segment_sum<kVec4>(seg_ptr, seg, 0.f, 1.f, live), w);
    shift = __fdiv_rn(s, (float)n);
    float v = group_sum(segment_sq_dev(seg_ptr, seg, shift, live), w);
    scale = rsqrtf(__fadd_rn(__fdiv_rn(v, (float)n), 1e-16f));
  }
  if (!live) return;
  const float p =
      __fdiv_rn(segment_sum<kVec4>(seg_ptr, seg, shift, scale, true),
                (float)seg);

  // Lower-bound search: the first breakpoint >= p; its index is the count
  // of breakpoints strictly below p.
  int lo = 0, hi = n_bp;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (s_bp[mid] < p) lo = mid + 1; else hi = mid;
  }
  sax[t] = (uint8_t)lo;
  paa[t] = p;
}

template <int T>
int launch_t(const void* series, const void* bp, void* sax, void* paa,
             long long total, int n, int w, int n_bp, int normalize,
             cudaStream_t s) {
  const long long blocks = (total + T - 1) / T;
  const int seg = n / w;
  const bool vec4 = seg % 4 == 0 && ((uintptr_t)series & 15) == 0;
  const size_t smem = (size_t)(n_bp > 0 ? n_bp : 1) * sizeof(float);
  if (vec4)
    paa_isax_kernel<true, T><<<(unsigned)blocks, T, smem, s>>>(
        (const float*)series, (const float*)bp, (uint8_t*)sax, (float*)paa,
        total, n, w, n_bp, normalize);
  else
    paa_isax_kernel<false, T><<<(unsigned)blocks, T, smem, s>>>(
        (const float*)series, (const float*)bp, (uint8_t*)sax, (float*)paa,
        total, n, w, n_bp, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paa_isax_launch(const void* series, const void* bp, void* sax,
                               void* paa, long long B, int n, int w, int n_bp,
                               int normalize, int threads, void* stream) {
  if (w <= 0 || n % w || n / w > 32 * 32 || n_bp > 255 ||
      (normalize && (w > 32 || (w & (w - 1)))))
    return (int)cudaErrorInvalidValue;
  const long long total = B * w;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (threads) {  // the admitted block sizes
    case 128:
      return launch_t<128>(series, bp, sax, paa, total, n, w, n_bp, normalize,
                           s);
    case 256:
      return launch_t<256>(series, bp, sax, paa, total, n, w, n_bp, normalize,
                           s);
    case 512:
      return launch_t<512>(series, bp, sax, paa, total, n, w, n_bp, normalize,
                           s);
    case 1024:
      return launch_t<1024>(series, bp, sax, paa, total, n, w, n_bp,
                            normalize, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
