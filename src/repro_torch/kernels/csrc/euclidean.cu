// Squared Euclidean distances by the direct difference sum (not the
// |a|^2 - 2ab + |b|^2 matrix form). Three C entries, each with its own
// wrapper and launch count: euclid_sq_gather, engine_round (its round form,
// noted at its entry below) and euclid_min. Every row's sum goes through
// warp_row_sums.
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

// The row of a position, clipped to [0, N - 1] as the reference's
// take(..., mode="clip"): NO_POS = -1 reads row 0.
__device__ __forceinline__ long long clip_row(long long p, long long N) {
  return p < 0 ? 0 : (p >= N ? N - 1 : p);
}

// The squared distances of RPW rows to the query staged in shared memory,
// one warp a row set: lane l sums pieces l, l + 32, ... of every row (16-byte
// pieces where kVec4), then a butterfly of shuffles sums the lanes, so every
// lane ends with each row's sum. Every kernel of this file that distances a
// row goes through here, so a row's bits never depend on which kernel, launch
// shape or warp computed them.
template <bool kVec4, int RPW>
__device__ __forceinline__ void warp_row_sums(const float* s_q,
                                              const float* const* rows,
                                              float* acc, int n, int lane) {
#pragma unroll
  for (int k = 0; k < RPW; ++k) acc[k] = 0.f;
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
}

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
    rows[k] = raw + clip_row(positions[(long long)q * pos_row_stride + r],
                             N) * n;
  }
  warp_row_sums<kVec4, RPW>(s_q, rows, acc, n, lane);
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

// The round form's fixed shape: a block of kRoundThreads threads takes
// kRoundThreads candidates of one query, one a thread, and its warps take
// the masked-in ones kRoundRPW at a time. Its launch bound asks for one
// block an SM, not more: at ptxas's own register target (64) some forms
// spilled; with the registers they need (about 90) two blocks fit an SM.
constexpr int kRoundThreads = 256;
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kRoundRPW = 4;

// One round of the batch engine's loop (see engine_round_launch). The
// state words, 3Q + 2 of them, are zero between launches: per query the
// complement of the smallest (distance bits << 32) | column key of the round
// (0: no candidate), the masked count, and the complement of the smallest
// skipped bound's bits (0: none); then the blocks that finished, and the
// exit flag, which the launch writes.
struct RoundArgs {
  const int32_t* cols;   // round r's columns, row stride ld_list
  const float* bounds;   // and their bounds, the same layout
  long long ld_list;
  int width;             // columns in the list's round (< rs at its end)
  int rs;
  int r;
  const int32_t* pos_table;  // candidate row -> file position
  const float* raw;          // (N, n) file-order rows
  long long N;
  int n;
  const float* queries;      // (Q, n) z-normed
  float* top_d;              // (Q, k), row stride ld_d
  int32_t* top_p;            // (Q, k), row stride ld_p
  long long ld_d, ld_p;
  int k;
  int32_t* reads;
  int32_t* updates;
  const float* eps;          // tiered: (Q,) (1 + eps)^2, (Q,) budgets,
  const int32_t* budget;     // (Q,) smallest skipped bound
  float* skip_lb;
  float* out_d;              // k > 1: (Q, rs) masked distances
  int32_t* out_p;            // and positions
  unsigned long long* state;
  int Q;
};

__device__ __forceinline__ bool masked_in(float lb, float kth, float eps,
                                          bool live) {
  // The engine's mask: lb < kth; tiered, lb * eps < kth within the budget.
  return live && __fmul_rn(lb, eps) < kth;
}

// The round form of euclid_gather_kernel: the same rows through the same
// warp_row_sums, so every distance has the bits of the gather form's.
// kMerge: k = 1, the launch merges each query's best into its result list;
// else it writes the masked (Q, rs) distances and positions for the merge.
template <bool kVec4, bool kMerge, bool kTiered>
__global__ void __launch_bounds__(kRoundThreads, 1)
euclid_gather_kernel(const RoundArgs a) {
  extern __shared__ __align__(16) float s_rq[];  // the query, read as float4
  __shared__ int s_list[kRoundThreads];
  __shared__ int32_t s_pos[kRoundThreads];
  __shared__ int s_count;
  __shared__ unsigned long long s_key[kRoundWarps];
  __shared__ unsigned s_skip[kRoundWarps];
  __shared__ bool s_last;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float kInf = __int_as_float(0x7f800000);

  // 1. Round r's exit test, on the result lists as they stood before it:
  // does any query's head bound still beat its k-th best? Every block
  // decides it alike; on false nothing is written but the flag.
  bool any = false;
  for (int i = tid; i < a.Q; i += kRoundThreads) {
    const float kth = a.top_d[i * a.ld_d + a.k - 1];
    const float head = a.bounds[i * a.ld_list];
    any |= kTiered ? masked_in(head, kth, a.eps[i], a.r < a.budget[i])
                   : head < kth;
  }
  const bool go = __syncthreads_or(any);
  if (blockIdx.x == 0 && q == 0 && tid == 0) a.state[3 * a.Q + 1] = go;
  if (!go) return;

  for (int i = tid; i < a.n; i += kRoundThreads)
    s_rq[i] = a.queries[(long long)q * a.n + i];
  if (tid == 0) s_count = 0;
  const float kth = a.top_d[q * a.ld_d + a.k - 1];
  __syncthreads();

  // 2. This block's candidates: the mask, the skipped bounds (tiered), and
  // the masked-in columns compacted into s_list, each with its position
  // (looked up here, by all its threads at once, not a warp's rows at a
  // time in step 3).
  const int j = blockIdx.x * kRoundThreads + tid;
  bool in = false;
  unsigned skip = ~0u;
  if (j < a.width) {
    const float lb = a.bounds[q * a.ld_list + j];
    if (kTiered) {
      in = masked_in(lb, kth, a.eps[q], a.r < a.budget[q]);
      if (lb < kth && !in) skip = __float_as_uint(lb);
    } else {
      in = lb < kth;
    }
  }
  if (!kMerge && j < a.rs && !in) {
    a.out_d[(long long)q * a.rs + j] = kInf;
    a.out_p[(long long)q * a.rs + j] = -1;  // NO_POS
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, in);
  int base = 0;
  if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (in) {
    const int at = base + __popc(ballot & ((1u << lane) - 1));
    s_list[at] = j;
    s_pos[at] = a.pos_table[a.cols[q * a.ld_list + j]];
  }
  if (kTiered) skip = __reduce_min_sync(0xffffffffu, skip);
  __syncthreads();
  const int count = s_count;

  // 3. The masked-in rows, kRoundRPW a warp at a time (warp-uniform, so the
  // shuffles stay full-warp); a tail recomputes the last row. Every lane
  // holds the sums, so every lane keeps the smallest key.
  unsigned long long best = ~0ull;
  for (int i0 = warp * kRoundRPW; i0 < count;
       i0 += kRoundWarps * kRoundRPW) {
    const float* rows[kRoundRPW];
    float acc[kRoundRPW];
    int col[kRoundRPW];
    int32_t pos[kRoundRPW];
#pragma unroll
    for (int k = 0; k < kRoundRPW; ++k) {
      const int at = min(i0 + k, count - 1);
      col[k] = s_list[at];
      pos[k] = s_pos[at];
      rows[k] = a.raw + clip_row(pos[k], a.N) * a.n;
    }
    warp_row_sums<kVec4, kRoundRPW>(s_rq, rows, acc, a.n, lane);
#pragma unroll
    for (int k = 0; k < kRoundRPW; ++k) {
      if (i0 + k >= count) break;
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(acc[k]) << 32) |
          (unsigned)col[k];
      best = key < best ? key : best;
      if (!kMerge && lane == 0) {
        a.out_d[(long long)q * a.rs + col[k]] = acc[k];
        a.out_p[(long long)q * a.rs + col[k]] = pos[k];
      }
    }
  }
  if (lane == 0) {
    s_key[warp] = best;
    s_skip[warp] = skip;
  }
  __syncthreads();

  // 4. One atomic a word for the block, then the last block to finish
  // (a fence, then a ticket) merges every query.
  if (tid == 0) {
    unsigned long long m = s_key[0];
    unsigned sk = s_skip[0];
    for (int w = 1; w < kRoundWarps; ++w) {
      m = s_key[w] < m ? s_key[w] : m;
      sk = s_skip[w] < sk ? s_skip[w] : sk;
    }
    if (count) {
      atomicAdd(&a.state[a.Q + q], (unsigned long long)count);
      atomicMax(&a.state[q], ~m);
    }
    if (kTiered && sk != ~0u)
      atomicMax(&a.state[2 * a.Q + q], ~(unsigned long long)sk);
    __threadfence();
    const unsigned long long blocks = (unsigned long long)gridDim.x * gridDim.y;
    s_last = atomicAdd(&a.state[3 * a.Q], 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 5. The merge, as the engine's: the round's smallest distance (the
  // lowest column on ties, as torch.argmin) replaces the incumbent only if
  // strictly smaller; reads += the masked count, updates += improvement,
  // skip_lb = min(skip_lb, smallest skipped bound). The words go back to 0.
  for (int i = tid; i < a.Q; i += kRoundThreads) {
    const unsigned long long key = ~atomicExch(&a.state[i], 0ull);
    a.reads[i] += (int32_t)atomicExch(&a.state[a.Q + i], 0ull);
    if (key != ~0ull) {
      const float d = __uint_as_float((unsigned)(key >> 32));
      const long long kth_at = i * a.ld_d + a.k - 1;
      if (d < a.top_d[kth_at]) {
        a.updates[i] += 1;
        if (kMerge) {
          a.top_d[kth_at] = d;
          a.top_p[i * a.ld_p] =
              a.pos_table[a.cols[i * a.ld_list + (unsigned)key]];
        }
      }
    }
    if (kTiered) {
      const unsigned long long sk = atomicExch(&a.state[2 * a.Q + i], 0ull);
      if (sk) {
        const float lb = __uint_as_float((unsigned)~sk);
        if (lb < a.skip_lb[i]) a.skip_lb[i] = lb;
      }
    }
  }
  if (tid == 0) a.state[3 * a.Q] = 0;
}

template <bool kMerge, bool kTiered>
void launch_round(const RoundArgs& a, bool vec4, cudaStream_t s) {
  const dim3 grid((a.rs + kRoundThreads - 1) / kRoundThreads, a.Q);
  const size_t smem = (size_t)a.n * sizeof(float);
  if (vec4)
    euclid_gather_kernel<true, kMerge, kTiered>
        <<<grid, kRoundThreads, smem, s>>>(a);
  else
    euclid_gather_kernel<false, kMerge, kTiered>
        <<<grid, kRoundThreads, smem, s>>>(a);
}

}  // namespace

// One round r of the batch engine's main loop (repro_torch/core/search.py,
// _engine_core), one launch in place of the ~20 PyTorch operations of the
// host loop's round body: the exit test, the mask, the position lookup, the
// distances of the masked-in rows, the k = 1 merge and the counters. Given
// round r's columns and bounds (views of the candidate list, row stride
// ld_list; columns past width are the list's +inf pads), the position table,
// the raw rows and the z-normed queries, it updates top_d/top_p (k = 1) or
// writes the masked (Q, rs) distances and positions (k > 1, +inf and
// NO_POS outside the mask, for the host's merge), adds each query's masked
// count to reads and its improvement to updates, folds the skipped bounds
// into skip_lb (tiered: eps, budget and skip_lb given), and writes the exit
// flag to state[3Q + 1]. Where the exit test fails it writes the flag alone.
// state holds 3Q + 2 zeroed words and is zero again after the launch.
//
// Replaces no TPU kernel: the reference runs this loop body as XLA ops in
// a jitted while_loop; its distances are the TPU kernel _euclid_kernel's
// (repro/kernels/euclidean.py, euclid_sq_pallas), as euclid_sq_gather's are.
//
// Bound on the H100: memory, the masked-in rows (n floats each: the engine's
// reads) plus the round's columns and bounds (Q x rs x 8 bytes, 2 MiB at
// Q = 64, rs = 4096); the mask keeps a few hundred of a query's 4096
// candidates in a hard batch, so a launch is short and its latency counts.
// Design: the grid is (rs / 256, Q); a block's threads test one candidate
// each and compact the masked-in ones, with their positions, in shared
// memory, its warps distance them kRoundRPW at a time through
// warp_row_sums (the gather form's lane pieces and shuffle tree, so the
// bits are its bits), and each block meets the others in one 64-bit
// atomicMax of the complement of (distance bits << 32) | column per query,
// which orders as torch.argmin's first column. No
// block may read a k-th best that the launch has changed, and every block
// reads all Q for the exit test, so the merge waits for the last block to
// finish (a fence and a ticket) and runs there.
extern "C" int engine_round_launch(
    const void* cols, const void* bounds, long long ld_list, int width,
    int rs, int r, const void* pos_table, const void* raw, long long N,
    int n, const void* queries, void* top_d, long long ld_d, void* top_p,
    long long ld_p, int k, void* reads, void* updates, const void* eps,
    const void* budget, void* skip_lb, void* out_d, void* out_p,
    void* state, int Q, void* stream) {
  if (Q == 0) return (int)cudaGetLastError();
  if (N <= 0 || n <= 0 || Q > 65535 || rs <= 0 || width <= 0 ||
      width > rs || k < 1 || (k > 1) != (out_d != nullptr) ||
      (size_t)n * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  RoundArgs a;
  a.cols = (const int32_t*)cols;
  a.bounds = (const float*)bounds;
  a.ld_list = ld_list;
  a.width = width;
  a.rs = rs;
  a.r = r;
  a.pos_table = (const int32_t*)pos_table;
  a.raw = (const float*)raw;
  a.N = N;
  a.n = n;
  a.queries = (const float*)queries;
  a.top_d = (float*)top_d;
  a.top_p = (int32_t*)top_p;
  a.ld_d = ld_d;
  a.ld_p = ld_p;
  a.k = k;
  a.reads = (int32_t*)reads;
  a.updates = (int32_t*)updates;
  a.eps = (const float*)eps;
  a.budget = (const int32_t*)budget;
  a.skip_lb = (float*)skip_lb;
  a.out_d = (float*)out_d;
  a.out_p = (int32_t*)out_p;
  a.state = (unsigned long long*)state;
  a.Q = Q;
  const bool vec4 = n % 4 == 0 && ((uintptr_t)raw & 15) == 0 &&
                    ((uintptr_t)queries & 15) == 0;
  const bool tiered = eps != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1 && tiered) launch_round<true, true>(a, vec4, s);
  else if (k == 1) launch_round<true, false>(a, vec4, s);
  else if (tiered) launch_round<false, true>(a, vec4, s);
  else launch_round<false, false>(a, vec4, s);
  return (int)cudaGetLastError();
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
    for (int k = 0; k < kRowsPerWarp; ++k)
      rows[k] = data + (r0 + k < B ? r0 + k : B - 1) * n;
    warp_row_sums<kVec4, kRowsPerWarp>(s_qmin, rows, acc, n, lane);
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
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
