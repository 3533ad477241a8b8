// sched_score — the online admission screening matrix and its row minimum
//
//   score[i, j] = max(frontier[j], release[i]) + drain[i, j]
//   row_min[i]  = min_j score[i, j]
//
// for A queued apps (rows i) against C cores (columns j): drain (A, C),
// frontier (C,), release (A,), score (A, C), row_min (A,), all float32 and
// contiguous.
//
// Replaces the TPU kernel src/repro/kernels/sched_score.py:sched_score
// (Pallas body _score_kernel), which padded A and C to 128 and ran one
// (128, 128) VMEM tile per grid cell; its caller then took the row
// minimum on the host from the whole matrix.
//
// What bounds it on this card. Every input is read once and the outputs
// written once: 4 * (2*A*C + A + C + A) bytes, about 34 KB at the online
// path's A = 16, C = 256, which the card moves in about 10 ns at
// 3.35 TB/s. The one max, one add and one compare per element are nothing
// beside that. At these sizes a launch costs far more than the bytes, and
// on the path the copies around the launch cost more than the launch: the
// design keeps the work to one launch whose one small output (A floats) is
// all the caller reads back.
//
// What the design does about it.
//  * One warp per app row, 8 rows per block (256 threads), a flat grid of
//    ceil(A / 8) blocks. release[i] is loaded once per warp.
//  * Lanes stride the row's C columns. Where C % 4 == 0 and drain,
//    frontier and score are 16-byte aligned, each lane moves 16 bytes a
//    load and a store (float4); otherwise one float at a time. A warp
//    reads and writes 512 (or 128) contiguous bytes of a row per step.
//  * Each lane keeps the minimum of the scores it wrote; a warp shuffle
//    reduces the 32 minima and lane 0 writes row_min[i]. The matrix is
//    still written whole, so one launch serves both outputs.
//  * A null row_min skips the minimum's store: the matrix alone.
//
// Exactness. The max follows NumPy's np.maximum rule exactly: the first
// operand when it is NaN or strictly greater, else the second. So NaN
// propagates (fmaxf would drop it), and for equal operands, -0.0 and
// +0.0 included, the release wins, as in np.maximum(frontier, release).
// The add is one round-to-nearest float32 add (__fadd_rn): nothing is
// contracted, and without --use_fast_math subnormal drains survive
// (sm_90 does not flush to zero by default). So the matrix equals the
// NumPy oracle bit for bit; only the payload of a NaN can differ.
// The minimum follows ndarray.min(axis=1): a NaN anywhere in the row makes
// it NaN (fminf would drop it), written out as the max is. It selects one
// of the row's values, so it equals the row's minimum under ==, whatever
// order the lanes and the shuffle take; between -0.0 and +0.0, which are
// equal, the sign it returns is not pinned.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 8;                 // rows (warps) per block
constexpr int kThreads = 32 * kRows;

__device__ __forceinline__ float max_np(float f, float r) {
  return (isnan(f) || f > r) ? f : r;    // np.maximum(f, r)
}

__device__ __forceinline__ float min_nan(float m, float s) {
  return (isnan(m) || m < s) ? m : s;    // NaN from either side wins
}

__device__ __forceinline__ float score1(float f, float r, float d) {
  return __fadd_rn(max_np(f, r), d);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sched_score_kernel(const float* __restrict__ drain,
                   const float* __restrict__ frontier,
                   const float* __restrict__ release,
                   float* __restrict__ score, float* __restrict__ row_min,
                   int A, int C) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (i >= A) return;                    // whole warps leave together
  const float r = __ldg(release + i);
  const long long base = static_cast<long long>(i) * C;
  float m = CUDART_INF_F;
  if (kVec) {
    const int c4 = C >> 2;
    const float4* d4 = reinterpret_cast<const float4*>(drain + base);
    const float4* f4 = reinterpret_cast<const float4*>(frontier);
    float4* s4 = reinterpret_cast<float4*>(score + base);
    for (int j = lane; j < c4; j += 32) {
      const float4 d = __ldg(d4 + j);
      const float4 f = __ldg(f4 + j);
      float4 s;
      s.x = score1(f.x, r, d.x);
      s.y = score1(f.y, r, d.y);
      s.z = score1(f.z, r, d.z);
      s.w = score1(f.w, r, d.w);
      s4[j] = s;
      m = min_nan(min_nan(m, s.x), min_nan(s.y, min_nan(s.z, s.w)));
    }
  } else {
    for (int j = lane; j < C; j += 32) {
      const float s = score1(__ldg(frontier + j), r,
                             __ldg(drain + base + j));
      score[base + j] = s;
      m = min_nan(m, s);
    }
  }
  if (row_min == nullptr) return;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, w));
  if (lane == 0) row_min[i] = m;
}

__global__ void empty_kernel() {}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The caller has checked shapes, types and contiguity, that A and C are
// both non-zero and, for vec != 0, that C % 4 == 0 and drain, frontier and
// score are 16-byte aligned (kernels/sched_score.py:vector_path). row_min
// may be null (the matrix alone).
extern "C" int sched_score(const void* drain, const void* frontier,
                           const void* release, void* score, void* row_min,
                           int A, int C, int vec, void* stream) {
  const dim3 grid((A + kRows - 1) / kRows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(drain);
  const auto* f = static_cast<const float*>(frontier);
  const auto* r = static_cast<const float*>(release);
  auto* out = static_cast<float*>(score);
  auto* mins = static_cast<float*>(row_min);
  if (vec)
    sched_score_kernel<true><<<grid, kThreads, 0, s>>>(d, f, r, out, mins,
                                                       A, C);
  else
    sched_score_kernel<false><<<grid, kThreads, 0, s>>>(d, f, r, out, mins,
                                                        A, C);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on sched_score's grid for A rows: the launch floor that
// chip_smoke.py times beside the kernel. Returns cudaGetLastError().
extern "C" int sched_score_empty(int A, void* stream) {
  empty_kernel<<<(A + kRows - 1) / kRows, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sched_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
