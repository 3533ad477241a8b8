// sched_score — the online admission screening matrix
//
//   score[i, j] = max(frontier[j], release[i]) + drain[i, j]
//
// for A queued apps (rows i) against C cores (columns j): drain (A, C),
// frontier (C,), release (A,), score (A, C), all float32 and contiguous.
//
// Replaces the TPU kernel src/repro/kernels/sched_score.py:sched_score
// (Pallas body _score_kernel), which padded A and C to 128 and ran one
// (128, 128) VMEM tile per grid cell.
//
// What bounds it on this card. Every input is read once and the output
// written once: 4 * (2*A*C + A + C) bytes, about 34 KB at the online
// path's A = 16, C = 256, which the card moves in about 10 ns at
// 3.35 TB/s. The one max and one add per element are nothing beside
// that. At these sizes a launch costs far more than the bytes, so the
// design only keeps the access pattern clean and the launch small.
//
// What the design does about it.
//  * A 2-D grid of 32 x 8 thread blocks, one thread per output element:
//    threadIdx.x walks C, so a warp reads and writes 128 contiguous bytes
//    of a row of drain and score.
//  * frontier[j] and release[i] are plain read-only cached loads (__ldg):
//    a block touches 32 frontiers and 8 releases, all served from L1.
//  * No padding: the ragged edge of the last blocks is bounds-checked.
//
// Exactness. The max follows NumPy's np.maximum rule exactly: the first
// operand when it is NaN or strictly greater, else the second. So NaN
// propagates (fmaxf would drop it), and for equal operands, -0.0 and
// +0.0 included, the release wins, as in np.maximum(frontier, release).
// The add is one round-to-nearest float32 add (__fadd_rn): nothing is
// contracted, and without --use_fast_math subnormal drains survive
// (sm_90 does not flush to zero by default). Only the payload of a NaN
// result can differ from the CPU's.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;   // along C (coalesced)
constexpr int kBlockY = 8;    // along A

__global__ void __launch_bounds__(kBlockX * kBlockY)
sched_score_kernel(const float* __restrict__ drain,
                   const float* __restrict__ frontier,
                   const float* __restrict__ release,
                   float* __restrict__ score, int A, int C) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= A || j >= C) return;
  const float f = __ldg(frontier + j);
  const float r = __ldg(release + i);
  const float m = (isnan(f) || f > r) ? f : r;      // np.maximum(f, r)
  const long long e = static_cast<long long>(i) * C + j;
  score[e] = __fadd_rn(m, __ldg(drain + e));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The caller has checked shapes, types and contiguity and that A and C
// are both non-zero.
extern "C" int sched_score(const void* drain, const void* frontier,
                           const void* release, void* score, int A, int C,
                           void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((C + kBlockX - 1) / kBlockX, (A + kBlockY - 1) / kBlockY);
  sched_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(drain), static_cast<const float*>(frontier),
      static_cast<const float*>(release), static_cast<float*>(score), A, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sched_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
