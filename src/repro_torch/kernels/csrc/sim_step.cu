// sim_step — one synchronous (Jacobi) sweep of the dense max-plus
// relaxation that evaluates a whole suite of lowered scenarios:
//
//   end'[b, s] = dur[b, s] + max(rel[b, s],
//                                max(max_j((end[b, j] + lat[b, s, j])
//                                          + volbw[b, s, j]), 0))
//
// lat / volbw are dense (B, S, S) float32 lag tensors with -inf where j
// does not gate s (core/lowering.py dense_lags); end / dur / rel are (B, S).
// sim_relax runs n_steps such sweeps from all-zero ends, one launch each,
// with two end buffers in ping-pong.
//
// Replaces the TPU kernel src/repro/kernels/sim_step.py:sim_step and
// :sim_relax (Pallas body _step_kernel), which ran one pallas_call per sweep
// over a (B, Sp/128) grid of VMEM tiles of the lags, S padded to a multiple
// of 128 with -inf.
//
// What bounds it on this card. Each sweep reads the two lag tensors whole,
// B*S*S*8 bytes (53 MB at B=10, S=815; 850 MB at B=160), and does two adds
// and a max per (b, s, j): about 1.5 operations per byte, far below the
// card's float32 rate per byte, so it is bound by bytes. Lags that fit the
// 50 MB L2 stay there across sweeps; larger ones are streamed from device
// memory by every sweep.
//
// What the design does about it.
//  * One warp per row s: its lanes stride over j, so the reads of
//    lat[b, s, :] and volbw[b, s, :] are coalesced, then a shuffle max.
//  * Each block holds ROWS rows of one scenario b and stages end[b, :] in
//    shared memory (S floats, 3.3 KB at S=815), read by every warp.
//  * The grid is flat, B * ceil(S / ROWS) blocks; ragged S is masked here
//    (no 128-padding) and every offset into the lags is 64-bit, since
//    B*S*S passes 2^31 at the paper's jitter suites.
//  * Sweeps never update in place (that would be Gauss-Seidel and give
//    other bits for n_steps below the depth): each reads one buffer and
//    writes the other.
// Left for later work: vectorised (16-byte) loads, keeping a small suite's
// lags resident across sweeps in one persistent launch, and skipping the
// -inf bulk of the lags (a dense row has a few dozen finite entries).
//
// Exactness: + and max only, in float32, with the adds in the order
// (end + lat) + volbw, a -inf initial max and the 0 floor. max is exact
// whatever order the reduction takes, so the result equals the plain
// PyTorch version and the NumPy oracle bit for bit. NaN propagates as in
// torch.amax / torch.maximum (fmaxf would drop it). -inf + -inf stays -inf.
// Build without --use_fast_math and without -ftz.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 8;                      // rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kMaxShared = 232448;            // a block's opt-in on sm_90

// Dynamic shared memory of one block: the staged end[b, :] row.
long long shared_bytes(int S) {
  return static_cast<long long>(S) * sizeof(float);
}

// max that returns NaN when either side is NaN (torch.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
sim_step_kernel(const float* __restrict__ end,
                const float* __restrict__ lat,
                const float* __restrict__ volbw,
                const float* __restrict__ dur,
                const float* __restrict__ rel,
                float* __restrict__ out,
                int S, int blocks_per_row) {
  extern __shared__ float end_row[];          // end[b, :], S floats
  const int b = blockIdx.x / blocks_per_row;
  const int s0 = (blockIdx.x % blocks_per_row) * kRows;
  const long long row = static_cast<long long>(b) * S;

  for (int j = threadIdx.x; j < S; j += kThreads) end_row[j] = end[row + j];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = s0 + warp;
  if (s >= S) return;                         // ragged tail of the last block

  const long long off = (row + s) * static_cast<long long>(S);
  float ready = -CUDART_INF_F;
  for (int j = lane; j < S; j += 32) {
    ready = max_nan(ready, (end_row[j] + lat[off + j]) + volbw[off + j]);
  }
  for (int w = 16; w > 0; w >>= 1) {
    ready = max_nan(ready, __shfl_xor_sync(0xffffffffu, ready, w));
  }
  if (lane == 0) {
    out[row + s] = dur[row + s] + max_nan(rel[row + s], max_nan(ready, 0.0f));
  }
}

int prepare(int S, size_t* smem) {
  if (shared_bytes(S) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *smem = static_cast<size_t>(shared_bytes(S));
  if (*smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

void launch(const float* end, const float* lat, const float* volbw,
            const float* dur, const float* rel, float* out, int B, int S,
            size_t smem, cudaStream_t stream) {
  const int blocks_per_row = (S + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(B) * blocks_per_row;
  sim_step_kernel<<<grid, kThreads, smem, stream>>>(
      end, lat, volbw, dur, rel, out, S, blocks_per_row);
}

}  // namespace

// Whether a block's shared memory holds an end row of S floats: 1 if it
// does, else 0. The guard in Python reports a refusal; the launch refuses
// it too (cudaErrorInvalidValue).
extern "C" int sim_step_fits(int S) { return shared_bytes(S) <= kMaxShared; }
extern "C" int sim_step_max_shared_bytes() { return kMaxShared; }
extern "C" long long sim_step_shared_bytes(int S) { return shared_bytes(S); }

// One sweep on `stream`; returns cudaGetLastError() after the launch
// (0 = ok). The caller has checked shapes, types, contiguity, that B and
// S are non-zero and sim_step_fits(S) (the lags outgrow the card's memory
// long before B * ceil(S / 8) outgrows a grid).
extern "C" int sim_step(const void* end, const void* lat, const void* volbw,
                        const void* dur, const void* rel, void* out, int B,
                        int S, void* stream) {
  size_t smem = 0;
  const int err = prepare(S, &smem);
  if (err != 0) return err;
  launch(static_cast<const float*>(end), static_cast<const float*>(lat),
         static_cast<const float*>(volbw), static_cast<const float*>(dur),
         static_cast<const float*>(rel), static_cast<float*>(out), B, S, smem,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// n_steps sweeps from zeros on `stream`, one launch each. `out` and
// `scratch` are (B, S) buffers that the caller has zeroed; the sweeps
// alternate between them so that the last one writes `out`. Returns the
// first launch error (0 = ok).
extern "C" int sim_relax(const void* lat, const void* volbw, const void* dur,
                         const void* rel, void* out, void* scratch, int B,
                         int S, int n_steps, void* stream) {
  size_t smem = 0;
  const int err = prepare(S, &smem);
  if (err != 0) return err;
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  for (int i = 0; i < n_steps; ++i) {
    // step i writes out when n_steps - i is odd, so the last step does
    float* dst = bufs[(n_steps - i) % 2 == 1 ? 0 : 1];
    const float* src = bufs[(n_steps - i) % 2 == 1 ? 1 : 0];
    launch(src, static_cast<const float*>(lat),
           static_cast<const float*>(volbw), static_cast<const float*>(dur),
           static_cast<const float*>(rel), dst, B, S, smem,
           static_cast<cudaStream_t>(stream));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" const char* sim_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
