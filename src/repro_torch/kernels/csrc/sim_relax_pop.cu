// sim_relax_pop — n_steps Jacobi sweeps of the sparse max-plus relaxation
// that evaluates a whole suite of lowered scenarios:
//
//   end[b, s] = dur[b, s] + max(rel[b, s],
//                               max(max_p((end[b, pred[b, s, p]] + lat[b, s, p])
//                                         + volbw[b, s, p]), 0))
//
// starting from all-zero ends; pred == S points at an always-zero sentinel.
//
// Replaces the TPU kernel src/repro/kernels/sim_step.py:sim_relax_pop
// (Pallas body _pop_step_kernel), which ran one pallas_call per sweep over
// a (B, S/128) grid with the whole end row resident in VMEM.
//
// What bounds it on this card. Read once, the inputs are B*S*(P+1)*12 bytes
// plus 12 bytes per (b, s): a few tens of MB at the paper's suite sizes,
// about 13 us at 3.35 TB/s, and the B*S*(P+1)*3 float32 operations are far
// below that. The recurrence is what costs: every sweep depends on the one
// before, so the kernel is a chain of n_steps dependent passes, each
// re-reading the row's (S, P+1) inputs and gathering P+1 ends per subtask.
//
// What the design does about it.
//  * One block per scenario row b (grid = B): rows are independent, so no
//    grid-wide barrier is needed and all sweeps run inside one launch, with
//    __syncthreads() between sweeps.
//  * The row's end vector is double-buffered in dynamic shared memory,
//    2 x (S+1) floats (about 13 KB at S = 1.7k); slot S is the zero
//    sentinel, so the data-dependent gathers never touch device memory.
//  * Threads stride over subtasks s; each thread reduces its row's P+1
//    columns. The inputs stay in L2 across sweeps.
// Left for later work: one block per row leaves most SMs idle when B is
// small, and a topological (wave-ordered) pass would touch each subtask
// once instead of n_steps times.
//
// Exactness: max and + only, in float32, with the two-add order
// (g + lat) + volbw, a -inf initial max and the 0 floor — the same
// expressions as the NumPy oracle pop_relax_np, so the result is equal bit
// for bit. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void __launch_bounds__(1024)
sim_relax_pop_kernel(const int* __restrict__ pred,
                     const float* __restrict__ lat,
                     const float* __restrict__ volbw,
                     const float* __restrict__ dur,
                     const float* __restrict__ rel,
                     float* __restrict__ out,
                     int S, int P1, int n_steps) {
  extern __shared__ float end_buf[];          // 2 x (S + 1) floats
  float* cur = end_buf;
  float* nxt = end_buf + (S + 1);
  const long long row = static_cast<long long>(blockIdx.x) * S;

  for (int i = threadIdx.x; i <= S; i += blockDim.x) {
    cur[i] = 0.0f;
    nxt[i] = 0.0f;                            // nxt[S] stays the sentinel too
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const long long e = (row + s) * P1;
      float ready = -CUDART_INF_F;
      for (int p = 0; p < P1; ++p) {
        const float g = cur[pred[e + p]];
        ready = fmaxf(ready, (g + lat[e + p]) + volbw[e + p]);
      }
      nxt[s] = dur[row + s] + fmaxf(rel[row + s], fmaxf(ready, 0.0f));
    }
    __syncthreads();                          // every read of cur is done
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int s = threadIdx.x; s < S; s += blockDim.x) out[row + s] = cur[s];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// The caller has checked shapes, types, index bounds and that
// 2 * (S + 1) * 4 bytes fit in a block's shared memory.
extern "C" int sim_relax_pop(const void* pred, const void* lat,
                             const void* volbw, const void* dur,
                             const void* rel, void* out, int B, int S,
                             int P1, int n_steps, int threads,
                             void* stream) {
  const size_t smem = 2 * static_cast<size_t>(S + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_relax_pop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sim_relax_pop_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pred), static_cast<const float*>(lat),
      static_cast<const float*>(volbw), static_cast<const float*>(dur),
      static_cast<const float*>(rel), static_cast<float*>(out), S, P1,
      n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sim_relax_pop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
