// sim_relax_pop — up to n_steps Jacobi sweeps of the sparse max-plus
// relaxation that evaluates a whole population of lowered scenarios:
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
// before, so a row is a chain of dependent sweeps, each gathering P+1 ends
// per subtask. The device GA calls it with n_steps = S (1,090 at its
// 256-core app), while its rows settle after 105-161 sweeps; and at B = 32
// one block per row left 100 of the 132 SMs idle and re-read the row's
// inputs from L2 every sweep.
//
// What the design does about it.
//  * Exact stop at the fixpoint. After each sweep every thread compares its
//    new ends with the old ones by bit pattern (__float_as_uint: == would
//    call NaN unequal to itself and -0 equal to +0). A sweep is a
//    deterministic function of the previous end vector, so once one sweep
//    returns its input bit for bit every later one does too: stopping there
//    gives the n_steps result bit for bit. A row whose sweeps never settle
//    (a cyclic pred) runs all n_steps. `sweeps[b]` (optional) reports the
//    sweeps a row ran.
//  * A thread-block cluster per row (cudaLaunchKernelEx, cluster size k of
//    1-16). The k CTAs split the row's S subtasks into k slices. Each CTA
//    holds a full double-buffered copy of the (S+1)-slot end vector (slot S
//    is the zero sentinel), computes its slice and writes the new values
//    into every peer's buffer through distributed shared memory
//    (cluster_group::map_shared_rank). A cluster barrier with release /
//    acquire semantics ends each sweep: it orders the remote writes before
//    the next sweep's reads, and no CTA writes a buffer a peer still reads
//    (a sweep writes the buffer the previous sweep read, behind the
//    barrier).
//  * The vote. The block ORs its threads' "changed" with __syncthreads_or,
//    and if any changed, writes 1 into the flag slot of this sweep's parity
//    in every peer. After the barrier every CTA reads its own slot, so all
//    of a cluster take the exit at the same sweep (else the cluster barrier
//    would deadlock). A slot is reset by its owner after the next sweep's
//    __syncthreads_or, when all its threads have read it and before any
//    peer can write it again (two sweeps later, behind a barrier).
//  * The slice's edge inputs in shared memory, when the population's staged
//    bytes fit the card's shared memory in one wave: lat, volbw, dur and
//    rel copied once with cp.async, pred narrowed to 16 bits (S < 32,768
//    whenever the ends fit). A sweep then touches only shared memory.
//    Otherwise (the offline 64core-jitter batch, (160, 815, 28), would
//    stage 39 MB against the card's 132 x 228 KB) the kernel reads its
//    slice from L2 as before. The rule (k, variant,
//    shared bytes, threads) is kernels/sim_step.py:pop_plan, by shape.
//  * A final cluster barrier before exit: no CTA leaves while a peer may
//    still touch its shared memory.
//  * An optional overflow flag per row (`overflow[b]`, zeroed by the
//    caller): set when any end the row computed, at any sweep, was +inf or
//    NaN. The dense sim_relax relaxes the compacted form of its lags
//    through this kernel and redoes a flagged row densely (sim_step.cu).
//
// Exactness: max and + only, in float32, with the two-add order
// (g + lat) + volbw (lat + volbw is not pre-summed: it is not the same
// float), a -inf initial max and the 0 floor — the same expressions as the
// plain version, so the result is equal bit for bit. Build without
// --use_fast_math.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxShared = 232448;           // bytes a block may opt into
constexpr int kMaxCluster = 16;              // non-portable above 8
constexpr int kFlagBytes = 16;               // two vote slots, padded

// Shared memory of one CTA, in this order: the vote flags, the two end
// buffers of S + 1 floats, and for the staged variant the slice's lat,
// volbw (slice x P1 floats each), dur, rel (slice floats each) and pred
// (slice x P1 uint16, padded to 4 bytes). kernels/sim_step.py:
// pop_shared_bytes sizes it; the launch takes those bytes from the plan.

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
sim_relax_pop_kernel(const int* __restrict__ pred,
                     const float* __restrict__ lat,
                     const float* __restrict__ volbw,
                     const float* __restrict__ dur,
                     const float* __restrict__ rel,
                     float* __restrict__ out, int* __restrict__ sweeps,
                     int* __restrict__ overflow, int S, int P1, int n_steps,
                     int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x / k) * S;
  const int s0 = min(S, rank * slice), s1 = min(S, s0 + slice);
  const long long e0 = (row + s0) * P1;        // first edge of the slice

  int* flag = reinterpret_cast<int*>(smem);
  float* cur = reinterpret_cast<float*>(smem + kFlagBytes);
  float* nxt = cur + (S + 1);
  const long long edges = static_cast<long long>(slice) * P1;
  float* st_lat = nxt + (S + 1);
  float* st_volbw = st_lat + edges;
  float* st_dur = st_volbw + edges;
  float* st_rel = st_dur + slice;
  uint16_t* st_pred = reinterpret_cast<uint16_t*>(st_rel + slice);

  for (int i = tid; i < 2 * (S + 1); i += blockDim.x) cur[i] = 0.0f;
  if (tid < 2) flag[tid] = 0;
  if constexpr (kStaged) {
    const int n = (s1 - s0) * P1;
    for (int i = tid; i < n; i += blockDim.x) {
      cp_async4(st_lat + i, lat + e0 + i);
      cp_async4(st_volbw + i, volbw + e0 + i);
      st_pred[i] = static_cast<uint16_t>(pred[e0 + i]);
    }
    for (int i = tid; i < s1 - s0; i += blockDim.x) {
      cp_async4(st_dur + i, dur + row + s0 + i);
      cp_async4(st_rel + i, rel + row + s0 + i);
    }
    asm volatile("cp.async.commit_group;\n"
                 "cp.async.wait_all;\n" ::: "memory");
  }
  // every peer is initialised before anyone writes into it
  cluster_barrier();

  int t = 0;
  int bad = 0;                      // an end was +inf or NaN (overflow)
  while (t < n_steps) {
    const int par = t & 1;
    int changed = 0;
    for (int s = s0 + tid; s < s1; s += blockDim.x) {
      const int i = s - s0;
      float ready = -CUDART_INF_F;
      float d, r;
      if constexpr (kStaged) {
        const int e = i * P1;
#pragma unroll 4
        for (int p = 0; p < P1; ++p) {
          const float g = cur[st_pred[e + p]];
          ready = fmaxf(ready, (g + st_lat[e + p]) + st_volbw[e + p]);
        }
        d = st_dur[i];
        r = st_rel[i];
      } else {
        const long long e = e0 + static_cast<long long>(i) * P1;
#pragma unroll 4
        for (int p = 0; p < P1; ++p) {
          const float g = cur[pred[e + p]];
          ready = fmaxf(ready, (g + lat[e + p]) + volbw[e + p]);
        }
        d = dur[row + s];
        r = rel[row + s];
      }
      const float v = d + fmaxf(r, fmaxf(ready, 0.0f));
      changed |= __float_as_uint(v) != __float_as_uint(cur[s]);
      bad |= !(v <= FLT_MAX);
      for (int j = 0; j < k; ++j) *cluster.map_shared_rank(nxt + s, j) = v;
    }
    const int any = __syncthreads_or(changed);
    // every thread here has read the other slot after the last barrier
    if (tid == 0) flag[par ^ 1] = 0;
    if (any && tid < k) *cluster.map_shared_rank(flag + par, tid) = 1;
    cluster_barrier();
    const int go = *static_cast<volatile int*>(flag + par);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    ++t;
    if (!go) break;                 // the same sweep in every CTA
  }

  for (int s = s0 + tid; s < s1; s += blockDim.x) out[row + s] = cur[s];
  if (sweeps != nullptr && rank == 0 && tid == 0) sweeps[blockIdx.x / k] = t;
  if (overflow != nullptr) {        // the same branch in every thread
    if (__syncthreads_or(bad) && tid == 0) overflow[blockIdx.x / k] = 1;
  }
  cluster_barrier();                // no CTA exits while peers may write it
}

template <bool kStaged>
cudaError_t configure(int k, long long smem) {
  auto* kernel = sim_relax_pop_kernel<kStaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && k > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

struct Launch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
};

void make_launch(Launch* l, int B, int k, int threads, long long smem,
                 cudaStream_t stream) {
  l->config = {};
  l->config.gridDim = dim3(static_cast<unsigned>(B) * k);
  l->config.blockDim = dim3(threads);
  l->config.dynamicSmemBytes = static_cast<size_t>(smem);
  l->config.stream = stream;
  l->attr.id = cudaLaunchAttributeClusterDimension;
  l->attr.val.clusterDim.x = k;
  l->attr.val.clusterDim.y = 1;
  l->attr.val.clusterDim.z = 1;
  l->config.attrs = &l->attr;
  l->config.numAttrs = 1;
}

}  // namespace

// How many clusters of k CTAs (threads and smem bytes of shared memory
// each) the current device can hold at once; 0 means such a cluster cannot
// run. A negative value is a CUDA error, negated.
extern "C" int sim_relax_pop_max_active_clusters(int k, int staged,
                                                 int threads, long long smem) {
  if (k < 1 || k > kMaxCluster || threads < 1 || threads > kMaxThreads ||
      smem > kMaxShared)
    return 0;
  cudaError_t err = staged ? configure<true>(k, smem)
                           : configure<false>(k, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Launch l;
  make_launch(&l, 1, k, threads, smem, nullptr);
  int n = 0;
  err = staged ? cudaOccupancyMaxActiveClusters(
                     &n, sim_relax_pop_kernel<true>, &l.config)
               : cudaOccupancyMaxActiveClusters(
                     &n, sim_relax_pop_kernel<false>, &l.config);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

// Launch on `stream`: B clusters of k CTAs of `threads` threads and `smem`
// bytes of shared memory (the plan's); `sweeps` and `overflow` (zeroed by
// the caller) may be null. Returns
// cudaGetLastError() after the launch (0 = ok). The caller has checked
// shapes, types, index bounds, that B and S are non-zero and, with
// sim_relax_pop_max_active_clusters, that such a cluster can run.
extern "C" int sim_relax_pop(const void* pred, const void* lat,
                             const void* volbw, const void* dur,
                             const void* rel, void* out, void* sweeps,
                             void* overflow, int B, int S, int P1,
                             int n_steps, int k, int staged,
                             int threads, long long smem, void* stream) {
  if (k < 1 || k > kMaxCluster || threads < 1 || threads > kMaxThreads ||
      smem > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (S + k - 1) / k;
  cudaError_t err = staged ? configure<true>(k, smem)
                           : configure<false>(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch l;
  make_launch(&l, B, k, threads, smem, static_cast<cudaStream_t>(stream));
  const int* p = static_cast<const int*>(pred);
  const float* la = static_cast<const float*>(lat);
  const float* vb = static_cast<const float*>(volbw);
  const float* du = static_cast<const float*>(dur);
  const float* re = static_cast<const float*>(rel);
  float* o = static_cast<float*>(out);
  int* sw = static_cast<int*>(sweeps);
  int* ov = static_cast<int*>(overflow);
  err = staged ? cudaLaunchKernelEx(&l.config, sim_relax_pop_kernel<true>, p,
                                    la, vb, du, re, o, sw, ov, S, P1, n_steps,
                                    slice)
               : cudaLaunchKernelEx(&l.config, sim_relax_pop_kernel<false>,
                                    p, la, vb, du, re, o, sw, ov, S, P1,
                                    n_steps, slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sim_relax_pop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
