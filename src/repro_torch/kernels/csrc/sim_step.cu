// sim_step — the dense max-plus relaxation that evaluates a whole suite of
// lowered scenarios. One synchronous (Jacobi) sweep is
//
//   end'[b, s] = dur[b, s] + max(rel[b, s],
//                                max(max_j((end[b, j] + lat[b, s, j])
//                                          + volbw[b, s, j]), 0))
//
// lat / volbw are dense (B, S, S) float32 lag tensors with -inf where j
// does not gate s (core/lowering.py dense_lags); end / dur / rel are (B, S).
// sim_step is one sweep; sim_relax is n_steps sweeps from all-zero ends.
//
// Replaces the TPU kernel src/repro/kernels/sim_step.py:sim_step and
// :sim_relax (Pallas body _step_kernel), which ran one pallas_call per sweep
// over a (B, Sp/128) grid of VMEM tiles of the lags, S padded to a multiple
// of 128 with -inf.
//
// What bounds it on this card. A sweep reads the two lag tensors whole,
// B*S*S*8 bytes (53 MB at B=10, S=815; 850 MB at B=160), and does two adds
// and a max per (b, s, j): bound by bytes. Run as n_steps sweeps that each
// stream the lags (the earlier sim_relax), it ran within 1.16x of that
// streaming bound and 155x above the call bound (inputs read once),
// because almost every lag is -inf: a lowered row gates on a few dozen of
// its S subtasks (27 and 30 at most in the paper's 64- and 256-core
// suites against S = 815 and 1,235), and most rows settle before the last
// sweep.
//
// What the design does about it. sim_relax compacts the lags once on the
// card and relaxes the compact form with the sparse kernel, which stops
// each row at its fixpoint:
//  * compact_lags (one pass over lat and volbw, the call bound's bytes):
//    one warp per row, coalesced loads (4 columns of 32 lanes in flight),
//    a ballot per 32 columns gives each kept entry its place in column
//    order. An entry is kept iff both its lags are > -inf. The kept
//    entries (source j, lat, volbw) go to a (B, S, W) scratch (W = 64, or
//    S if smaller), the row's count beside them, and per scenario the
//    largest count and a flag: set by any NaN or +inf in its lat, volbw,
//    dur or rel, or an entry with one lag -inf and the other finite.
//  * The caller reads (largest count, flag) back once per call and takes
//    the compact variant for the scenarios with no flag and no row wider
//    than W. compact_finish writes their padded gather form (B', S, P+1),
//    P+1 the largest count among them: sources, lat, volbw in column
//    order, then pads of the sentinel S with -inf lags.
//  * The compact form is relaxed by sim_relax_pop (sim_relax_pop.cu), which
//    stops each row at its first sweep that changes nothing, with its
//    overflow flag on.
// Exactness of the compact variant. While every end is finite or -inf,
// a skipped entry (both lags -inf, neither NaN nor +inf) adds -inf to the
// dense max and changes nothing, and no kept term is NaN, so fmaxf there
// equals the NaN-propagating max here: every sweep is the dense sweep bit
// for bit, and so is the stop at the fixpoint. The first end that is +inf
// or NaN can only come from an overflow; the kernel flags its row, and the
// caller (after reading the flags back, the call's second and last sync)
// redoes those scenarios from zero in the dense variant. A scenario with
// NaN or +inf inputs (where +inf + -inf = NaN in the dense sweep) never
// takes the compact variant.
//  * The dense variant is the sweep kernel below, n_steps launches with two
//    end buffers in ping-pong (never in place: that would be Gauss-Seidel
//    and give other bits below the depth), over all rows or a list of
//    scenarios. One warp per row s, lanes striding j (coalesced), 16-byte
//    loads where the rows are 16-byte aligned (S a multiple of 4), then a
//    shuffle max; each block holds 8 rows of one scenario and stages
//    end[b, :] in shared memory. Every offset into the lags is 64-bit.
//
// Exactness of the sweep: + and max only, in float32, with the adds in the
// order (end + lat) + volbw, a -inf initial max and the 0 floor. max is
// exact whatever order the reduction takes, so the result equals the plain
// PyTorch version and the NumPy oracle bit for bit. NaN propagates as in
// torch.amax / torch.maximum (fmaxf would drop it). -inf + -inf stays -inf.
// Build without --use_fast_math and without -ftz.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                      // rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kMaxShared = 232448;            // a block's opt-in on sm_90
constexpr int kUnroll = 4;                    // compaction: 32-column groups
                                              // in flight per lane
constexpr int kFinishThreads = 256;

// Dynamic shared memory of one sweep block: the staged end[b, :] row.
long long shared_bytes(int S) {
  return static_cast<long long>(S) * sizeof(float);
}

// max that returns NaN when either side is NaN (torch.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// One sweep over scenarios rows[r] (r = blockIdx.x / blocks_per_row), or
// over scenario r itself when rows is null.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sim_step_kernel(const float* __restrict__ end,
                const float* __restrict__ lat,
                const float* __restrict__ volbw,
                const float* __restrict__ dur,
                const float* __restrict__ rel,
                float* __restrict__ out, const int* __restrict__ rows,
                int S, int blocks_per_row) {
  extern __shared__ __align__(16) float end_row[];   // end[b, :], S floats
  const int r = blockIdx.x / blocks_per_row;
  const int b = rows == nullptr ? r : rows[r];
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
  if constexpr (kVec) {
    const float4* l4 = reinterpret_cast<const float4*>(lat + off);
    const float4* v4 = reinterpret_cast<const float4*>(volbw + off);
    const float4* e4 = reinterpret_cast<const float4*>(end_row);
    for (int j = lane; j < S / 4; j += 32) {
      const float4 l = l4[j], v = v4[j], e = e4[j];
      ready = max_nan(ready, (e.x + l.x) + v.x);
      ready = max_nan(ready, (e.y + l.y) + v.y);
      ready = max_nan(ready, (e.z + l.z) + v.z);
      ready = max_nan(ready, (e.w + l.w) + v.w);
    }
  } else {
    for (int j = lane; j < S; j += 32) {
      ready = max_nan(ready, (end_row[j] + lat[off + j]) + volbw[off + j]);
    }
  }
  for (int w = 16; w > 0; w >>= 1) {
    ready = max_nan(ready, __shfl_xor_sync(0xffffffffu, ready, w));
  }
  if (lane == 0) {
    out[row + s] = dur[row + s] + max_nan(rel[row + s], max_nan(ready, 0.0f));
  }
}

// Compaction: grid B * ceil(S / 8) blocks of 8 warps, one warp per row
// (b, s). Writes the row's kept entries to cpred / clat / cvolbw[(b*S+s)*W
// + i] for i < min(count, W), count to counts[b*S+s], and per scenario
// info[2b] = max count, info[2b+1] = 1 if the scenario cannot take the
// compact variant's exactness argument (info zeroed by the caller).
__global__ void __launch_bounds__(kThreads)
compact_lags_kernel(const float* __restrict__ lat,
                    const float* __restrict__ volbw,
                    const float* __restrict__ dur,
                    const float* __restrict__ rel, int* __restrict__ cpred,
                    float* __restrict__ clat, float* __restrict__ cvolbw,
                    int* __restrict__ counts, int* __restrict__ info, int S,
                    int W, int blocks_per_row) {
  __shared__ int widest[kRows];
  const int b = blockIdx.x / blocks_per_row;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = (blockIdx.x % blocks_per_row) * kRows + warp;
  const unsigned lower = (1u << lane) - 1u;   // lanes below this one
  int count = 0, bad = 0;
  if (s < S) {                                // warp-uniform
    const long long row = static_cast<long long>(b) * S + s;
    const long long off = row * S;
    const long long dst = row * W;
    for (int j0 = 0; j0 < S; j0 += 32 * kUnroll) {
      float l[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 32 * u + lane;
        l[u] = j < S ? lat[off + j] : -CUDART_INF_F;
        v[u] = j < S ? volbw[off + j] : -CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool lo = l[u] == -CUDART_INF_F, vo = v[u] == -CUDART_INF_F;
        bad |= (l[u] != l[u]) | (l[u] == CUDART_INF_F) | (v[u] != v[u]) |
               (v[u] == CUDART_INF_F) | (lo != vo);
        const bool keep = l[u] > -CUDART_INF_F && v[u] > -CUDART_INF_F;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        const int i = count + __popc(mask & lower);
        if (keep && i < W) {
          cpred[dst + i] = j0 + 32 * u + lane;
          clat[dst + i] = l[u];
          cvolbw[dst + i] = v[u];
        }
        count += __popc(mask);
      }
    }
    if (lane == 0) {
      counts[row] = count;
      const float d = dur[row], r = rel[row];
      bad |= (d != d) | (d == CUDART_INF_F) | (r != r) | (r == CUDART_INF_F);
    }
  }
  if (lane == 0) widest[warp] = count;
  const int any_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    int m = widest[0];
    for (int w = 1; w < kRows; ++w) m = max(m, widest[w]);
    atomicMax(info + 2 * b, m);
    if (any_bad) atomicMax(info + 2 * b + 1, 1);
  }
}

// The padded gather form of scenarios rows[0, n_rows) (all of them, in
// order, when rows is null): pred / lat / volbw (n_rows, S, P1), entry p
// of row s from the scratch if p < its count, else the sentinel S with
// -inf lags.
__global__ void __launch_bounds__(kFinishThreads)
compact_finish_kernel(const int* __restrict__ cpred,
                      const float* __restrict__ clat,
                      const float* __restrict__ cvolbw,
                      const int* __restrict__ counts,
                      const int* __restrict__ rows, long long n, int S, int W,
                      int P1, int* __restrict__ pred,
                      float* __restrict__ lat, float* __restrict__ volbw) {
  const long long i = static_cast<long long>(blockIdx.x) * kFinishThreads
                      + threadIdx.x;
  if (i >= n) return;
  const int p = static_cast<int>(i % P1);
  const long long rs = i / P1;
  const int s = static_cast<int>(rs % S);
  const long long r = rs / S;
  const long long src_row = (rows == nullptr ? r : rows[r]) * S + s;
  if (p < counts[src_row]) {
    const long long src = src_row * W + p;
    pred[i] = cpred[src];
    lat[i] = clat[src];
    volbw[i] = cvolbw[src];
  } else {
    pred[i] = S;
    lat[i] = -CUDART_INF_F;
    volbw[i] = -CUDART_INF_F;
  }
}

bool vec_ok(const void* lat, const void* volbw, int S) {
  return S % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(lat) |
          reinterpret_cast<uintptr_t>(volbw)) % 16 == 0;
}

int prepare(int S, size_t* smem) {
  if (shared_bytes(S) > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *smem = static_cast<size_t>(shared_bytes(S));
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sim_step_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          sim_step_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

void launch(const float* end, const float* lat, const float* volbw,
            const float* dur, const float* rel, float* out, const int* rows,
            int n_rows, int S, bool vec, size_t smem, cudaStream_t stream) {
  const int blocks_per_row = (S + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(n_rows) * blocks_per_row;
  if (vec)
    sim_step_kernel<true><<<grid, kThreads, smem, stream>>>(
        end, lat, volbw, dur, rel, out, rows, S, blocks_per_row);
  else
    sim_step_kernel<false><<<grid, kThreads, smem, stream>>>(
        end, lat, volbw, dur, rel, out, rows, S, blocks_per_row);
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
         static_cast<const float*>(rel), static_cast<float*>(out), nullptr,
         B, S, vec_ok(lat, volbw, S), smem,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The dense variant: n_steps sweeps from zeros on `stream`, one launch
// each, over the n_rows scenarios listed in `rows` (int32), or over all
// B when `rows` is null. `out` and `scratch` are (B, S) buffers that the
// caller has zeroed; the sweeps alternate between them so that the last
// one writes `out` (rows not listed are left as they were). Returns the
// first launch error (0 = ok).
extern "C" int sim_relax(const void* lat, const void* volbw, const void* dur,
                         const void* rel, void* out, void* scratch,
                         const void* rows, int n_rows, int S, int n_steps,
                         void* stream) {
  size_t smem = 0;
  const int err = prepare(S, &smem);
  if (err != 0) return err;
  const bool vec = vec_ok(lat, volbw, S);
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  for (int i = 0; i < n_steps; ++i) {
    // step i writes out when n_steps - i is odd, so the last step does
    float* dst = bufs[(n_steps - i) % 2 == 1 ? 0 : 1];
    const float* src = bufs[(n_steps - i) % 2 == 1 ? 1 : 0];
    launch(src, static_cast<const float*>(lat),
           static_cast<const float*>(volbw), static_cast<const float*>(dur),
           static_cast<const float*>(rel), dst,
           static_cast<const int*>(rows), n_rows, S, vec, smem,
           static_cast<cudaStream_t>(stream));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The compaction pass on `stream` (see compact_lags_kernel): cpred, clat,
// cvolbw are (B, S, W) scratch, counts (B, S) int32, info (B, 2) int32
// zeroed by the caller. Returns cudaGetLastError() (0 = ok).
extern "C" int compact_lags(const void* lat, const void* volbw,
                            const void* dur, const void* rel, void* cpred,
                            void* clat, void* cvolbw, void* counts,
                            void* info, int B, int S, int W, void* stream) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_per_row = (S + kRows - 1) / kRows;
  compact_lags_kernel<<<static_cast<unsigned>(B) * blocks_per_row, kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lat), static_cast<const float*>(volbw),
      static_cast<const float*>(dur), static_cast<const float*>(rel),
      static_cast<int*>(cpred), static_cast<float*>(clat),
      static_cast<float*>(cvolbw), static_cast<int*>(counts),
      static_cast<int*>(info), S, W, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

// The padded gather form of the n_rows scenarios listed in `rows` (int32;
// null: all B in order), from compact_lags' scratch: pred / lat / volbw (n_rows, S, P1). Returns
// cudaGetLastError() (0 = ok). Every listed scenario's counts are <= W.
extern "C" int compact_finish(const void* cpred, const void* clat,
                              const void* cvolbw, const void* counts,
                              const void* rows, int n_rows, int S, int W,
                              int P1, void* pred, void* lat, void* volbw,
                              void* stream) {
  if (W < 1 || P1 < 1 || P1 > W) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_rows) * S * P1;
  const long long blocks = (n + kFinishThreads - 1) / kFinishThreads;
  compact_finish_kernel<<<static_cast<unsigned>(blocks), kFinishThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cpred), static_cast<const float*>(clat),
      static_cast<const float*>(cvolbw), static_cast<const int*>(counts),
      static_cast<const int*>(rows), n, S, W, P1, static_cast<int*>(pred),
      static_cast<float*>(lat), static_cast<float*>(volbw));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sim_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
