// flash_attention — forward attention with an online softmax
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i) over the visible keys j, 0 elsewhere,
//   s_ij = cap * tanh((scale * q[b, i, h]) . k[b, j, h / G] / cap)
//
// q (B, S, Hq, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv), out (B, S, Hq,
// Dv), all float32 or all bfloat16 and contiguous; G = Hq / Hkv (GQA).
// Key j is visible from query i iff it lies inside the sequence, j <= i
// when causal, and i - j < window when a window is set (the last
// `window` keys including the query itself). The softcap, when set, is
// applied before the mask, as in the reference. Scores, the running
// max/sum and the accumulator are float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (Pallas body _attn_kernel), whose grid ran the KV blocks
// of one (head, query block) in sequence on one core, with the running
// (m, l, acc) in VMEM, and which needed S to be a multiple of its blocks.
//
// What bounds it on this card: operations. At the serving path's
// gemma2-2b shapes (D = Dv = 256) a query row does 4 * 256 = 1024 flops
// per visible key and reads nothing new, so the bound is the flops over
// the 989 TFLOP/s bf16 tensor-core rate (about 88 us for a 4608-token
// global layer). This kernel uses no tensor cores: its float32 FMAs and
// shared-memory reads keep it far from that bound; it is the simple,
// exact version that later work makes fast.
//
// What the design does about it.
//  * One block of 128 threads per (query tile of 16 rows, q head, batch).
//    The loop over KV tiles of 64 keys inside the block replaces the
//    TPU's sequential grid axis; it runs from the first tile the window
//    can reach to the tile holding the diagonal (causal), so masked work
//    outside the band is skipped.
//  * Eight threads own one query row: each scores 8 of the tile's 64 keys
//    (keys cg, cg + 8, ...), and the row's max and sum are reduced with
//    three shuffles among those eight lanes. The same eight threads own
//    the row's accumulator, split over the head dim (dims cg, cg + 8,
//    ...: 32 floats each at D = 256), so the rescale by exp(m - m_new)
//    never leaves registers.
//  * The query tile (pre-scaled, float32), the K and V tiles (input
//    type) and the tile's probabilities live in shared memory; rows of
//    the float arrays and of K are padded by one 32-bit word so the
//    eight rows a warp reads at once fall in different banks.
//  * Ragged edges (S not a multiple of 16 or 64) are masked: rows and
//    keys past S load as zeros and are never visible or stored.
//  * Masked keys get p = 0 explicitly, so a row whose visible keys all
//    lie in later tiles carries nothing from earlier ones.
//  * No atomics: every output element is written once by one thread,
//    and the result does not depend on scheduling.
//  * bfloat16 is converted only with the intrinsics; no --use_fast_math
//    (expf, tanhf and the final division are the accurate ones).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;            // query rows per block (8 threads each)
constexpr int kBK = 64;            // keys per KV tile (8 per thread)
constexpr int kMaxD = 256;         // largest head dim (accumulator size)
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// row stride of the K tile in elements: one extra 32-bit word per row
template <typename T> __host__ __device__ constexpr int k_stride(int d) {
  return d + static_cast<int>(4 / sizeof(T));
}

template <typename T> size_t shared_bytes(int d, int dv) {
  return sizeof(float) * (kBQ * (d + 1) + kBQ * (kBK + 1))
         + sizeof(T) * (kBK * k_stride<T>(d) + kBK * dv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Hq, int Hkv, int D, int Dv, float scale,
                       int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                                   // kBQ x (D + 1)
  float* ps = qs + kBQ * (D + 1);                     // kBQ x (kBK + 1)
  T* ks = reinterpret_cast<T*>(ps + kBQ * (kBK + 1)); // kBK x k_stride
  T* vs = ks + kBK * k_stride<T>(D);                  // kBK x Dv
  const int kst = k_stride<T>(D);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 3;          // this thread's query row in the tile
  const int cg = tid & 7;          // its key / head-dim lane in the row
  const int qpos = q0 + r;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i - rr * D, s = q0 + rr;
    qs[rr * (D + 1) + dd] =
        s < S ? to_f32(q[((long long)(b * S + s) * Hq + h) * D + dd]) * scale
              : 0.0f;
  }

  // keys [lo, hi) can be visible from some row of this tile
  int lo = 0, hi = S;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(S, q0 + kBQ);
  const int first_tile = (lo / kBK) * kBK;

  float m = kNegInf, l = 0.0f;
  float acc[kMaxD / 8];
#pragma unroll
  for (int i = 0; i < kMaxD / 8; ++i) acc[i] = 0.0f;

  for (int kv0 = first_tile; kv0 < hi; kv0 += kBK) {
    __syncthreads();               // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, dd = i - c * D, t = kv0 + c;
      ks[c * kst + dd] =
          t < S ? k[((long long)(b * S + t) * Hkv + hk) * D + dd]
                : from_f32<T>(0.0f);
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int c = i / Dv, dd = i - c * Dv, t = kv0 + c;
      vs[c * Dv + dd] =
          t < S ? v[((long long)(b * S + t) * Hkv + hk) * Dv + dd]
                : from_f32<T>(0.0f);
    }
    __syncthreads();

    float sc[kBK / 8];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) sc[j] = 0.0f;
    const float* qrow = qs + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        sc[j] = fmaf(qv, to_f32(ks[(cg + 8 * j) * kst + dd]), sc[j]);
    }

    float tile_max = kNegInf;
    bool ok[kBK / 8];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int t = kv0 + cg + 8 * j;
      float s = sc[j];
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      ok[j] = t < S && (!causal || t <= qpos) &&
              (window <= 0 || qpos - t < window);
      sc[j] = ok[j] ? s : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);

    float tile_sum = 0.0f;
    float* prow = ps + r * (kBK + 1);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.0f;
      prow[cg + 8 * j] = p;
      tile_sum += p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 4);
    l = l * corr + tile_sum;
    m = m_new;
    __syncwarp();                  // the row's p, written by its 8 lanes

#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) acc[i] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = prow[c];
      const T* vrow = vs + c * Dv;
#pragma unroll
      for (int i = 0; i < kMaxD / 8; ++i) {
        const int dd = cg + 8 * i;
        if (dd < Dv) acc[i] = fmaf(p, to_f32(vrow[dd]), acc[i]);
      }
    }
  }

  if (qpos < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((long long)(b * S + qpos) * Hq + h) * Dv;
#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) {
      const int dd = cg + 8 * i;
      if (dd < Dv) orow[dd] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int D, int Dv, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, D, Dv,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16. window <= 0: no window;
// softcap <= 0: no softcap. Launch on `stream`; returns the first CUDA
// error of the attribute call or the launch (0 = ok). The caller has
// checked shapes (D, Dv <= 256, Hq a multiple of Hkv), types and
// contiguity, and that B, S and the heads are non-zero.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Hq, int Hkv,
                               int D, int Dv, float scale, int causal,
                               int window, float softcap, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kMaxD || Dv > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, Hq, Hkv, D, Dv, scale, causal,
                         window, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, Dv, scale,
                                 causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
