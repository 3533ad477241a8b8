// flash_decode — one new query token against a KV cache, split over the
// cache length (FlashDecoding, arXiv:2311.01282)
//
//   out[b, h] = sum_t p_t v[b, t, h / G] / sum_t p_t over the valid slots,
//   p_t = exp(s_t - max), s_t = cap * tanh((scale * q[b, h]) . k[b, t, h / G] / cap)
//
// q (B, Hq, D), k_cache (B, T, Hkv, D), v_cache (B, T, Hkv, Dv), out (B,
// Hq, Dv), all float32 or all bfloat16 and contiguous; pos (B,) int32;
// G = Hq / Hkv. Slot t is valid iff t < pos[b] + 1 (a linear cache) or
// t < min(pos[b] + 1, T) (a ring buffer: slot order does not matter
// because RoPE was applied at insert). Scores and sums are float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode
// (Pallas body _decode_kernel), which walked the cache's KV blocks as the
// sequential minor axis of its grid, carrying (m, l, acc) in VMEM.
//
// What bounds it on this card: bytes. Every valid K and V slot is read
// once and does 4 * D flops per q head sharing it, far below the 295
// flops per byte where the tensor cores would become the limit. At the
// serving path's gemma2-2b batch (B = 4, T = 544, Hkv = 4, D = 256, bf16)
// that is 8.9 MB per call, about 2.7 us at 3.35 TB/s.
//
// What the design does about it.
//  * Split-K. One (b, kv head) pair has only B * Hkv = 4 at that batch;
//    one block each would leave 128 of the 132 SMs idle. Pass 1 gives
//    each block a slice of 64 slots of one (b, kv head): 9 slices x 16
//    pairs at T = 544. Each block scores its slice for all G q heads of
//    its kv head (the K rows are read once for the group), takes the
//    slice's own max and sum, and writes (max, sum, unnormalised
//    accumulator) per head to a float32 workspace. Pass 2, one block per
//    (b, q head), rescales the slices to their common max and divides.
//    Both passes are launched together; nothing crosses blocks through
//    atomics, so the result does not depend on scheduling.
//  * Only valid slots are read: a slice past pos + 1 writes an empty
//    partial (max = -2e38, sum = 0) without touching the cache.
//  * Scoring: a warp takes one slot at a time; each lane loads the
//    slot's K elements d = lane + 32 i (coalesced) into registers, and
//    the G dot products are reduced by shuffles. Then one warp per head
//    turns the slice's scores into probabilities. The accumulator pass
//    gives each thread one (head, dim) pair, reading V rows coalesced.
//  * Scale, softcap and mask are applied in float32 before the exp, with
//    the reference's -2e38 for masked scores; bfloat16 is converted only
//    with the intrinsics; no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 64;          // cache slots per pass-1 block
constexpr int kMaxD = 256;          // largest head dim (K registers)
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// pass 1: grid (n_splits, B * Hkv); partial_acc (B*Hkv, n_splits, G, Dv),
// partial_ml (B*Hkv, n_splits, G, 2) = (slice max, slice sum)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ pos,
                      float* __restrict__ partial_acc,
                      float* __restrict__ partial_ml, int T_len, int Hq,
                      int Hkv, int D, int Dv, float scale, float softcap,
                      int ring) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                 // G x D, pre-scaled
  float* ss = qs + G * D;           // G x kSlice scores, then probabilities

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh - b * Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int limit = (ring ? min(p, T_len - 1) : p) + 1;  // no overflow
  const int t0 = split * kSlice;
  const int n = max(0, min(kSlice, limit - t0));   // valid slots here

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, dd = i - g * D;
    qs[i] = to_f32(q[((long long)b * Hq + hk * G + g) * D + dd]) * scale;
  }
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    const T* krow = kc + ((long long)(b * T_len + t0 + j) * Hkv + hk) * D;
    float kreg[kMaxD / 32];
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int dd = lane + 32 * i;
      kreg[i] = dd < D ? to_f32(krow[dd]) : 0.0f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qrow = qs + g * D;
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) dot = fmaf(qrow[dd], kreg[i], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) {
        if (softcap > 0.0f) dot = softcap * tanhf(dot / softcap);
        ss[g * kSlice + j] = dot;
      }
    }
  }
  __syncthreads();

  float* ml = partial_ml + ((long long)bh * n_splits + split) * G * 2;
  for (int g = warp; g < G; g += kWarps) {
    float* srow = ss + g * kSlice;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  float* acc = partial_acc + ((long long)bh * n_splits + split) * G * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv, dd = i - g * Dv;
    const float* prow = ss + g * kSlice;
    const T* vcol = vc + ((long long)(b * T_len + t0) * Hkv + hk) * Dv + dd;
    float a = 0.0f;
    for (int j = 0; j < n; ++j)
      a = fmaf(prow[j], to_f32(vcol[(long long)j * Hkv * Dv]), a);
    acc[i] = a;
  }
}

// pass 2: grid (B * Hq); rescale the slices to their common max
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ partial_acc,
                      const float* __restrict__ partial_ml,
                      T* __restrict__ out, int n_splits, int Hq, int Hkv,
                      int Dv) {
  extern __shared__ float weight[];    // n_splits
  __shared__ float denom;
  const int G = Hq / Hkv;
  const int bq = blockIdx.x, b = bq / Hq, h = bq - b * Hq;
  const int bh = b * Hkv + h / G, g = h - (h / G) * G;
  const float* ml = partial_ml + (long long)bh * n_splits * G * 2 + 2 * g;
  if (threadIdx.x == 0) {
    float mx = kNegInf;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[(long long)s * G * 2]);
    float l = 0.0f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(ml[(long long)s * G * 2] - mx);
      weight[s] = w;
      l = fmaf(ml[(long long)s * G * 2 + 1], w, l);
    }
    denom = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* acc = partial_acc + (long long)bh * n_splits * G * Dv
                     + (long long)g * Dv;
  for (int dd = threadIdx.x; dd < Dv; dd += kThreads) {
    float a = 0.0f;
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(acc[(long long)s * G * Dv + dd], weight[s], a);
    out[(long long)bq * Dv + dd] = from_f32<T>(a / denom);
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* out, void* partial_acc, void* partial_ml, int B, int T_len,
           int Hq, int Hkv, int D, int Dv, float scale, float softcap,
           int ring, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_splits = (T_len + kSlice - 1) / kSlice;
  const size_t smem1 = sizeof(float) * (G * D + G * kSlice);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_partial_kernel<T><<<dim3(n_splits, B * Hkv), kThreads, smem1,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<float*>(partial_acc), static_cast<float*>(partial_ml),
      T_len, Hq, Hkv, D, Dv, scale, softcap, ring);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(float) * n_splits;
  err = cudaFuncSetAttribute(decode_combine_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * Hq, kThreads, smem2, stream>>>(
      static_cast<const float*>(partial_acc),
      static_cast<const float*>(partial_ml), static_cast<T*>(out), n_splits,
      Hq, Hkv, Dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_decode_slice() { return kSlice; }

// dtype code: 0 = float32, 1 = bfloat16; softcap <= 0: none; ring != 0:
// ring buffer. partial_acc holds B*Hkv*n_splits*G*Dv floats and
// partial_ml B*Hkv*n_splits*G*2, n_splits = ceil(T / flash_decode_slice()).
// Launch both passes on `stream`; returns the first CUDA error (0 = ok).
// The caller has checked shapes (D <= 256, Hq a multiple of Hkv), types,
// contiguity and the range of pos, and that B, T and the heads are
// non-zero.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            const void* pos, void* out, void* partial_acc,
                            void* partial_ml, int B, int T_len, int Hq,
                            int Hkv, int D, int Dv, float scale,
                            float softcap, int ring, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, kc, vc, pos, out, partial_acc, partial_ml, B,
                         T_len, Hq, Hkv, D, Dv, scale, softcap, ring, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, pos, out, partial_acc,
                                 partial_ml, B, T_len, Hq, Hkv, D, Dv, scale,
                                 softcap, ring, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
